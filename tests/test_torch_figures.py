"""The notebooks' computations in the port
(`bnn_priors_tpu_torch.experiments.figures`) against the JAX notebooks'
cells (`experiments/Plot_*.ipynb`) on the same inputs.

- The fits figures (CIFAR-10 ResNet-20, MNIST ConvNet): what the port's
  functions return from the port's copies of the fitted files equals, at
  rtol 0, what the JAX cells compute from the JAX package's files.
- The SGD weights: the port's `SGLDRunner` at temperature 0 against JAX's,
  step for step in f64 from the same parameters in the same minibatch
  order (rtol 1e-8, as tests/test_torch_mnist_runners.py), then the
  weights' normal, Laplace and t fits (rtol 1e-8).
- The temperature diagnostics: the metrics file's series, the sizes and
  the χ² coverage against JAX's `VerletSGLDRunner`, `HDF5Metrics` and
  `plot` at temperature 0 in a fixed order (rtol 1e-8); at temperature 1,
  on a model at equilibrium from its first step, the kinetic temperatures
  are χ²(d)/d distributed (Anderson-Darling on their normal scores,
  tests/_stat_utils.py) and the 95% interval holds about 95% of them.
- The tempering demo grid: its lp matrix against JAX's `evaluate_model` on
  the same banks (rtol 1e-8); the run-dir curve on a sweep written by the
  port's `sweep_tempering` equals JAX's `collect_runs(...).groupby(
  "temperature")["result.lp_ensemble"].mean()` on the same dirs.
"""
import filecmp
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch
import torch.nn.functional as F

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu import notebook_utils as jax_nb
from bnn_priors_tpu import plot as jax_plot
from bnn_priors_tpu.evaluate import evaluate_model as jax_evaluate
from bnn_priors_tpu.inference import SGLDRunner as JaxSGLDRunner
from bnn_priors_tpu.inference import VerletSGLDRunner as JaxVerletRunner
from bnn_priors_tpu.io import HDF5Metrics as JaxHDF5Metrics
from bnn_priors_tpu.models.data_driven import _read_pickle
from bnn_priors_tpu.models.data_driven import \
    default_fits_root as jax_fits_root
from bnn_priors_tpu_torch import exp_utils, models, notebook_utils, plot
from bnn_priors_tpu_torch.experiments import figures, sweep_tempering
from bnn_priors_tpu_torch.inference import SGLDRunner, VerletSGLDRunner
from bnn_priors_tpu_torch.models import default_fits_root

from _stat_utils import anderson_normal_p15
from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_reject_runner import Recorder

F64 = torch.float64
RTOL, ATOL = 1e-8, 1e-12
FITS = ("cifar10_mean_covs.pkl.gz", "cifar10_fitted_lengthscales.pkl.gz",
        "cifar10_weight_fits.pkl.gz", "cifar10_opt_mvt.pkl",
        "mean_covs_mnist_classification.pkl.gz",
        "fits_mnist_classification.pkl.gz")


def _short(k):
    return k.replace("net.module.", "").replace(".weight_prior.p", "")


def _jax_root():
    return Path(jax_fits_root())


# -- the fits figures --------------------------------------------------------
@pytest.mark.parametrize("name", FITS)
def test_the_ports_fits_are_the_jax_packages_files(name):
    "the port's copy of each fitted file is the JAX package's, byte for byte"
    assert filecmp.cmp(Path(default_fits_root()) / name, _jax_root() / name,
                       shallow=False)


def test_cifar10_figures_equal_the_jax_cells():
    """cells 2-6 of Plot_CIFAR10_resnet: the first eight 9×9 covariances,
    the lengthscales, each family's log-likelihood minus the best with the
    GenNorm β, the multivariate-t softplus(df), all at rtol 0"""
    root = _jax_root()
    mean_covs = _read_pickle(root / "cifar10_mean_covs.pkl.gz")
    lengthscales = _read_pickle(root / "cifar10_fitted_lengthscales.pkl.gz")
    weight_fits = _read_pickle(root / "cifar10_weight_fits.pkl.gz")
    ours = figures.cifar10_fits()
    # cell 3
    conv_keys = [k for k, (m, c) in mean_covs.items()
                 if np.asarray(c).shape == (9, 9)][:8]
    covs = figures.covariances(ours[0], (9, 9), 8)
    assert [k for k, _ in covs] == conv_keys and len(conv_keys) == 8
    for (k, cov) in covs:
        np.testing.assert_array_equal(cov, np.asarray(mean_covs[k][1]))
    # cell 4
    keys = list(lengthscales)
    lkeys, lvals = figures.lengthscales(ours[1])
    assert lkeys == keys
    np.testing.assert_array_equal(lvals, [lengthscales[k] for k in keys])
    # cell 5
    ranked = (weight_fits if isinstance(weight_fits, (list, tuple))
              else (weight_fits, None))[0]
    layers = list(ranked)
    fams = ["gennorm", "dgamma", "t", "laplace", "cauchy"]
    ll = {f: [] for f in fams}
    beta = []
    for lay in layers:
        fits = dict((name, (lp, prm)) for name, lp, prm in ranked[lay]
                    if name in fams)
        base = max(lp for lp, _ in fits.values())
        for f in fams:
            ll[f].append(fits[f][0] - base if f in fits else np.nan)
        beta.append(fits["gennorm"][1][0] if "gennorm" in fits else np.nan)
    olayers, oll, obeta = figures.family_fits(ours[2])
    assert olayers == layers and list(oll) == fams
    for f in fams:
        np.testing.assert_array_equal(oll[f], ll[f])
    np.testing.assert_array_equal(obeta, beta)
    # cell 6
    mvt = torch.load(root / "cifar10_opt_mvt.pkl", weights_only=False)
    names = [_short(k) for k in mvt]
    dfs = [float(F.softplus(prm["df"])) for _lik, prm in mvt.values()]
    onames, odfs = figures.mvt_dfs()
    assert onames == names
    np.testing.assert_array_equal(odfs, dfs)


def test_mnist_figures_equal_the_jax_cells():
    """cells 2-4 of Plot_MNIST_convnet_covariances: the 2-D covariances,
    the scalar variances, each layer's best family and its log-likelihood,
    at rtol 0"""
    root = _jax_root()
    mean_covs = _read_pickle(root / "mean_covs_mnist_classification.pkl.gz")
    fits = _read_pickle(root / "fits_mnist_classification.pkl.gz")
    ours_covs, ours_fits = figures.mnist_fits()
    keys = [k for k, (m, c) in mean_covs.items() if np.asarray(c).ndim == 2]
    covs = figures.covariances(ours_covs)
    assert [k for k, _ in covs] == keys and keys
    for k, cov in covs:
        np.testing.assert_array_equal(cov, np.asarray(mean_covs[k][1]))
    scalars = {_short(k): float(np.asarray(c))
               for k, (m, c) in mean_covs.items() if np.asarray(c).ndim == 0}
    ours = figures.scalar_variances(ours_covs)
    assert list(ours) == list(scalars)
    np.testing.assert_array_equal(list(ours.values()), list(scalars.values()))
    ranked = fits[0] if isinstance(fits, (list, tuple)) else fits
    rows = [(_short(lay), fitlist[0][0], fitlist[0][1])
            for lay, fitlist in ranked.items()]
    assert figures.best_families(ours_fits) == rows


# -- the SGD weights ---------------------------------------------------------
N_SGD, B_SGD = 100, 32  # 3 full batches and a tail of 4
PERM = np.random.RandomState(7).permutation(N_SGD)


def _sgd_case():
    "(x, y) of fake_mnist as numpy, the port's model in f64, its params"
    data = exp_utils.get_data("fake_mnist", n_train=N_SGD, n_test=4,
                              device="cpu")
    x = data.norm.train_X.double().numpy()
    y = data.norm.train_y.numpy()
    model = figures.sgd_model(torch.as_tensor(x), torch.as_tensor(y),
                              width=4, depth=3, seed=2, device="cpu",
                              dtype=F64)
    params = {k: v.detach().numpy().copy() for k, v in model.params().items()}
    return x, y, model, params


def test_sgd_weights_match_jax_step_for_step(monkeypatch):
    """Plot_weight_histograms cells 3-4: `sgd_weights` at temperature 0
    against JAX's SGLDRunner from the same parameters in the same order:
    every logged number and the final weights at rtol 1e-8, then each of
    the first six weight leaves' normal, Laplace and t fits at rtol 1e-8"""
    x, y, model, params = _sgd_case()
    jm = jax_exp.get_model(jnp.asarray(x), jnp.asarray(y),
                           "classificationconvnet", 4, 3, "improper", 0.0,
                           1.41, "improper", 0.0, 1.0, True, {}, {})
    jrec, trec = Recorder(), Recorder()
    jr = JaxSGLDRunner(jm, (jnp.asarray(x), jnp.asarray(y)), None,
                       epochs_per_cycle=2, warmup_epochs=0, sample_epochs=1,
                       cycles=1, learning_rate=5e-3, momentum=0.9,
                       temperature=0.0, batch_size=B_SGD,
                       init_params={k: jnp.asarray(v)
                                    for k, v in params.items()},
                       init_model_state={}, key=jax.random.key(0),
                       packing="flat", metrics_saver=jrec)
    jr._epoch_perm = lambda cycle, epoch: PERM
    jr.run(progressbar=False)
    monkeypatch.setattr(SGLDRunner, "_epoch_perm",
                        lambda self, cycle, epoch: PERM)
    runner, ours = figures.sgd_weights(
        model, (torch.as_tensor(x), torch.as_tensor(y)), epochs=2,
        learning_rate=5e-3, momentum=0.9, batch_size=B_SGD, seed=0,
        device="cpu", metrics_saver=trec)
    keys = {k for k in jrec.rows if not k[0].startswith("timings/")}
    assert keys == {k for k in trec.rows if not k[0].startswith("timings/")}
    assert ("est_temperature/net.1.weight_prior.p", 0) in keys
    bad = {k: (trec.rows[k], jrec.rows[k]) for k in sorted(keys)
           if not np.isclose(trec.rows[k], jrec.rows[k], rtol=RTOL,
                             atol=ATOL)}
    assert not bad, list(bad.items())[:10]
    theirs = {k: np.asarray(v)
              for k, v in jr.kernel.params_of(jr.chain).items()}
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.array_equal(ours[k], params[k]), k
    weight_keys = [k for k in theirs if "weight_prior.p" in k][:6]
    assert figures.weight_leaves(ours) == weight_keys
    assert len(weight_keys) == 3
    for key in weight_keys:
        w = theirs[key].ravel().astype(np.float64)
        w = w / w.std()
        fit = figures.fit_weights(ours[key])
        np.testing.assert_allclose(fit["w"], w, rtol=RTOL, atol=ATOL)
        for name, dist in (("normal", scipy.stats.norm),
                           ("laplace", scipy.stats.laplace),
                           ("t", scipy.stats.t)):
            np.testing.assert_allclose(fit[name], dist.fit(w), rtol=RTOL,
                                       err_msg=f"{key} {name}")
        grid, pdf = figures.densities(fit)
        np.testing.assert_allclose(
            pdf["t"], scipy.stats.t.pdf(np.linspace(w.min(), w.max(), 400),
                                        *scipy.stats.t.fit(w)),
            rtol=RTOL)
        assert grid.shape == (400,)


# -- the temperature diagnostics ---------------------------------------------
DIAG = dict(epochs_per_cycle=4, warmup_epochs=2, sample_epochs=2, cycles=2,
            learning_rate=1e-4, momentum=0.98, batch_size=64)
N_DIAG = 256
PERM_DIAG = np.random.RandomState(9).permutation(N_DIAG)


def _diag_data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N_DIAG, 3)
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.randn(N_DIAG, 1)
    return x, y


def _nested_close(ours, theirs, path=""):
    assert sorted(ours) == sorted(theirs), path
    for k in theirs:
        if k.startswith("timings"):
            continue
        if isinstance(theirs[k], dict):
            _nested_close(ours[k], theirs[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{path}/{k}")


def test_temperature_diagnostics_match_jax_at_temperature_0(tmp_path,
                                                            monkeypatch):
    """Plot_temperature_diagnostics cells 3-5 at temperature 0 in a fixed
    order: the metrics file's every series (the per-leaf kinetic and
    configurational temperatures among them), the sizes, and the χ²
    coverage, against JAX's VerletSGLDRunner, HDF5Metrics, load_metrics,
    get_sizes and chi2_coverage; and each package's chi2_coverage of these
    series against a target temperature of 1"""
    x, y = _diag_data()
    model = models.DenseNet(3, 1, width=16, depth=2).to(F64)
    model.init(torch.Generator().manual_seed(4))
    params = {k: v.detach().numpy().copy() for k, v in model.params().items()}
    jm = jax_models.DenseNet(3, 1, width=16, depth=2)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    with JaxHDF5Metrics(tmp_path / "jax" / "metrics.h5") as ms:
        jr = JaxVerletRunner(jm, (jnp.asarray(x), jnp.asarray(y)), None,
                             temperature=0.0, metrics_saver=ms,
                             init_params={k: jnp.asarray(v)
                                          for k, v in params.items()},
                             init_model_state={}, key=jax.random.key(1),
                             packing="flat", **DIAG)
        jr._epoch_perm = lambda cycle, epoch: PERM_DIAG
        jr.run(progressbar=False)
    jparams = {k: np.asarray(v)
               for k, v in jr.kernel.params_of(jr.chain).items()}
    jmetrics = jax_plot.load_metrics(tmp_path / "jax" / "metrics.h5")
    jsizes = jax_plot.get_sizes(jparams)
    monkeypatch.setattr(VerletSGLDRunner, "_epoch_perm",
                        lambda self, cycle, epoch: PERM_DIAG)
    diag = figures.temperature_diagnostics(
        model, (torch.as_tensor(x), torch.as_tensor(y)), tmp_path / "port",
        temperature=0.0, seed=1, device="cpu", **DIAG)
    _nested_close(diag["metrics"], jmetrics)
    assert diag["sizes"] == jsizes
    keys = [k for k in jmetrics["est_temperature"] if k != "all"]
    assert diag["keys"] == keys and len(keys) == 4
    est = np.stack([jmetrics["est_temperature"][k] for k in keys], axis=-1)
    assert np.all(est[1:] > 0)
    confidences = (0.05, 0.25, 0.50, 0.75, 0.95)
    dfs = [jsizes[k] for k in keys]
    with np.errstate(divide="ignore", invalid="ignore"):
        theirs = jax_plot.chi2_coverage(est, jmetrics["temperature"], dfs,
                                        confidences)
    np.testing.assert_array_equal(diag["coverage"], theirs)
    ours_est = np.stack([diag["metrics"]["est_temperature"][k] for k in keys],
                        axis=-1)
    ones = np.ones(len(est))
    np.testing.assert_allclose(
        plot.chi2_coverage(ours_est, ones, dfs, confidences),
        jax_plot.chi2_coverage(est, ones, dfs, confidences), rtol=0)
    rows = diag["metrics"]["steps"]
    epoch = (rows + 1) // diag["runner"].steps_per_epoch % 4
    np.testing.assert_array_equal(diag["sampling"], epoch >= 2)


def test_kinetic_temperatures_are_chi2_at_temperature_1(tmp_path):
    """the stochastic case: `temperature_diagnostics` at temperature 1 on a
    model whose posterior is its prior (16 Gaussian leaves of 8, no
    likelihood), started from a prior draw, so the chain is at equilibrium
    from its first step. Over the sampling epochs each leaf's
    d·est_temperature is χ²(d): their normal scores (every 8th row) pass
    Anderson-Darling at 15%, and the 95% and 50% intervals hold about 95%
    and 50% of the leaves.

    The port draws other random numbers than JAX; calibration (CPU f64,
    seeds 0-19, model draw 100 + seed): anderson_normal_p15 17/20, the 95%
    coverage 0.901-0.985 and the 50% coverage 0.420-0.569 in 20/20."""
    seed = 1
    x = torch.zeros(256, 1, dtype=F64)
    model = models.GaussianModel(N=16, D=8).to(F64)
    model.init(torch.Generator().manual_seed(100 + seed))
    diag = figures.temperature_diagnostics(
        model, (x, x), tmp_path, temperature=1.0, seed=seed, device="cpu",
        **dict(DIAG, learning_rate=1e-2, batch_size=16))
    m, keys, sizes = diag["metrics"], diag["keys"], diag["sizes"]
    assert len(keys) == 16 and set(sizes.values()) == {8}
    rows = np.flatnonzero(diag["sampling"])[::8]
    scores = np.concatenate([scipy.stats.norm.ppf(scipy.stats.chi2.cdf(
        m["est_temperature"][k][rows] * sizes[k], sizes[k])) for k in keys])
    assert len(scores) == 128 and anderson_normal_p15(scores)
    cover = diag["coverage"][:, diag["sampling"]].mean(axis=1)
    assert 0.85 <= cover[-1] <= 1.0 and 0.35 <= cover[2] <= 0.65, cover


# -- the tempering curves ----------------------------------------------------
def test_tempering_grid_matches_jax_evaluate_model():
    """Plot_tempering_curves cells 2-3: the (temperatures, replicates)
    lp_ensemble matrix of `tempering_grid` on the CPU in f64 against JAX's
    evaluate_model on each chain's bank, carried across (rtol 1e-8)"""
    temps, reps = [0.1, 1.0], 2
    data = exp_utils.get_data("random", n_points=128, seed=0,
                              dtype="float64", device="cpu")
    x, y = data.norm.train_X, data.norm.train_y
    model = exp_utils.get_model(
        "densenet", weight_prior="gaussian", weight_scale=1.41,
        batchnorm=False, x_train=x, y_train=y, width=4, depth=2,
        device="cpu", dtype=F64, seed=0)
    lp, runner = figures.tempering_grid(
        model, (x, y), data.norm.test, temps, reps, cycles=2,
        epochs_per_cycle=2, seed=0, device="cpu")
    assert lp.shape == (2, 2) and np.all(np.isfinite(lp))
    jm = jax_exp.get_model(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                           "densenet", 4, 2, "gaussian", 0.0, 1.41,
                           "gaussian", 0.0, 1.0, False, {}, {})
    test = tuple(jnp.asarray(t.numpy()) for t in data.norm.test)
    theirs = [jax_evaluate(jm, test, runner.chain_samples(c))["lp_ensemble"]
              for c in range(len(temps) * reps)]
    np.testing.assert_allclose(lp, np.asarray(theirs).reshape(2, 2),
                               rtol=RTOL)
    np.testing.assert_array_equal(runner.temperatures.cpu().numpy(),
                                  np.repeat(temps, reps))


@pytest.fixture(scope="module")
def sweep_dirs(tmp_path_factory):
    """a 2 × 2 sweep of the port's sweep_tempering on `random`; (log dir,
    the sweep's results)"""
    log_dir = tmp_path_factory.mktemp("sweep")
    cfg = dict(sweep_tempering.DEFAULTS, data="random", model="densenet",
               width=4, temperatures=[0.01, 1.0], replicates=2, cycles=1,
               warmup=1, burnin=0, n_samples=2, skip=1, skip_first=0,
               batch_size=100, inference="VerletSGLDReject", device="cpu",
               progressbar=False, log_dir=str(log_dir))
    return log_dir, sweep_tempering.main(cfg)


def test_tempering_curve_equals_collect_runs_groupby(sweep_dirs):
    """Plot_tempering_curves cell 6: `notebook_utils.run_records` has JAX's
    `collect_runs`' rows and columns, and `tempering_curve` is its groupby("weight_prior")
    then groupby("temperature")["result.lp_ensemble"].mean(), exactly;
    `grid_matrix` is the sweep's own results, chain c = r·2 + t"""
    log_dir, results = sweep_dirs
    df = jax_nb.collect_runs(log_dir)
    records = notebook_utils.run_records(log_dir)
    assert len(records) == len(df) == 4
    assert [list(r) for r in records] == [list(df.columns)] * 4
    for r, row in zip(records, df.to_dict(orient="records")):
        assert r == row
    curve = figures.tempering_curve(records)
    assert list(curve) == sorted(df["weight_prior"].unique())
    for prior, g in df.groupby("weight_prior"):
        gm = g.groupby("temperature")["result.lp_ensemble"].mean()
        np.testing.assert_array_equal(curve[prior][0], gm.index.values)
        np.testing.assert_array_equal(curve[prior][1], gm.values)
    temps, reps, lp = figures.grid_matrix(records)
    np.testing.assert_array_equal(temps, [0.01, 1.0])
    np.testing.assert_array_equal(reps, [0, 1])
    for c, res in enumerate(results):
        r, t = divmod(c, 2)
        assert lp[t, r] == res["lp_ensemble"]


def test_flatten_is_json_normalize(sweep_dirs):
    """`notebook_utils.flatten` without pandas: pandas.json_normalize's
    record, key for key in its order, on the sweep's config and run files
    and on nested, empty and list values"""
    log_dir, _ = sweep_dirs
    cases = [{"a": {}, "b": 1}, {"a": {"x": {}, "y": [1, {"z": 2}]},
                                 "c": None},
             {"a": {"b": {"c": 1}}, "d": True, "e": 2.5, "f": "s"}, {}]
    for d in sorted(p for p in log_dir.iterdir() if p.is_dir()):
        for name in ("config.json", "run.json"):
            cases.append(json.loads((d / name).read_text()))
    for nested in cases:
        want = (pd.json_normalize(nested, sep=".").to_dict(
            orient="records")[0] if nested else {})
        got = notebook_utils.flatten(nested)
        assert list(got.items()) == list(want.items())
        assert got == jax_nb.flatten(nested)


def test_the_functions_default_to_the_card(tmp_path):
    """no quiet fallback: without a card each function that runs a model
    raises at its default device, before it runs"""
    assert not torch.cuda.is_available()
    x = torch.zeros(8, 784, dtype=F64)
    y = torch.arange(8) % 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        figures.sgd_model(x, y, width=2)
    model = figures.sgd_model(x, y, width=2, device="cpu", dtype=F64)
    dense = models.DenseNet(3, 1, width=2, depth=2).to(F64)
    xs, ys = torch.zeros(8, 3, dtype=F64), torch.zeros(8, 1, dtype=F64)
    for call in (lambda: figures.sgd_weights(model, (x, y)),
                 lambda: figures.temperature_diagnostics(dense, (xs, ys),
                                                         tmp_path),
                 lambda: figures.tempering_grid(dense, (xs, ys), (xs, ys),
                                                [1.0], 1, batch_size=4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
