"""The port's `train_bnn` and `eval_bnn` on their own defaults and on UCI
regression, against the JAX CLIs (`experiments/train_bnn.py`,
`experiments/eval_bnn.py`) on the same files.

MNIST runs read synthetic IDX files (64 training and 16 test images, in
the real format) under a temporary `BNN_PRIORS_DATA`, with the CLI's own
`data=mnist model=classificationconvnet width=50 depth=3
inference=VerletSGLDReject`. `UCI_yacht model=densenet` reads the bundled
split. Both CLIs start from one sample bank (`load_samples`), at
temperature 0, in float32, with one fixed minibatch order (a chain), so
they compute the same run: results, metric series and samples agree to
float32 rounding (rtol 1e-4, as test_torch_cli.py).
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxReject
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxChains
from bnn_priors_tpu_torch.data import write_idx_files
from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.io import HDF5ModelSaver, load_metrics, load_samples
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from bnn_priors_tpu.io import load_samples as jax_load_samples
from test_torch_cli import RTOL, assert_close, load_jax_cli, metric_names
from test_torch_models import torch_threads_per_worker  # noqa: F401

N_MNIST, N_MNIST_TEST, N_YACHT = 64, 16, 277
# one cycle of 3 epochs (1 warmup, 2 sampling) at T=0, batch 32
CFG = dict(inference="VerletSGLDReject", reject_samples=True,
           temperature=0.0, cycles=1, warmup=1, burnin=0, n_samples=2,
           skip=1, skip_first=0, batch_size=32, lr=1e-3, metrics_skip=1,
           progressbar=False, device="cpu")
UCI = dict(CFG, data="UCI_yacht", model="densenet")
K = 2


def _perm(n):
    return np.random.RandomState(7).permutation(n)


def _orders(n, B=32):
    return np.stack([np.random.RandomState(8 + c).permutation(n)
                     for c in range(K)])[:, :n // B * B].reshape(K, -1, B)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """IDX files under a temporary BNN_PRIORS_DATA, and one fixed order
    (one a chain) for both packages' reject runners, by N"""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    write_idx_files(str(root / "MNIST"),
                    rng.randint(0, 256, (N_MNIST, 28, 28)),
                    rng.randint(0, 10, N_MNIST),
                    rng.randint(0, 256, (N_MNIST_TEST, 28, 28)),
                    rng.randint(0, 10, N_MNIST_TEST), gz=True)
    mp = pytest.MonkeyPatch()
    mp.setenv("BNN_PRIORS_DATA", str(root))
    for cls in (JaxReject, VerletSGLDRunnerReject):
        mp.setattr(cls, "_epoch_perm",
                   lambda self, cycle, epoch: _perm(self.N))
    mp.setattr(JaxChains, "_epoch_idxs", lambda self, cycle=0, epoch=0:
               jnp.asarray(_orders(self.N), dtype=jnp.int32))
    mp.setattr(MultiChainRunnerReject, "_epoch_idxs",
               lambda self, cycle=0, epoch=0:
               torch.as_tensor(_orders(self.N)).to(self.device))
    yield root
    mp.undo()


def _bank(path, model):
    "a one-sample bank of the port model's He-initialised f32 parameters"
    from bnn_priors_tpu_torch.exp_utils import he_initialize
    he_initialize(model, torch.Generator().manual_seed(1))
    with HDF5ModelSaver(str(path)) as saver:
        saver.add_state_dict({k: v.detach().float().numpy()
                              for k, v in model.state_dict().items()}, step=0)
    return str(path)


@pytest.fixture(scope="module")
def banks(env, tmp_path_factory):
    "a warm start for each configuration, from the port's registry"
    from bnn_priors_tpu_torch import exp_utils
    out = {}
    d = tmp_path_factory.mktemp("banks")
    for name, cfg in (("mnist", dict(train_bnn.DEFAULTS, **CFG)),
                      ("uci", dict(train_bnn.DEFAULTS, **UCI))):
        data = exp_utils.get_data_from_config(cfg, device="cpu")
        out[name] = _bank(d / f"{name}.pt",
                          train_bnn.model_of(cfg, "cpu",
                                             train=data.norm.train))
    return out


@pytest.fixture(scope="module")
def runs(env, banks, tmp_path_factory):
    "`runs(package, name, **cfg)`: that CLI's run, once a module"
    done = {}

    def run(package, name, **kw):
        key = (package, name) + tuple(sorted(kw.items()))
        if key not in done:
            cli = load_jax_cli("train_bnn") if package == "jax" else train_bnn
            cfg = dict(cli.DEFAULTS)
            cfg.update(CFG if name == "mnist" else UCI, **kw)
            log_dir = tmp_path_factory.mktemp(f"{package}_{name}")
            cfg.update(load_samples=banks[name], log_dir=str(log_dir))
            result = cli.main(cfg)
            dirs = [p for p in log_dir.iterdir() if p.is_dir()]
            done[key] = result, (dirs[0] if len(dirs) == 1 else None)
        return done[key]
    return run


def _assert_dirs_match(jdir, tdir, n_points):
    """the same metric series (ΔE and the total energy to 1e-6 of N times
    the largest potential; est_config_temp to 10% of its largest value, as
    test_torch_cli.py bounds these cancelling sums) and samples"""
    names = metric_names(jdir / "metrics.h5")
    assert names == metric_names(tdir / "metrics.h5")
    jm = load_metrics(jdir / "metrics.h5", names)
    tm = load_metrics(tdir / "metrics.h5", names)
    np.testing.assert_array_equal(tm["steps"], jm["steps"])
    energy = n_points * np.nanmax(np.abs(jm["potential"]))
    for name in names:
        ref = np.asarray(jm[name], dtype=np.float64)
        atol = 1e-5
        if name in ("delta_energy", "total_energy"):
            atol = max(atol, 1e-6 * energy)
        elif name.startswith("est_config_temp/"):
            atol = max(atol, 0.1 * np.nanmax(np.abs(ref)))
        assert_close(tm[name], ref, name, atol=atol)
    js = jax_load_samples(str(jdir / "samples.pt"), keep_steps=True)
    ts = load_samples(str(tdir / "samples.pt"), keep_steps=True)
    assert set(js) == set(ts)
    np.testing.assert_array_equal(ts["steps"], js["steps"])
    for k in js:
        assert_close(ts[k], js[k], k)
    return names


def _assert_results_match(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, err_msg=k)


def test_cli_defaults_match_the_jax_cli(runs):
    """data=mnist model=classificationconvnet width=50 depth=3 (no
    override), GGMC with exact M-H: the same run in both packages"""
    assert (train_bnn.DEFAULTS["data"], train_bnn.DEFAULTS["model"],
            train_bnn.DEFAULTS["width"], train_bnn.DEFAULTS["depth"]) == (
                "mnist", "classificationconvnet", 50, 3)
    (jres, jdir), (tres, tdir) = runs("jax", "mnist"), runs("port", "mnist")
    names = _assert_dirs_match(jdir, tdir, N_MNIST)
    assert {"acceptance/rejected", "delta_energy",
            "preconditioner/net.8.weight_prior.p"} <= set(names)
    bank = load_samples(str(tdir / "samples.pt"))
    assert bank["net.8.weight_prior.p"].shape == (2, 10, 2450)
    _assert_results_match(tres, jres)


def test_uci_densenet_matches_the_jax_cli(runs):
    (jres, jdir), (tres, tdir) = runs("jax", "uci"), runs("port", "uci")
    names = _assert_dirs_match(jdir, tdir, N_YACHT)
    assert "preconditioner/noise_std.p" in names
    assert load_samples(str(tdir / "samples.pt"))["noise_std.p"].shape == (2,)
    _assert_results_match(tres, jres)
    assert tres["acc_ensemble"] > 0  # a squared error


def test_uci_chains_match_the_jax_cli(runs):
    """n_chains=2: per-chain dirs, results and metric series, and the
    pooled result, against the JAX CLI's"""
    jsum, _ = runs("jax", "uci", n_chains=K, n_samples=1)
    tsum, _ = runs("port", "uci", n_chains=K, n_samples=1)
    assert len(tsum["chain_dirs"]) == K and tsum["n_diverged"] == 0
    for jd, td, jres, tres in zip(jsum["chain_dirs"], tsum["chain_dirs"],
                                  jsum["chains"], tsum["chains"]):
        names = metric_names(Path(jd) / "metrics.h5")
        assert names == metric_names(Path(td) / "metrics.h5")
        assert {"exact/potential", "acceptance/rejected"} <= set(names)
        jm = load_metrics(Path(jd) / "metrics.h5", ["potential", "loss"])
        tm = load_metrics(Path(td) / "metrics.h5", ["potential", "loss"])
        for k in jm:
            assert_close(tm[k], jm[k], k)
        _assert_results_match(tres, jres)
    _assert_results_match(tsum["pooled"], jsum["pooled"])


@pytest.mark.parametrize("name,extra", [
    ("mnist", dict(calibration_eval=True)),
    ("mnist", dict(eval_data="rotated_mnist")),
    ("uci", {})])
def test_eval_bnn_matches_the_jax_cli(runs, tmp_path, name, extra):
    """eval_bnn on the port's run dir: the run's own result, and the JAX
    eval_bnn's on the same dir (an MNIST run also on its rotated test
    set)"""
    tres, tdir = runs("port", name)
    out = {}
    for package, cli in (("jax", load_jax_cli("eval_bnn")),
                         ("port", eval_bnn)):
        cfg = dict(cli.DEFAULTS)
        cfg.update(run_dir=str(tdir), skip_first=0, device="cpu",
                   log_dir=str(tmp_path / package), **extra)
        out[package] = cli.main(cfg)
    _assert_results_match(out["port"], out["jax"])
    if "eval_data" not in extra:
        for k in tres:
            np.testing.assert_allclose(out["port"][k], tres[k], rtol=1e-6,
                                       err_msg=k)
    if extra.get("calibration_eval"):
        assert 0.0 <= out["port"]["ece"] <= 1.0


def test_regression_refuses_calibration(runs, tmp_path):
    _, tdir = runs("port", "uci")
    with pytest.raises(ValueError, match="classification"):
        eval_bnn.main(dict(eval_bnn.DEFAULTS, run_dir=str(tdir),
                           skip_first=0, device="cpu",
                           calibration_eval=True, log_dir=str(tmp_path)))


def test_cli_defaults_at_temperature_one(env, tmp_path):
    """the CLI's defaults untouched but for a short schedule: GGMC at T=1
    from the He init on the IDX files, finite results and a finite ΔE at
    the start and at the boundary"""
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(cycles=1, warmup=1, n_samples=1, skip_first=0, device="cpu",
               progressbar=False, log_dir=str(tmp_path))
    result = train_bnn.main(cfg)
    assert set(result) == {"lp_ensemble", "lp_last", "acc_ensemble",
                           "acc_last"}
    assert all(np.isfinite(v) for v in result.values())
    d = next(p for p in tmp_path.iterdir() if p.is_dir())
    run = json.loads((d / "run.json").read_text())
    config = json.loads((d / "config.json").read_text())
    assert run["status"] == "COMPLETED" and config["data"] == "mnist"
    de = load_metrics(d / "metrics.h5", ["delta_energy"])["delta_energy"]
    assert np.isfinite(de[~np.isnan(de)]).sum() == 2
