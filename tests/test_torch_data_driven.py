"""The port's data-driven models against the JAX package's: the fitted-prior
files, the six registry names built from them, and `lengthscale_dict_file`
on `resnet18`.

Each model is built by both registries with the same arguments. The prior
classes and every hyper after loading must be JAX's; the log prior and its
gradient (and for the MNIST CNNs at width 8 on 28x28 images the potential,
which runs the forward pass) agree in f64 at rtol 1e-9 at the port's prior
draws carried to JAX by name. The data-driven ResNet-18s run at width 4.

Two reference behaviours are pinned in both packages: the MVT ResNet-20's
fitted file names PreActResNet18 leaves, so it replaces no prior; and a
`mean_covs_file` sets the 1x1 shortcuts' fitted std as a number, which
neither package's sampler draws from (both inits raise); the port's registry
builds such a model undrawn, for the CLI's initializer, and the comparisons
take its He init.

`vwidth_datadriven_resnet18` with the generalised-normal weight fits also
runs on the chain axis: the port's `MultiChainRunnerReject` at K=2 against
JAX's, step for step in f64 at temperature 0 with one fixed order a chain
(rtol 1e-8), the JAX network with f64 batch statistics; and a JAX
checkpoint (flat) of it with the mean_covs fits and random running
statistics loads into the port's runner by name.
"""
import filecmp
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu import priors as jax_priors
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxRunner
from bnn_priors_tpu.io import checkpoint as jax_ckpt
from bnn_priors_tpu.models import conv_nets as jax_cn
from bnn_priors_tpu.models import data_driven as jax_dd
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxChains
from bnn_priors_tpu_torch import exp_utils, models, priors
from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
from bnn_priors_tpu_torch.interop import load_jax_chains, load_jax_checkpoint
from bnn_priors_tpu_torch.models import data_driven
from bnn_priors_tpu_torch.ops import fused_update
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_cli_priors import cifar_root  # noqa: F401
from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_preact_runners import RUN, _data as _images
from test_torch_preact_runners import _np, _pair as _width4_pair
from test_torch_preact_runners import _port_runner

REPO = Path(__file__).resolve().parent.parent
JAX_FITS = REPO / "bnn_priors_tpu" / "models" / "fits"
FITS = REPO / "bnn_priors_tpu_torch" / "models" / "fits"
FILES = sorted(p.name for p in JAX_FITS.iterdir())
RTOL, ATOL = 1e-9, 1e-12
MEAN_COVS = {"mean_covs_file": str(FITS / "cifar10_mean_covs.pkl.gz")}
WEIGHT_FITS = {"fits_dict_file": str(FITS / "cifar10_weight_fits.pkl.gz"),
               "beta": 2.0}
# (registry name, weight prior, weight_prior_params, width, data)
CASES = {
    "gaussconv": ("datadrivengaussconv", "gaussian", {}, 8, "mnist"),
    "doublegammaconv": ("datadrivendoublegammaconv", "gaussian", {}, 8,
                        "mnist"),
    "resnet18_mean_covs": ("vwidth_datadriven_resnet18", "fixedcov_normal",
                           MEAN_COVS, 4, "cifar"),
    "resnet18_fits": ("vwidth_datadriven_resnet18", "fixedcov_gennorm",
                      WEIGHT_FITS, 4, "cifar"),
    "mvt_resnet20": ("datadriven_mvt_googleresnet", "gaussian", {}, 0,
                     "cifar"),
    "decreasing_mvt": ("decreasing_mvt_googleresnet", "convcorrnormal", {},
                       0, "cifar"),
    "decreasing_mvt_gaussian": ("decreasing_mvt_googleresnet", "gaussian",
                                {}, 0, "cifar"),
}


def _data(kind, n=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 784) if kind == "mnist" else rng.randn(n, 3, 32, 32)
    y = rng.randint(0, 10, n)
    y[0] = 9
    return x, y


def _pair(name, weight_prior, wpp, width, kind, seed=0):
    """(JAX model, port model in f64 with its prior draws, or its He init
    where it has none) from the two registries"""
    x, y = _data(kind)
    jm = jax_exp.get_model(jnp.asarray(x), jnp.asarray(y), name, width, 3,
                           weight_prior, 0.0, 2 ** 0.5, "gaussian", 0.0, 1.0,
                           True, dict(wpp), {})
    tm = exp_utils.get_model(name, weight_prior=weight_prior,
                             weight_prior_params=dict(wpp),
                             x_train=torch.as_tensor(x),
                             y_train=torch.as_tensor(y), width=width,
                             device="cpu", dtype=torch.float64, seed=seed)
    if not tm.drawable():
        exp_utils.he_initialize(tm, torch.Generator().manual_seed(seed))
    return jm, tm


def _assert_priors_are_jax(tm, jm):
    """the same top-level priors by path, of the same class, with every
    hyper equal (numbers and arrays)"""
    ours, theirs = dict(tm.named_priors()), dict(jm.named_priors())
    assert list(ours) == list(theirs)
    for path, p in ours.items():
        jp = theirs[path]
        assert type(p).__name__ == type(jp).__name__, path
        assert set(p.hypers) == set(jp.hypers), path
        for k, v in p.hypers.items():
            np.testing.assert_allclose(np.asarray(v, np.float64),
                                       np.asarray(jp.hypers[k], np.float64),
                                       rtol=1e-15, err_msg=f"{path} {k}")


@pytest.mark.parametrize("name", FILES)
def test_fits_are_the_jax_packages_files(name):
    assert len(FILES) == 6
    assert filecmp.cmp(FITS / name, JAX_FITS / name, shallow=False)


@pytest.mark.parametrize("name", FILES)
def test_fits_load_without_pandas(name, monkeypatch):
    """the `.pkl.gz` files through `read_fit` (gzip and pickle), the MVT
    file through torch.load, with pandas unimportable"""
    monkeypatch.setitem(sys.modules, "pandas", None)
    if name.endswith(".gz"):
        fit = data_driven.read_fit(FITS / name)
    else:
        fit = torch.load(FITS / name, weights_only=False)
    assert isinstance(fit, (dict, tuple)) and len(fit) > 0
    assert data_driven.default_fits_root() == str(FITS)


def test_fits_root_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("BNN_PRIORS_FITS", str(tmp_path))
    assert data_driven.default_fits_root() == str(tmp_path)
    monkeypatch.setenv("BNN_PRIORS_FITS", str(tmp_path / "missing"))
    assert data_driven.default_fits_root() == str(FITS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_priors_and_hypers_are_jax(case):
    jm, tm = _pair(*CASES[case])
    _assert_priors_are_jax(tm, jm)


@pytest.mark.parametrize("name,weight_prior,wpp", [
    ("datadriven_resnet18", "fixedcov_normal", MEAN_COVS),
    ("datadriven_resnet18", "fixedcov_gennorm", WEIGHT_FITS)])
def test_full_width_data_driven_resnet18_priors_are_jax(name, weight_prior,
                                                        wpp):
    """width 64, built (not drawn) by both packages' constructors with the
    registry's arguments: every loaded prior and hyper"""
    kw = dict(prior_w=priors.get_prior(weight_prior), scaling_fn=None,
              weight_prior_params=dict(wpp))
    tm = models.DataDrivenPreActResNet18(**kw)
    jm = jax_dd.DataDrivenPreActResNet18(
        **dict(kw, prior_w=jax_priors.get_prior(weight_prior)))
    _assert_priors_are_jax(tm, jm)
    shortcut = tm.net.layer2[0].shortcut[0].weight_prior
    assert shortcut.shape == (128, 64, 1, 1)
    if "mean_covs_file" in wpp:
        assert isinstance(shortcut.hypers["scale"], float)


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_prior_and_gradient_match_jax(case):
    """at the port's draws: the log prior and its gradient, and for the
    MNIST CNNs the potential and its gradient"""
    name, wp, wpp, width, kind = CASES[case]
    jm, tm = _pair(*CASES[case])
    params = {k: v.detach().numpy().copy() for k, v in tm.params().items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    if kind == "mnist":
        x, y = _data(kind, seed=1)
        jfn = lambda p: jm.potential(p, {}, jnp.asarray(x), jnp.asarray(y),
                                     100.0)[0]
        value = tm.potential(tp, torch.as_tensor(x), torch.as_tensor(y),
                             100.0)
    else:
        jfn = jm.log_prior
        value = tm.log_prior(tp)
    jv, jg = jax.jit(jax.value_and_grad(jfn))(jp)
    # batchnorm's affine leaves have no prior: zero gradient in JAX
    tg = dict(zip(tp, torch.autograd.grad(value, list(tp.values()),
                                          allow_unused=True)))
    np.testing.assert_allclose(float(value.detach()), float(jv), rtol=RTOL)
    assert set(tg) == set(jg)
    for k in jg:
        ours = (np.zeros(params[k].shape) if tg[k] is None
                else tg[k].numpy())
        # entries that cancel to ~0 have no meaningful relative error
        theirs = np.asarray(jg[k])
        np.testing.assert_allclose(
            ours, theirs, rtol=RTOL,
            atol=max(ATOL, 1e-9 * np.abs(theirs).max()), err_msg=k)


def test_mvt_resnet20_replaces_no_prior():
    """`cifar10_opt_mvt.pkl` names PreActResNet18 leaves (22 keys), none a
    ResNet-20 path: both packages' models are the plain-Normal ResNet-20"""
    fit = torch.load(FITS / "cifar10_opt_mvt.pkl", weights_only=False)
    assert len(fit) == 22 and "net.conv1.weight_prior.p" in fit
    jm, tm = _pair(*CASES["mvt_resnet20"])
    for model in (tm, jm):
        kinds = {type(p).__name__ for _, p in model.named_priors()}
        assert kinds == {"Normal"}
    plain = exp_utils.get_model("googleresnet", device="cpu")
    _assert_priors_are_jax(plain, jm)


def test_decreasing_mvt_event_layout_on_one_layer():
    """the first convolution's MultivariateT (df 3.55, permute (1, 0, 2, 3),
    event (O, 9) correlated over the 3x3 kernel): its log density at one
    value against JAX's, before the whole model"""
    jm, tm = _pair(*CASES["decreasing_mvt"])
    p, jp = tm.net[0].weight_prior, dict(jm.named_priors())["net.0.weight_prior"]
    assert type(p).__name__ == "MultivariateT" and p.hypers["df"] == 3.55
    assert p.event_shape == (16, 9) and p.permute == [1, 0, 2, 3]
    v = np.random.RandomState(2).randn(*p.shape)
    ours = p.log_prob({"p": torch.as_tensor(v)}, "")
    theirs = jp.log_prob({"p": jnp.asarray(v)}, "")
    np.testing.assert_allclose(float(ours), float(theirs), rtol=RTOL)
    replaced = {path for path, q in tm.named_priors()
                if type(q).__name__ == "MultivariateT"}
    assert {path.split(".")[1] for path in replaced} == {"0", "3", "4", "5",
                                                         "6"}


def test_mean_covs_shortcut_is_drawn_by_neither_package():
    """a `mean_covs_file` sets each 1x1 shortcut's fitted std as the number
    `scale`: JAX's init (a matmul by it) raises, and so does the port's
    draw; the registry builds the model with zero leaves, the CLI's prior
    init refuses it and its He init fills it. The densities agree
    (test_log_prior_and_gradient_match_jax)."""
    jm, _ = _pair(*CASES["resnet18_mean_covs"])
    path = "net.layer2.0.shortcut.0.weight_prior"
    with pytest.raises(ValueError, match="matmul"):
        dict(jm.named_priors())[path].init(jax.random.key(0), path,
                                           jnp.float64)
    name, wp, wpp, width, _ = CASES["resnet18_mean_covs"]
    tm = exp_utils.get_model(name, weight_prior=wp,
                             weight_prior_params=dict(wpp), width=width,
                             device="cpu", dtype=torch.float64)
    fit = data_driven.read_fit(MEAN_COVS["mean_covs_file"])
    mean, cov = fit["net.module.layer2.0.shortcut.0.weight_prior.p"]
    p = tm.net.layer2[0].shortcut[0].weight_prior
    assert (p.hypers["loc"], p.hypers["scale"]) == (float(mean),
                                                    float(cov) ** 0.5)
    assert not p.drawable and not tm.drawable()
    assert tm.net.conv1.weight_prior.drawable
    assert all(not v.any() for k, v in tm.params().items()
               if k.endswith("_prior.p"))
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        p.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        tm.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        train_bnn._init_model(dict(init_method="prior"), tm, gen)
    train_bnn._init_model(dict(init_method="he"), tm, gen)
    assert p.p.abs().min() > 0 and torch.isfinite(tm.log_prior())


def test_mean_covs_on_an_elementwise_prior_fails_in_both():
    with pytest.raises(AssertionError):
        _pair("vwidth_datadriven_resnet18", "gaussian", MEAN_COVS, 4, "cifar")
    with pytest.raises(AssertionError):
        jax_dd.DataDrivenPreActResNet18(width=4,
                                        weight_prior_params=dict(MEAN_COVS))


def test_lengthscale_dict_file_on_resnet18():
    """`resnet18` with convcorrnormal and the fitted lengthscales: every
    convolution's lengthscale and Cholesky factor from the file, as JAX's;
    the log prior at width 4 against JAX's"""
    wpp = {"lengthscale_dict_file":
           str(FITS / "cifar10_fitted_lengthscales.pkl.gz")}
    fit = data_driven.read_fit(wpp["lengthscale_dict_file"])
    assert len(fit) == 17
    tm = models.PreActResNet18(prior_w=priors.ConvCorrelatedNormal,
                               weight_prior_params=dict(wpp))
    jm = jax_cn.PreActResNet18(prior_w=jax_priors.ConvCorrelatedNormal,
                               weight_prior_params=dict(wpp))
    _assert_priors_are_jax(tm, jm)
    for key, ls in fit.items():
        p = data_driven._prior_at(tm, data_driven._strip_module(key))
        fresh = priors.ConvCorrelatedNormal(p.shape, 0.0, p.hypers["scale"],
                                            lengthscale=float(ls))
        np.testing.assert_array_equal(p.fixed_scale_tril,
                                      fresh.fixed_scale_tril)
    x, y = _data("cifar")
    jm4 = jax_exp.get_model(jnp.asarray(x), jnp.asarray(y), "vwidth_resnet18",
                            4, 3, "convcorrnormal", 0.0, 2 ** 0.5, "gaussian",
                            0.0, 1.0, True, dict(wpp), {})
    tm4 = exp_utils.get_model("vwidth_resnet18", weight_prior="convcorrnormal",
                              weight_prior_params=dict(wpp), width=4,
                              device="cpu", dtype=torch.float64)
    _assert_priors_are_jax(tm4, jm4)
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in tm4.params().items()}
    np.testing.assert_allclose(float(tm4.log_prior().detach()),
                               float(jax.jit(jm4.log_prior)(jp)), rtol=RTOL)


def test_set_hyper_drops_cached_tensors():
    """a number set after a density was evaluated (its tensors cached) gives
    a fresh prior's density"""
    v = torch.randn(4, 3, 3, 3, dtype=torch.float64)
    p = priors.ConvCorrelatedNormal(v.shape, 0.0, 1.0, lengthscale=1.0)
    p.log_prob({"p": v})
    p.set_hyper("lengthscale", np.asarray(2.5))
    assert p.hypers["lengthscale"] == 2.5
    fresh = priors.ConvCorrelatedNormal(v.shape, 0.0, 1.0, lengthscale=2.5)
    torch.testing.assert_close(p.log_prob({"p": v}), fresh.log_prob({"p": v}))
    q = priors.Normal((3,), 0.0, 1.0)
    q.log_prob({"p": v[0, 0, 0]})
    q.set_hyper("loc", np.arange(3.0))
    torch.testing.assert_close(
        q.log_prob({"p": v[0, 0, 0]}),
        priors.Normal((3,), np.arange(3.0), 1.0).log_prob({"p": v[0, 0, 0]}))


# -- the data-driven ResNet-18 on the chain axis, and its JAX checkpoint ----

K = 2
ORDERS = np.stack([np.random.RandomState(8 + c).permutation(32)
                   .reshape(-1, 16) for c in range(K)])
CLOSE = dict(rtol=1e-8, atol=1e-12)


def _dd_pair(fits="mean_covs"):
    "vwidth_datadriven_resnet18 at width 4 with the mean_covs or weight fits"
    if fits == "mean_covs":
        return _width4_pair("vwidth_datadriven_resnet18", "fixedcov_normal",
                            MEAN_COVS)
    return _width4_pair("vwidth_datadriven_resnet18", "fixedcov_gennorm",
                        WEIGHT_FITS)


@pytest.fixture(scope="module")
def jax_chains():
    """the JAX K=2 chain runner from the port's He init (chain 1 scaled),
    once a module"""
    jm, tm = _dd_pair("weight_fits")
    params, state = _np(tm.params()), _np(dict(tm.named_buffers()))
    # the given start as JAX's init, without tracing the init's samplers
    out = ({k: jnp.asarray(v) for k, v in params.items()},
           {k: jnp.asarray(v, jnp.int32 if "num_batches" in k else None)
            for k, v in state.items()})
    jm.init = lambda key, prefix="", dtype=None: tuple(dict(d) for d in out)
    inits = [params, {k: v * (1 + 0.1 * np.sign(v)) for k, v in
                      params.items()}]
    train, test = (tuple(map(jnp.asarray, d)) for d in _images())
    jc = JaxChains(jm, train, n_chains=K, temperatures=0.0,
                   key=jax.random.key(0), dtype=jnp.float64, packing="flat",
                   init_params_fn=lambda i, key: {
                       k: jnp.asarray(v) for k, v in inits[i].items()},
                   test_data=test, cycles=1, **RUN)
    jc._epoch_idxs = lambda cycle=0, epoch=0: jnp.asarray(ORDERS)
    start = (np.asarray(jc.states.position).copy(),
             {k: np.asarray(v).copy() for k, v in jc.model_states.items()})
    return start, jc.run(), jc


def test_chain_runner_matches_jax_step_for_step(jax_chains):
    """K=2: per-chain epoch entries, boundary ΔE and decisions, the final
    bank, running statistics and the sample bank at rtol 1e-8"""
    start, jhist, jc = jax_chains
    _, tm = _dd_pair("weight_fits")
    train, test = (tuple(map(torch.as_tensor, d)) for d in _images())
    tr = MultiChainRunnerReject(tm, train, K, temperatures=0.0,
                                test_data=test, device="cpu", cycles=1,
                                **RUN)
    load_jax_chains(tr, *start)
    tr._epoch_idxs = lambda cycle=0, epoch=0: torch.as_tensor(ORDERS)
    before = fused_update.chain_launches
    thist = tr.run()
    assert fused_update.chain_launches == before
    close = lambda ours, theirs, what: np.testing.assert_allclose(
        ours, np.asarray(theirs), err_msg=what, **CLOSE)
    assert len(thist) == len(jhist) == 2
    for e, (t, j) in enumerate(zip(thist, jhist)):
        assert set(t) == set(j) >= {"potential", "test/acc"}
        for k in j:
            close(t[k], j[k], f"epoch {e} {k}")
    close(tr.delta_energies[0], jc.delta_energies[0], "ΔE")
    np.testing.assert_array_equal(tr.rejections[0], jc.rejections[0])
    close(tr.chains.position.numpy(), jc.states.position, "position")
    for k, v in jc.model_states.items():
        close(tr.buffers[k].numpy(), v, k)
    ts, js = tr.get_samples(), jc.get_samples()
    for k in js:
        close(ts[k], js[k], "sample " + k)


def test_data_driven_resnet18_checkpoint_loads_by_name(tmp_path):
    """a flat JAX state of `vwidth_datadriven_resnet18` (mean_covs fits),
    written by the JAX package's checkpoint writer with random running
    statistics, into the port's runner"""
    jm, tm = _dd_pair()
    params = _np(tm.params())
    rng = np.random.RandomState(4)
    state = {k: (v.numpy().copy() if "num_batches" in k else
                 rng.rand(*v.shape) + 0.5) for k, v in tm.named_buffers()}
    train, test = (tuple(map(jnp.asarray, d)) for d in _images())
    jr = JaxRunner(jm, train, test, init_params={k: jnp.asarray(v) for k, v
                                                 in params.items()},
                   init_model_state={k: jnp.asarray(v)
                                     for k, v in state.items()},
                   key=jax.random.key(0), packing="flat", **RUN)
    path = str(tmp_path / "chain.ckpt.npz")
    jax_ckpt.save_chain_checkpoint(
        path, jr.chain, jr.model_state, jr.key,
        {"next_epoch_index": 1, "step": 2, "initial_potential": 1.0,
         "total_energy": 0.0})
    _, fresh = _dd_pair()
    exp_utils.he_initialize(fresh, torch.Generator().manual_seed(9))
    tr = _port_runner(fresh, reject_samples=False)  # as the JAX runner's
    assert load_jax_checkpoint(path, tr) == (1, 2)
    tsd = tr.current_state_dict()
    assert set(tsd) == set(params) | set(state)
    for k, v in {**params, **state}.items():
        np.testing.assert_array_equal(tsd[k], v, err_msg=k)


def test_cli_fitted_files_reach_the_run_and_eval_bnn(cifar_root, tmp_path,
                                                    monkeypatch):
    """`train_bnn` with a data-driven ResNet-18 and its fitted file: the
    file's path goes into the run's config, the model's priors hold the
    fits, and `eval_bnn` rebuilds the same model from the config and
    reproduces the result"""
    import json
    monkeypatch.setenv("BNN_PRIORS_DATA", cifar_root)
    cfg = dict(train_bnn.DEFAULTS, data="cifar10_small",
               model="vwidth_datadriven_resnet18", width=4,
               weight_prior="fixedcov_gennorm",
               weight_prior_params=dict(WEIGHT_FITS), cycles=1, warmup=1,
               n_samples=1, skip_first=0, batch_size=16, progressbar=False,
               device="cpu", log_dir=str(tmp_path / "train"))
    result = train_bnn.main(cfg)
    run_dir = next(p for p in (tmp_path / "train").iterdir() if p.is_dir())
    config = json.loads((run_dir / "config.json").read_text())
    assert config["weight_prior_params"] == WEIGHT_FITS
    model = train_bnn.model_of(config, "cpu")
    fit = data_driven.read_fit(WEIGHT_FITS["fits_dict_file"])[1]
    beta = fit["net.module.layer1.0.conv1.weight_prior.p"]["gennorm"][0]
    assert model.net.layer1[0].conv1.weight_prior.hypers["beta"] == beta
    out = eval_bnn.main(dict(eval_bnn.DEFAULTS, run_dir=str(run_dir),
                             skip_first=0, device="cpu",
                             log_dir=str(tmp_path / "eval")))
    for k in result:
        np.testing.assert_allclose(out[k], result[k], rtol=1e-6, err_msg=k)
