"""The port's Rao-Blackwellized regressions (`models/raob.py`) against the
JAX package's, in float64: the marginal likelihood of the whole training
set, its gradient (the registry's LogNormal `noise_std.p` included),
`posterior_w` and `predictive` at the same parameters (carried across by
`interop.load_jax_state`), rtol 1e-8; the port's copies of
tests/test_models.py's direct-MVN and exact-GP checks; and both packages'
`train_bnn` refusing the two RaoB names.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu.priors import LogNormal as JaxLogNormal
from bnn_priors_tpu_torch import exp_utils, interop, models
from bnn_priors_tpu_torch.experiments import sweep_tempering, train_bnn
from bnn_priors_tpu_torch.priors import LogNormal

from test_torch_cli import load_jax_cli
from test_torch_models import torch_threads_per_worker  # noqa: F401

RTOL = 1e-8
F64 = torch.float64


def _data(n=40, d=3, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d) * 2, rng.randn(n, 1) * 2


def _pair(kind):
    """(JAX model, params, state, port model): RaoBDenseNet of width 8 with
    the registry's LogNormal noise, or RaoBLinearRegression, on 40 points
    of 3 features"""
    x, y = _data()
    if kind == "dense":
        jm = jax_models.RaoBDenseNet(jnp.asarray(x), jnp.asarray(y), 8,
                                     noise_std=JaxLogNormal((), -1.0, 0.2))
        tm = models.RaoBDenseNet(torch.as_tensor(x), torch.as_tensor(y), 8,
                                 noise_std=LogNormal((), -1.0, 0.2))
    else:
        jm = jax_models.RaoBLinearRegression(jnp.asarray(x), jnp.asarray(y),
                                             noise_std=0.5)
        tm = models.RaoBLinearRegression(torch.as_tensor(x),
                                         torch.as_tensor(y), noise_std=0.5)
    params, state = jax.jit(jm.init)(jax.random.key(3))
    tm = tm.to(F64)
    interop.load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()},
                           {k: np.asarray(v) for k, v in state.items()})
    return jm, params, state, tm, x


@pytest.mark.parametrize("kind", ["dense", "linear"])
def test_raob_matches_jax(kind):
    jm, params, state, tm, x = _pair(kind)
    x_t, y_t = (torch.as_tensor(a) for a in _data())
    x_star = np.random.RandomState(5).randn(7, 3)

    @jax.jit
    def jax_side(p):
        "JAX's likelihood and gradient, posterior and predictive"
        ll, g = jax.value_and_grad(lambda q: jm.log_likelihood(
            q, state, jnp.asarray(x[:5]), jnp.zeros((5, 1)),
            eff_num_data=40)[0])(p)
        return (ll, g, jm.posterior_w(p, state),
                jm.predictive(p, state, jnp.asarray(x_star)))
    jll, jg, (jmean, jL), (jmu, js) = jax_side(params)
    tp = tm.params()
    # a minibatch is passed and ignored: the whole set's likelihood
    ll, f = tm.log_likelihood(tp, x_t[:5], y_t[:5], 40)
    assert f.shape[0] == 40
    np.testing.assert_allclose(float(ll.detach()), float(jll), rtol=RTOL)
    if kind == "dense":
        tg = dict(zip(tp, torch.autograd.grad(ll, list(tp.values()))))
        assert set(tg) == set(jg) and "noise_std.p" in tg
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=RTOL, atol=1e-12, err_msg=k)
    with torch.no_grad():
        mean, L = tm.posterior_w()
        m, s = tm.predictive(None, torch.as_tensor(x_star))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=RTOL)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=RTOL,
                               atol=1e-14)
    assert m.shape == s.shape == (7, 1) and m.dtype == F64
    np.testing.assert_allclose(m.numpy(), np.asarray(jmu), rtol=RTOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL)


def test_raob_model_follows_to():
    "the training set moves with the model's dtype, and is no buffer"
    x, y = _data()
    m = models.RaoBDenseNet(torch.as_tensor(x, dtype=torch.float32),
                            torch.as_tensor(y, dtype=torch.float32), 8)
    assert m.to(F64).x_train.dtype == F64 and m.y_train.dtype == F64
    assert not dict(m.named_buffers())


# -- the port's copies of tests/test_models.py:243-310 -------------------

def test_raob_likelihood_matches_direct_mvn():
    "the Woodbury form equals N(y | 0, ffᵀ + σ²I) built directly"
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(10, 3)) * 2)
    y = torch.as_tensor(rng.normal(size=(10, 1)) * 2)
    model = models.RaoBDenseNet(x, y, 40, noise_std=0.8).to(F64)
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        lik1, _ = model.log_likelihood(model.params(), x, y, 10)
        f = model.net_apply(None, x).numpy() * model.last_layer_std
    cov = f @ f.T + 0.8 ** 2 * np.eye(10)
    lik2 = st.multivariate_normal(mean=np.zeros(10), cov=cov).logpdf(
        y.numpy()[:, 0])
    np.testing.assert_allclose(float(lik1), lik2, rtol=1e-9)


def _linear(x, y, sigma):
    "RaoBLinearRegression with last_layer_std 1: w ~ N(0, I)"
    return models.RaoBLinearRegression(
        torch.as_tensor(x), torch.as_tensor(y)[:, None], noise_std=sigma,
        std_w=x.shape[1] ** 0.5)


def test_raob_posterior_matches_exact_gp():
    "Σ = (XᵀX/σ² + I)⁻¹, μ = Σ Xᵀy/σ²"
    rng = np.random.default_rng(2)
    x = rng.normal(size=(10, 3)) * 2
    y = x @ rng.normal(size=(3,))
    sig2 = 0.5 ** 2
    mu, L = _linear(x, y, 0.5).posterior_w()
    cov = L.T.numpy() @ L.numpy()
    cov_exact = np.linalg.inv(x.T @ x / sig2 + np.eye(3))
    mu_exact = cov_exact @ x.T @ y / sig2
    np.testing.assert_allclose(mu.numpy()[:, 0], mu_exact, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(cov, cov_exact, rtol=1e-8, atol=1e-10)


def test_raob_predictive_matches_exact_gp():
    "predictive mean and variance equal the closed-form GP's"
    rng = np.random.default_rng(7)
    x = rng.normal(size=(12, 4))
    y = x @ rng.normal(size=(4,)) + 0.1 * rng.normal(size=(12,))
    sig2 = 0.3 ** 2
    x_star = rng.normal(size=(5, 4))
    mean, std = _linear(x, y, 0.3).predictive(None, torch.as_tensor(x_star))
    cov_w = np.linalg.inv(x.T @ x / sig2 + np.eye(4))
    mu_w = cov_w @ x.T @ y / sig2
    var_exact = np.einsum("ij,jk,ik->i", x_star, cov_w, x_star) + sig2
    np.testing.assert_allclose(mean.numpy()[:, 0], x_star @ mu_w, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(std.numpy()[:, 0] ** 2, var_exact, rtol=1e-8,
                               atol=1e-10)


# -- the CLIs ---------------------------------------------------------------

TINY = dict(data="random", inference="SGLD", cycles=1, warmup=1, burnin=0,
            n_samples=2, skip_first=0, batch_size=32, width=16,
            progressbar=False, device="cpu")


@pytest.mark.parametrize("name,jax_error", [("raobdensenet", TypeError),
                                            ("raob_linear", IndexError)])
def test_both_clis_raise_on_raob(name, jax_error, tmp_path):
    """the JAX CLI fails inside its first step (whole-set features against
    a minibatch; no parameter at all for raob_linear); the port's
    train_bnn and sweep_tempering refuse both names up front"""
    jcli = load_jax_cli("train_bnn")
    cfg = dict(jcli.DEFAULTS)
    cfg.update(TINY, model=name, log_dir=str(tmp_path / "jax"))
    with pytest.raises(jax_error):
        jcli.main(cfg)
    for cli in (train_bnn, sweep_tempering):
        cfg = dict(cli.DEFAULTS)
        cfg.update(TINY, model=name, log_dir=str(tmp_path / "port"))
        with pytest.raises(ValueError, match="RaoB likelihood"):
            cli.main(cfg)
    assert not (tmp_path / "port").exists()
    # the registry builds it as a library model
    x, y = (torch.as_tensor(a) for a in _data())
    m = exp_utils.get_model(name, x_train=x, y_train=y, width=8,
                            device="cpu", dtype=F64)
    assert isinstance(m, models.RaoBRegressionModel)
