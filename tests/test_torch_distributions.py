"""The port's distributions (`bnn_priors_tpu_torch.distributions`) against
the JAX package's: every log-density on the same float64 inputs at rtol
1e-9 (with tensor and float parameters, and a leading chain axis), and
every sampler by exact Kolmogorov–Smirnov tests against scipy, as
`tests/test_distributions.py` holds the JAX samplers."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bnn_priors_tpu import distributions as JD
from bnn_priors_tpu_torch import distributions as D
from test_torch_models import torch_threads_per_worker  # noqa: F401

RTOL = 1e-9
RNG = np.random.default_rng(0)
X = np.linspace(-4.0, 4.0, 41)
XPOS = np.linspace(0.05, 8.0, 41)

# name: (params, inputs, scipy distribution for the KS test)
SCALAR = {
    "Normal": ((0.3, 1.7), X, st.norm(0.3, 1.7)),
    "Laplace": ((-0.2, 0.8), X, st.laplace(-0.2, 0.8)),
    "Cauchy": ((0.1, 2.0), X, st.cauchy(0.1, 2.0)),
    "StudentT": ((3.0, 0.5, 1.2), X, st.t(3.0, 0.5, 1.2)),
    "GeneralizedNormal": ((0.2, 0.7, 3.0), X, st.gennorm(3.0, 0.2, 0.7)),
    "Uniform": ((-1.0, 2.0), np.linspace(-0.9, 1.9, 41),
                st.uniform(-1.0, 3.0)),
    "Gamma": ((2.5, 1.5), XPOS, st.gamma(2.5, scale=1 / 1.5)),
    "HalfCauchy": ((1.5,), XPOS, st.halfcauchy(scale=1.5)),
    "DoubleGamma": ((0.5, 2.0), np.concatenate([-XPOS, XPOS]),
                    st.dgamma(0.5, scale=0.5)),
    "LogNormal": ((0.1, 0.9), XPOS, st.lognorm(0.9, scale=math.exp(0.1))),
}


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_log_prob_matches_jax(name):
    params, x, _ = SCALAR[name]
    jl = np.asarray(getattr(JD, name)(*params).log_prob(jnp.asarray(x)))
    # float parameters, and tensor parameters with a chain axis: (3, 41)
    tl = getattr(D, name)(*params).log_prob(_t(x))
    assert tl.dtype == torch.float64
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL)
    rows = [tuple(p * (1 + 0.1 * k) for p in params) for k in range(3)]
    cols = [_t([r[i] for r in rows])[:, None] for i in range(len(params))]
    xs = np.stack([x] * 3)
    tl3 = getattr(D, name)(*cols).log_prob(_t(xs))
    jl3 = np.stack([np.asarray(getattr(JD, name)(*r).log_prob(jnp.asarray(x)))
                    for r in rows])
    np.testing.assert_allclose(tl3.numpy(), jl3, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_sample_ks(name):
    params, _, scipy_dist = SCALAR[name]
    gen = torch.Generator().manual_seed(0)
    s = getattr(D, name)(*params).sample((100_000,), gen)
    assert s.dtype == torch.float64 and s.shape == (100_000,)
    assert torch.isfinite(s).all()
    res = st.kstest(s.numpy(), scipy_dist.cdf)
    assert res.pvalue > 1e-4, f"KS p={res.pvalue}"
    again = getattr(D, name)(*params).sample(
        (100_000,), torch.Generator().manual_seed(0))
    assert torch.equal(s, again)  # the generator alone fixes the draw


def test_improper():
    x = _t(X)
    assert torch.equal(D.Improper(0.0, 2.0).log_prob(x), torch.zeros_like(x))
    s = D.Improper(0.5, 2.0).sample((100_000,),
                                     torch.Generator().manual_seed(1))
    assert st.kstest(s.numpy(), st.norm(0.5, 2.0).cdf).pvalue > 1e-4


def _spd(d, seed):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return a @ a.T + d * np.eye(d)


def test_mvn_log_prob_matches_jax_and_scipy():
    cov = _spd(4, 1)
    L = np.linalg.cholesky(cov)
    loc = RNG.normal(size=4)
    xs = RNG.normal(size=(2, 7, 4))
    jl = np.asarray(JD.MultivariateNormal(jnp.asarray(loc), jnp.asarray(L))
                    .log_prob(jnp.asarray(xs)))
    tl = D.MultivariateNormal(_t(loc), _t(L)).log_prob(_t(xs))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), st.multivariate_normal(
        loc, cov).logpdf(xs), rtol=1e-9)
    # one factor a chain: (K, D, D) against (K, n, D)
    Ls = np.stack([np.linalg.cholesky(_spd(4, s)) for s in range(2)])
    tl2 = D.MultivariateNormal(_t(loc), _t(Ls)).log_prob(_t(xs))
    for k in range(2):
        jk = JD.MultivariateNormal(jnp.asarray(loc), jnp.asarray(Ls[k]))
        np.testing.assert_allclose(tl2[k].numpy(),
                                   np.asarray(jk.log_prob(jnp.asarray(xs[k]))),
                                   rtol=RTOL)
    s = D.MultivariateNormal(_t(loc), _t(L)).sample(
        (200_000,), torch.Generator().manual_seed(2)).numpy()
    np.testing.assert_allclose(s.mean(0), loc, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.1)
    for j in range(4):
        sd = math.sqrt(cov[j, j])
        assert st.kstest(s[:, j], st.norm(loc[j], sd).cdf).pvalue > 1e-4


@pytest.mark.parametrize("event_ndim,shape", [(1, (5, 3)), (2, (4, 2, 3))])
def test_mvt_log_prob_matches_jax(event_ndim, shape):
    L = np.linalg.cholesky(_spd(3, 4))
    xs = RNG.normal(size=shape)
    jl = np.asarray(JD.MultivariateT(6.0, 0.1, jnp.asarray(L)).log_prob(
        jnp.asarray(xs), event_ndim=event_ndim))
    tl = D.MultivariateT(6.0, 0.1, _t(L)).log_prob(_t(xs),
                                                   event_ndim=event_ndim)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL)


def test_mvt_sample_moments():
    cov = _spd(3, 2)
    L = np.linalg.cholesky(cov)
    s = D.MultivariateT(7.0, 0.0, _t(L)).sample(
        (400_000,), torch.Generator().manual_seed(3)).numpy()
    # Shah parameterisation: the covariance is cov
    np.testing.assert_allclose(s.mean(0), np.zeros(3), atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), cov, rtol=0.05, atol=0.1)
    # the marginal is a Student-t of df 7 with variance cov_jj
    sd = math.sqrt(cov[0, 0] * 5.0 / 7.0)
    assert st.kstest(s[:, 0], st.t(7.0, 0.0, sd).cdf).pvalue > 1e-4


def test_helpers_match_jax():
    np.testing.assert_array_equal(D.grid_distance_matrix(3, 4),
                                  JD.grid_distance_matrix(3, 4))
    d = D.grid_distance_matrix(3, 3)
    for ls, sc in ((1.0, 2.0), (0.5, 0.7)):
        jL = np.asarray(JD.squared_exponential_scale_tril(jnp.asarray(d), ls,
                                                          sc))
        tL = D.squared_exponential_scale_tril(_t(d), ls, sc)
        np.testing.assert_allclose(tL.numpy(), jL, rtol=RTOL, atol=1e-15)
    # per-chain factors from per-chain hypers
    tLs = D.squared_exponential_scale_tril(_t(d), _t([1.0, 0.5]),
                                           _t([2.0, 0.7]))
    np.testing.assert_allclose(
        tLs[1].numpy(), np.asarray(JD.squared_exponential_scale_tril(
            jnp.asarray(d), 0.5, 0.7)), rtol=RTOL, atol=1e-15)
    y = np.asarray([0.01, 0.5, 1.41, 10.0, 40.0])
    np.testing.assert_allclose(D.inv_softplus(y),
                               np.asarray(JD.inv_softplus(jnp.asarray(y))),
                               rtol=RTOL)
    np.testing.assert_allclose(D.inv_softplus(_t(y)).numpy(),
                               D.inv_softplus(y), rtol=RTOL)
    xs = np.linspace(-50.0, 50.0, 101)
    np.testing.assert_allclose(D.softplus(_t(xs)).numpy(),
                               np.asarray(JD.softplus(jnp.asarray(xs))),
                               rtol=RTOL)
    np.testing.assert_allclose(D.softplus(D.inv_softplus(_t(y))).numpy(), y,
                               rtol=1e-12)
    r = D.rademacher_like(torch.zeros(10_000),
                          torch.Generator().manual_seed(4))
    assert set(r.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(r.mean())) < 0.05


@pytest.mark.parametrize("alpha", [0.3, 1.0, 4.5])
def test_standard_gamma_ks(alpha):
    g = D.standard_gamma(alpha, (100_000,), torch.Generator().manual_seed(5))
    assert st.kstest(g.numpy(), st.gamma(alpha).cdf).pvalue > 1e-4
