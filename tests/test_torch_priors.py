"""The port's priors (`bnn_priors_tpu_torch.priors`) against the JAX
package's, one case a registry name (all 31): the leaves' names and shapes,
`log_prob` and its gradient in float64 on the same numpy parameters (one
chain, and three chains with per-chain hypers against `jax.vmap`), the
pins, and the draws (two-sample Kolmogorov–Smirnov tests against the JAX
package's draws). The two names that need a parameter no ResNet-20 passes
get it here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bnn_priors_tpu import priors as JP
from bnn_priors_tpu_torch import priors as TP
from test_torch_models import torch_threads_per_worker  # noqa: F401

NAMES = ("gaussian", "convcorrnormal", "convcorrnormal_fitted_ls",
         "convcorrnormal_empirical", "convcorrnormal_gamma",
         "datadrivencorrnormal", "datadrivencorrdoublegamma",
         "fixedcov_normal", "fixedcov_gennorm", "lognormal", "laplace",
         "cauchy", "student-t", "uniform", "improper", "gaussian_gamma",
         "gaussian_uniform", "horseshoe", "laplace_gamma", "laplace_uniform",
         "student-t_gamma", "student-t_uniform", "gennorm", "gennorm_uniform",
         "gaussian_empirical", "laplace_empirical", "student-t_empirical",
         "gennorm_empirical", "scale_mixture", "mixture",
         "scale_mixture_empirical")
EXTRA = {"datadrivencorrdoublegamma": {"concentration": 0.8},
         "fixedcov_gennorm": {"beta": 0.7}}
MIXTURES = ("scale_mixture", "mixture", "scale_mixture_empirical")
SHAPE = (3, 2, 3, 3)
LOC, SCALE = 0.1, 0.7
RTOL = 1e-9


def _build(name, shape=SHAPE):
    kw = EXTRA.get(name, {})
    return (JP.get_prior(name)(shape, LOC, SCALE, **kw),
            TP.get_prior(name)(shape, LOC, SCALE, **kw).double())


def _params(jprior, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    return {k: 0.5 * rng.standard_normal(lead + s) + 0.2
            for k, s in sorted(jprior.leaf_shapes("w").items())}


def _torch(params):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for k, v in params.items()}


def _grads(out, leaves):
    "d out / d leaf, zeros where out does not depend on the leaf"
    gs = ((None,) * len(leaves) if not out.requires_grad else
          torch.autograd.grad(out, leaves, allow_unused=True))
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, gs)]


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    atol = RTOL * max(float(np.max(np.abs(theirs), initial=0.0)), 1e-300)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=atol)


def test_registry_names():
    assert len(NAMES) == 31 and len(set(NAMES)) == 31
    for name in NAMES:
        assert JP.get_prior(name).__name__ == TP.get_prior(name).__name__
    for get in (JP.get_prior, TP.get_prior):  # the same failure
        with pytest.raises(AssertionError, match="unknown prior"):
            get("nonsense")


@pytest.mark.parametrize("name", NAMES)
def test_prior_matches_jax(name):
    jprior, tprior = _build(name)
    # leaves: the JAX package's names and shapes, as module parameters
    leaves = jprior.leaf_shapes("w")
    assert tprior.leaf_shapes("w") == leaves
    assert {f"w.{k}": tuple(v.shape) for k, v in
            tprior.named_parameters()} == leaves

    # one chain: value and gradient of every leaf
    params = _params(jprior)
    jfn = lambda p: jprior.log_prob(p, "w")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jlp, jg = float(jfn(jp)), jax.grad(jfn)(jp)
    tp = _torch(params)
    tlp = tprior.log_prob(tp, "w")
    assert tlp.shape == () and tlp.dtype == torch.float64
    _close(float(tlp.detach()), jlp)
    for k, g in zip(tp, _grads(tlp, list(tp.values()))):
        _close(g.numpy(), jg[k])

    # three chains, every leaf (hypers too) per chain: against jax.vmap
    params3 = _params(jprior, (3,), seed=1)
    jp3 = {k: jnp.asarray(v) for k, v in params3.items()}
    jlp3 = jax.vmap(jfn)(jp3)
    jg3 = jax.vmap(jax.grad(jfn))(jp3)
    tp3 = _torch(params3)
    tlp3 = tprior.log_prob(tp3, "w")
    assert tlp3.shape == (3,)
    _close(tlp3.detach().numpy(), jlp3)
    for k, g in zip(tp3, _grads(tlp3.sum(), list(tp3.values()))):
        _close(g.numpy(), jg3[k])


@pytest.mark.parametrize("name", NAMES)
def test_prior_draws_and_pins(name):
    # pins: every pinned leaf starts at the JAX package's value
    jprior, tprior = _build(name)
    jinit = jprior.init(jax.random.key(0), "w", jnp.float64)
    tprior.init(torch.Generator().manual_seed(0))
    tinit = {f"w.{k}": v.detach() for k, v in tprior.named_parameters()}
    pinned = [f"{p}.p" for p, pr in tprior.named_priors("w")
              if pr.pinned_init is not None]
    for k in pinned:
        np.testing.assert_allclose(tinit[k].numpy(), np.asarray(jinit[k]),
                                   rtol=1e-12)
    jpins = {f"{p}.p" for p, pr in jprior.named_priors("w")
             if pr.pinned_init is not None}
    assert set(pinned) == jpins
    if "w.mixture_weights" in tinit:
        assert not tinit["w.mixture_weights"].any()

    # draws: one element a kernel of a (n, 1, 3, 3) leaf is n independent
    # draws of the marginal; a mixture draws its whole leaf from one
    # component, so it takes one element a call
    gen = torch.Generator().manual_seed(1)
    if name in MIXTURES:
        n = 300
        jprior, tprior = _build(name, (1, 1, 3, 3))
        keys = jax.random.split(jax.random.key(2), n)
        jd = np.asarray([jprior.init(k, "w", jnp.float64)["w.p"][0, 0, 0, 0]
                         for k in keys])
        td = np.asarray([float(tprior.init(gen).p.detach()[0, 0, 0, 0])
                         for _ in range(n)])
    else:
        n = 4000
        jprior, tprior = _build(name, (n, 1, 3, 3))
        jd = np.asarray(jprior.init(jax.random.key(2), "w",
                                    jnp.float64)["w.p"])[:, 0, 0, 0]
        td = tprior.init(gen).p.detach().numpy()[:, 0, 0, 0]
    assert np.all(np.isfinite(td))
    res = st.ks_2samp(td, jd)
    assert res.pvalue > 1e-4, f"KS p={res.pvalue}"


@pytest.mark.parametrize("which", ["mvt", "mvt_permute", "fixedcov_laplace",
                                   "fixedcov_doublegamma", "assign_cov"])
def test_priors_outside_the_registry(which):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 3))
    L = np.linalg.cholesky(a @ a.T + 3 * np.eye(3))
    shape, kw = (4, 2, 3), {}
    if which == "mvt":
        make = lambda P: P.MultivariateT(shape, 0.1, L, df=5.0, event_dim=2)
    elif which == "mvt_permute":
        make = lambda P: P.MultivariateT(shape, 0.1, L, df=5.0, event_dim=2,
                                         permute=[1, 0, 2])
    else:
        shape = (2, 2, 3, 3)
        cov = np.kron(a @ a.T + 3 * np.eye(3), np.eye(3)) / 9
        if which == "fixedcov_laplace":
            make = lambda P: P.FixedCovLaplace(shape, 0.1, cov)
        elif which == "fixedcov_doublegamma":
            make = lambda P: P.FixedCovDoubleGamma(shape, 0.1, cov, 0.8)
        else:
            def make(P):
                p = P.FixedCovNormal(shape, 0.0, 0.5)
                p.assign_cov(cov)
                return p
    jprior, tprior = make(JP), make(TP).double()
    params = _params(jprior)
    jfn = lambda p: jprior.log_prob(p, "w")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _torch(params)
    tlp = tprior.log_prob(tp, "w")
    _close(float(tlp.detach()), float(jfn(jp)))
    tg, = torch.autograd.grad(tlp, [tp["w.p"]])
    _close(tg.numpy(), jax.grad(jfn)(jp)["w.p"])
    params3 = _params(jprior, (3,), seed=4)
    _close(tprior.log_prob(_torch(params3), "w").detach().numpy(),
           jax.vmap(jfn)({k: jnp.asarray(v) for k, v in params3.items()}))
    tprior.init(torch.Generator().manual_seed(5))
    assert tprior.p.shape == shape and torch.isfinite(tprior.p).all()
