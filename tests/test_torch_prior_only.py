"""The port's prior-only models and `Model.sample_all_priors`: Neal's
funnels against the JAX package's (log prior and gradient, float64), the
port's copy of tests/test_verlet_sgld.py::test_accept_prob (the ΔE
identity on `NealFunnelT`, started from `sample_all_priors`), the draws'
moments and seeding, and the registry's `test_gaussian` against its
closed form (tests/test_models.py:173-186).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from _stat_utils import anderson_normal_p15

from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu_torch import exp_utils, models, priors
from bnn_priors_tpu_torch.mcmc import VerletSGLD

from test_torch_models import torch_threads_per_worker  # noqa: F401

F64 = torch.float64


@pytest.mark.parametrize("name", ["NealFunnel", "NealFunnelT"])
def test_funnels_match_jax(name):
    jm = getattr(jax_models, name)()
    tm = getattr(models, name)().to(F64)
    params, _ = jm.init(jax.random.key(1))
    params = jm.sample_all_priors(jax.random.key(2), params)
    assert set(params) == set(tm.params()) == {"0.p"}
    p = torch.as_tensor(np.array(params["0.p"])).requires_grad_()
    lp = tm.log_prior({"0.p": p})
    g, = torch.autograd.grad(lp, p)
    jlp, jg = jax.value_and_grad(jm.log_prior)(params)
    np.testing.assert_allclose(float(lp.detach()), float(jlp), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["0.p"]), rtol=1e-12)


def test_accept_prob(n_samples=10, seed=145):
    """the kernel's incremental ΔE equals the ΔE computed independently
    from the stored trajectory (tests/test_verlet_sgld.py:101-160)"""
    model = models.NealFunnelT().to(F64)
    temperature, momentum, lr = 3 / 4, 127 / 128, 1 / 32
    kernel = VerletSGLD(num_data=1, momentum=momentum)
    gen = torch.Generator().manual_seed(seed)
    model.sample_all_priors(gen)
    params = {k: v.detach().clone() for k, v in model.params().items()}

    state = kernel.init(params, seed=seed)
    precs = {k: (float(torch.rand((), generator=gen, dtype=F64)) + 0.2)
             / math.sqrt(4) for k in params}
    state.precond = kernel.packer.expand(kernel.packer.pack_leaf_scalars(
        precs))
    state = kernel.sample_momentum(state, temperature)
    pot_fn = model.potential_avg_closure(eff_num_data=1.0)

    def vg(state):
        theta = state.position.detach().requires_grad_()
        pot = pot_fn(kernel.unpack(theta))
        g, = torch.autograd.grad(pot, theta)
        return float(pot.detach()), g

    def snapshot(state, grads):
        return ({k: v.detach().numpy().copy()
                 for k, v in kernel.params_of(state).items()},
                {k: v.detach().numpy().copy()
                 for k, v in kernel.unpack(grads).items()})

    states = []
    U0, grads = vg(state)
    states.append(snapshot(state, grads))
    state, _ = kernel.initial_step(state, grads, lr, temperature)
    for s in range(1, n_samples):
        _, grads = vg(state)
        states.append(snapshot(state, grads))
        state, _ = kernel.step(state, grads, lr, temperature)
        if s == n_samples - 1:
            U1, grads = vg(state)
            state, _ = kernel.final_step(state, grads, lr, temperature)
            states.append(snapshot(state, grads))

    time_step_sq = lr  # num_data=1
    delta_energy_ref = 0.0
    _, grads0 = states[0]
    _, grads1 = states[-1]
    for k in params:
        C = time_step_sq * precs[k] ** 2 / 8
        delta_energy_ref += C * (np.sum(grads1[k] ** 2)
                                 - np.sum(grads0[k] ** 2))
    for i in range(1, len(states)):
        p0, g0 = states[i - 1]
        p1, g1 = states[i]
        for k in params:
            delta_energy_ref += -0.5 * np.sum((p1[k] - p0[k]) * (g1[k] + g0[k]))
    delta_energy_ref += U1 - U0
    delta_energy = float(kernel.delta_energy(state, state.grads, lr, U0, U1))
    assert np.allclose(delta_energy_ref, delta_energy), \
        f"{delta_energy_ref} != {delta_energy}"


def test_sample_all_priors_moments_and_seeding():
    """N(1, 2²) draws: mean, std and normality (Anderson-Darling at 15%);
    every leaf moves; the same seed gives the same bits, another seed
    others; a parent prior is drawn before its sub-prior, at the
    sub-prior's value before the draw"""
    model = models.GaussianModel(N=3, D=4000, mean=1.0, std=2.0).to(F64)
    before = {k: v.detach().clone() for k, v in model.params().items()}
    model.sample_all_priors(torch.Generator().manual_seed(4))
    draws = {k: v.detach().clone() for k, v in model.params().items()}
    for k, v in draws.items():
        assert not torch.equal(v, before[k]), k
        assert abs(float(v.mean()) - 1.0) < 4 * 2.0 / math.sqrt(v.numel())
        assert abs(float(v.std()) - 2.0) < 0.1
    allv = torch.cat(list(draws.values())).numpy()
    assert anderson_normal_p15((allv - 1.0) / 2.0)
    model.sample_all_priors(torch.Generator().manual_seed(4))
    for k, v in model.params().items():
        assert torch.equal(v, draws[k]), k
    model.sample_all_priors(torch.Generator().manual_seed(5))
    assert not torch.equal(model.params()["0.p"], draws["0.p"])

    # Normal(0, exp(s)) over 4000 values with s ~ LogNormal's leaf:
    # s = log 0.01 before the draw, so the parent's draw has std 0.01
    hier = models.PriorOnlyModel([priors.Normal(
        (4000,), 0.0, priors.LogNormal((), 0.0, 1.0))]).to(F64)
    with torch.no_grad():
        hier.params()["0.scale.p"].fill_(math.log(0.01))
    hier.sample_all_priors(torch.Generator().manual_seed(6))
    p = {k: v.detach() for k, v in hier.params().items()}
    assert abs(float(p["0.p"].std()) - 0.01) < 1e-3
    assert float(p["0.scale.p"]) != math.log(0.01)


def test_test_gaussian_from_the_registry():
    "GaussianModel(N=1, D=100): log prior and its gradient, closed form"
    model = exp_utils.get_model("test_gaussian", device="cpu", dtype=F64,
                                seed=3)
    assert isinstance(model, models.GaussianModel)
    params = model.params()
    assert {k: tuple(v.shape) for k, v in params.items()} == {"0.p": (100,)}
    p = params["0.p"].detach().clone().requires_grad_()
    pot = -model.log_prior({"0.p": p})
    g, = torch.autograd.grad(pot, p)
    expected = st.norm(0, 1.0).logpdf(p.detach().numpy()).sum()
    np.testing.assert_allclose(-float(pot.detach()), expected, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), p.detach().numpy(), rtol=1e-12)
    # its likelihood is 0 on any data, one value a batch
    x, y = torch.zeros(5, 20, dtype=F64), torch.zeros(5, 1, dtype=F64)
    ll, f = model.log_likelihood(params, x, y, 5.0)
    assert float(ll) == 0.0 and f.shape == (5, 1)
    jm = jax_models.GaussianModel(N=1, D=100)
    jlp = jm.log_prior({"0.p": jnp.asarray(p.detach().numpy())})
    np.testing.assert_allclose(-float(pot.detach()), float(jlp), rtol=1e-12)
