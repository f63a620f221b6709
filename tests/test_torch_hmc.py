"""The port's HMC kernel (`bnn_priors_tpu_torch/mcmc/hmc.py`) against the
JAX package's, plus the tests of tests/test_hmc.py run on the port: exact
leapfrog reversibility and distribution preservation with M-H. Classical
HMC (`inference=HMC`: the reject runner at the batch size N) runs against
the JAX runner here; the other two HMC runners in test_torch_hmc_runner.py.

HMC draws no noise within a trajectory, so with the same momentum injected
on both sides the two agree element for element: in f32 the port's
wrapper (the plain version on the CPU) is held to JAX's HMC and to JAX's
Pallas kernel in interpret mode with the same phase constants (VerletSGLD
at momentum 1 and temperature 1, σ = 0); in f64 to JAX's HMC.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _stat_utils import anderson_normal_p15

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu_torch.mcmc import HMC

from test_torch_hmc_runner import assert_matches_jax
from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_verlet_sgld import _grads, _jax, _torch, _tree

N_DATA, LR = 100.0, 1e-3
CASES = {
    # dtype, tolerance of the vectors, of the sums over them (ΔE's
    # ½‖m‖² sums 5,000 squares: f32 rounds it in its own order)
    "f32": (np.float32, dict(rtol=0, atol=1e-6),
            dict(rtol=1e-6, atol=1e-6)),
    "f64": (np.float64, dict(rtol=1e-10, atol=0),
            dict(rtol=1e-10, atol=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hmc_phases_match_jax(case):
    """initial, two mid and a final phase from one injected momentum: θ,
    m, v, the energy accumulators, the diagnostics and ΔE"""
    dtype, tol, sum_tol = CASES[case]
    tree = _tree(dtype)
    jk = jax_mcmc.HMC(num_data=N_DATA, packing="flat")
    tk = HMC(num_data=N_DATA)
    js = jk.init(_jax(tree), jax.random.key(0), save_state=True)
    ts = tk.init(_torch(tree), seed=0, save_state=True)
    m0 = tk.packer.mask_pad(torch.as_tensor(
        np.random.RandomState(5).randn(tk.packer.total_padded).astype(dtype)))
    js = js._replace(momentum=jnp.asarray(m0.numpy()))
    ts.momentum = m0.clone()
    pallas = None
    if case == "f32":  # JAX's Pallas kernel at the same phase constants
        pk = jax_mcmc.VerletSGLD(num_data=N_DATA, momentum=1.0,
                                 packing="flat", use_pallas=True,
                                 pallas_interpret=True)
        ps = pk.init(_jax(tree), jax.random.key(0))
        pallas = ps._replace(momentum=jnp.asarray(m0.numpy()))
    close = lambda ours, theirs, t=tol: np.testing.assert_allclose(
        np.asarray(ours), np.asarray(theirs), **t)
    n = tk.packer.total
    pe0 = 0.5 * float((m0.double() ** 2).sum())
    for i, kind in enumerate(["initial", "mid", "mid", "final"]):
        g = _grads(tree, 30 + i)
        jg, tg = jk.pack(_jax(g)), tk.pack(_torch(g))
        step = {"initial": "initial_step", "mid": "step",
                "final": "final_step"}[kind]
        kw = {"save_state": True} if kind == "initial" else {}
        js, jm = getattr(jk, step)(js, jg, LR, 1.0, **kw)
        ts, tm = getattr(tk, step)(ts, tg, LR, 1.0, **kw)
        close(ts.position.numpy(), js.position)
        close(ts.momentum.numpy(), js.momentum)
        close(ts.square_avg[:n].numpy(), js.square_avg[:n])
        close(float(ts.delta_energy_acc), float(js.delta_energy_acc),
              sum_tol)
        assert float(ts.prev_nmd) == 0.0
        for key in ("est_temperature", "est_config_temp"):
            close([float(v) for v in tm[key].values()],
                  [float(v) for v in jm[key].values()], sum_tol)
        if pallas is not None:
            pallas, _ = getattr(pk, step)(pallas, jg, LR, 1.0)
            close(ts.position.numpy(), pallas.position)
            close(ts.momentum.numpy(), pallas.momentum)
    close(float(ts.delta_energy_acc), -pe0, sum_tol)
    # ΔE = −½‖m₀‖² + ½‖m‖² + …: it cancels terms of the size of ½‖m₀‖²,
    # whose rounding bounds its error
    close(float(tk.delta_energy(ts, None, LR, 0.3, 0.1)),
          float(jk.delta_energy(js, None, LR, 0.3, 0.1)),
          dict(sum_tol, atol=sum_tol["rtol"] * pe0))


def _net_potential(n=10, seed=0):
    """a 1-10-1 tanh net's Gaussian-noise potential on 10 points (the
    DenseNet of tests/test_hmc.py:26-33), f64, and its parameters"""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 1, generator=gen, dtype=torch.float64)
    y = torch.sin(x)
    params = {"w1": torch.randn(10, 1, generator=gen, dtype=torch.float64),
              "b1": torch.randn(10, generator=gen, dtype=torch.float64),
              "w2": torch.randn(1, 10, generator=gen, dtype=torch.float64)
              / 10 ** 0.5}

    def potential(p):
        f = torch.tanh(x @ p["w1"].T + p["b1"]) @ p["w2"].T
        return ((f - y) ** 2).sum() / (2 * 0.1 ** 2)
    return params, potential


def test_reversible():
    """tests/test_hmc.py:26-76 on the port: two leapfrog steps, then with
    the momentum negated two steps back to the start"""
    params, potential = _net_potential()
    kernel = HMC(num_data=10)
    chain = kernel.init(params, seed=2)
    gen = torch.Generator().manual_seed(3)
    chain.precond = kernel.packer.expand(
        torch.rand(kernel.packer.n_leaves, generator=gen,
                   dtype=torch.float64) + 0.2)
    chain = kernel.sample_momentum(chain, 1.0)

    def grad(c):
        theta = c.position.detach().requires_grad_()
        g, = torch.autograd.grad(potential(kernel.unpack(theta)), theta)
        return g

    snap = lambda c: (c.position.clone(), c.momentum.clone())
    p0, m0 = snap(chain)
    chain, _ = kernel.initial_step(chain, grad(chain), 0.01, 1.0)
    p1, m_half = snap(chain)
    chain, _ = kernel.step(chain, grad(chain), 0.01, 1.0)
    p2, m_3halves = snap(chain)
    chain, _ = kernel.final_step(chain, grad(chain), 0.01, 1.0)
    p2_alt, m2 = snap(chain)
    assert not torch.allclose(p0, p1) and not torch.allclose(p1, p2)
    assert torch.equal(p2, p2_alt)
    assert not torch.allclose(m0, m_half)
    assert not torch.allclose(m_half, m_3halves)
    assert not torch.allclose(m_3halves, m2)

    chain.momentum = -chain.momentum
    chain, _ = kernel.initial_step(chain, grad(chain), 0.01, 1.0)
    assert torch.allclose(chain.position, p1)
    assert torch.allclose(chain.momentum, -m_3halves)
    chain, _ = kernel.step(chain, grad(chain), 0.01, 1.0)
    assert torch.allclose(chain.position, p0)
    assert torch.allclose(chain.momentum, -m_half)
    chain, _ = kernel.final_step(chain, grad(chain), 0.01, 1.0)
    assert torch.allclose(chain.position, p0)
    assert torch.allclose(chain.momentum, -m0)


def test_distribution_preservation(n_vars=50, n_dim=1000, n_samples=100,
                                   momentum_resample=4, seed=3,
                                   store_success=False):
    """tests/test_hmc.py:79-155 on the port: 50 independent N(1, 2²)
    blocks, a trajectory of 4 leapfrog steps between momentum refreshes
    and an M-H test at each end. The Gaussian potential is written out.

    The port draws other random numbers than JAX, so its seed is its own.
    Calibration (`python test_torch_hmc.py 40` in tests/ with the repo
    root on PYTHONPATH, CPU f64, seeds 0-39): acceptance>0.6 40/40,
    anderson_normal_p15 35/40, ks_normal_p30 29/40, ks_config_temp_p30
    29/40, ks_kinetic_temp_p30 31/40 — the nominal rates, as the JAX
    kernel's; seed 3 passes all checks."""
    mean, std = 1.0, 2.0
    lr = 1 / 32
    gen = torch.Generator().manual_seed(seed)
    params = {str(i): mean + std * torch.randn(n_dim, generator=gen,
                                               dtype=torch.float64)
              for i in range(n_vars)}
    kernel = HMC(num_data=1)
    state = kernel.init(params, seed=seed, save_state=True)
    precs = torch.rand(n_vars, generator=gen, dtype=torch.float64)
    state.precond = kernel.packer.expand(kernel.packer.pack_leaf_scalars(
        {str(i): (precs[i] + 0.2) / math.sqrt(std) for i in range(n_vars)}))
    log_norm = -math.log(std) - 0.5 * math.log(2 * math.pi)

    def grad_of(state):
        theta = state.position.detach().requires_grad_()
        pot = -sum((-0.5 * ((v - mean) / std) ** 2 + log_norm).sum()
                   for v in kernel.unpack(theta).values())
        g, = torch.autograd.grad(pot, theta)
        return float(pot.detach()), g

    sum_acceptance, n_acceptance = 0.0, 0
    prev_loss = metrics = None
    for step in range(n_samples + 1):
        loss, grads = grad_of(state)
        if step % momentum_resample == 0:
            if step != 0:
                state, metrics = kernel.final_step(state, grads, lr, 1.0)
                delta_energy = float(kernel.delta_energy(
                    state, grads, lr, prev_loss, loss))
                state, rejected, _ = kernel.maybe_reject(
                    state, delta_energy, 1.0)
                if rejected:
                    assert np.allclose(prev_loss, grad_of(state)[0])
                n_acceptance += 1
                sum_acceptance += min(1.0, math.exp(-delta_energy))
                if step == n_samples:
                    break
                loss, grads = grad_of(state)
            state = kernel.sample_momentum(state, 1.0)
            prev_loss = loss
            state, _ = kernel.initial_step(state, grads, lr, 1.0,
                                           save_state=True)
        else:
            state, _ = kernel.step(state, grads, lr, 1.0)

    checks = {"acceptance>0.6": sum_acceptance / n_acceptance > 0.6}
    out = kernel.params_of(state)
    parameters = torch.cat([v.reshape(-1) for v in out.values()]).numpy()
    kinetic_temp = np.asarray([float(metrics["est_temperature"][k])
                               for k in out])
    config_temp = np.asarray([float(metrics["est_config_temp"][k])
                              for k in out])
    checks["anderson_normal_p15"] = anderson_normal_p15(parameters)
    checks["ks_normal_p30"] = bool(scipy.stats.ks_1samp(
        parameters, lambda x: scipy.stats.norm.cdf(x, loc=mean, scale=std),
        mode="asymp").pvalue >= 0.3)

    def chi2_cdf(x):
        return scipy.stats.chi2.cdf(x, df=n_dim, loc=0.0, scale=1 / n_dim)
    checks["ks_config_temp_p30"] = bool(scipy.stats.ks_1samp(
        config_temp, chi2_cdf, mode="exact").pvalue >= 0.3)
    checks["ks_kinetic_temp_p30"] = bool(scipy.stats.ks_1samp(
        kinetic_temp, chi2_cdf, mode="exact").pvalue >= 0.3)
    if store_success:
        return checks
    for name, ok in checks.items():
        assert ok, f"{name} failed (seed={seed}; see __main__ calibration)"


def test_classical_hmc_runner_matches_jax(monkeypatch):
    "inference=HMC: the reject runner with one batch of all N points"
    assert_matches_jax(monkeypatch, "HMC")


if __name__ == "__main__":
    # Flake-rate calibration over seeds, as in tests/test_hmc.py: a
    # calibrated sampler passes each p=.3 check ~70% of the time and the
    # p=.15 check ~85%; the test pins a seed that passes all of them.
    import sys
    from collections import defaultdict
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    wins, passing = defaultdict(int), []
    for seed in range(n):
        checks = test_distribution_preservation(seed=seed, store_success=True)
        for name, ok in checks.items():
            wins[name] += int(ok)
        if all(checks.values()):
            passing.append(seed)
    for name, w in wins.items():
        print(f"{name:22s} {w}/{n}")
    print("seeds passing all:", passing)
