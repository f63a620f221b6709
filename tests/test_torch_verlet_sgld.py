"""The port's SGLD and VerletSGLD (GGMC) kernels against the JAX package's
(flat packing), plus the distribution-preservation test of
tests/test_verlet_sgld.py run on the port.

At temperature 0 no noise enters, so the two agree element for element: in
f32 the JAX side runs its Pallas kernel in interpret mode and the port its
wrapper (the plain version on the CPU); in f64 both run their plain formula.
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
from bnn_priors_tpu_torch.mcmc import SGLD, VerletSGLD

from test_torch_models import torch_threads_per_worker  # noqa: F401

N_DATA, MOMENTUM, LR = 100.0, 0.9, 1e-3


def _tree(dtype, seed=0):
    "three leaves, 5000 elements: insertion order differs from sorted order"
    rng = np.random.RandomState(seed)
    shapes = {"net.2.w": (40, 50), "net.10.w": (2000,), "net.1.b": (1000,)}
    return {k: rng.randn(*s).astype(dtype) for k, s in shapes.items()}


def _grads(tree, seed):
    rng = np.random.RandomState(seed)
    return {k: (0.1 * rng.randn(*v.shape)).astype(v.dtype)
            for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


CASES = {
    # dtype, JAX kernel options, tolerance
    "f32_pallas": (np.float32, dict(use_pallas=True, pallas_interpret=True),
                   dict(rtol=0, atol=1e-6)),
    "f64_xla": (np.float64, dict(use_pallas=False),
                dict(rtol=1e-10, atol=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ggmc_phases_match_jax_at_t0(case):
    dtype, jax_opts, tol = CASES[case]
    tree = _tree(dtype)
    jk = jax_mcmc.VerletSGLD(num_data=N_DATA, momentum=MOMENTUM,
                             packing="flat", **jax_opts)
    tk = VerletSGLD(num_data=N_DATA, momentum=MOMENTUM)
    js = jk.init(_jax(tree), jax.random.key(0), save_state=True)
    ts = tk.init(_torch(tree), seed=0, save_state=True)
    assert tk.packer.names == jk.packer.names
    close = lambda ours, theirs: np.testing.assert_allclose(
        np.asarray(ours), np.asarray(theirs), **tol)
    phases = ["initial", "mid", "mid", "final"]
    for i, kind in enumerate(phases):
        g = _grads(tree, 10 + i)
        jg, tg = jk.pack(_jax(g)), tk.pack(_torch(g))
        if kind == "initial":
            js, jm = jk.initial_step(js, jg, LR, 0.0, save_state=True)
            ts, tm = tk.initial_step(ts, tg, LR, 0.0, save_state=True)
        elif kind == "mid":
            js, jm = jk.step(js, jg, LR, 0.0)
            ts, tm = tk.step(ts, tg, LR, 0.0)
        else:
            js, jm = jk.final_step(js, jg, LR, 0.0)
            ts, tm = tk.final_step(ts, tg, LR, 0.0)
        assert ts.position.dtype == torch.float32 if dtype == np.float32 \
            else torch.float64
        close(ts.position.numpy(), js.position)
        close(ts.momentum.numpy(), js.momentum)
        # the padding tail of v: the kernels zero it, the XLA formula
        # carries init's ones along (nothing reads it)
        n = tk.packer.total
        close(ts.square_avg[:n].numpy(), js.square_avg[:n])
        close(float(ts.delta_energy_acc), float(js.delta_energy_acc))
        close(float(ts.prev_nmd), float(js.prev_nmd))
        for key in ("est_temperature", "est_config_temp"):
            assert list(tm[key]) == list(jm[key])
            close([float(v) for v in tm[key].values()],
                  [float(v) for v in jm[key].values()])
    close(float(tk.delta_energy(ts, None, LR, 0.3, 0.1)),
          float(jk.delta_energy(js, None, LR, 0.3, 0.1)))


def test_update_preconditioner_matches_jax():
    tree = _tree(np.float64)
    jk = jax_mcmc.VerletSGLD(num_data=N_DATA, momentum=MOMENTUM,
                             packing="flat")
    tk = VerletSGLD(num_data=N_DATA, momentum=MOMENTUM)
    js = jk.init(_jax(tree), jax.random.key(0))
    ts = tk.init(_torch(tree))
    sq = {k: np.abs(v) * (i + 1.0) for i, (k, v) in
          enumerate(_grads(tree, 3).items())}
    js = js._replace(square_avg=jk.pack(_jax(sq)))
    ts.square_avg = tk.pack(_torch(sq))
    js = jk.update_preconditioner(js)
    ts = tk.update_preconditioner(ts)
    np.testing.assert_allclose(ts.precond.numpy(), np.asarray(js.precond),
                               rtol=1e-14)
    np.testing.assert_allclose(tk.leaf_precond(ts).numpy(),
                               np.asarray(jk.leaf_precond(js)), rtol=1e-14)
    assert float(tk.leaf_precond(ts).max()) == 1.0  # the flattest leaf


@pytest.mark.parametrize("flip", [False, True])
def test_maybe_reject_restores_saved_state_exactly(flip):
    """ΔE=+1e30 at T=1 rejects and restores (θ, m, g) from the initial step
    bit for bit, although the kernel updated θ and m in place since."""
    tree = _tree(np.float64)
    tk = VerletSGLD(num_data=N_DATA, momentum=MOMENTUM)
    ts = tk.init(_torch(tree), seed=1, save_state=True)
    ts = tk.sample_momentum(ts, 1.0)
    g0 = tk.pack(_torch(_grads(tree, 1)))
    pos0, mom0 = ts.position.clone(), ts.momentum.clone()
    ts, _ = tk.initial_step(ts, g0, LR, 1.0, save_state=True)
    ts, _ = tk.step(ts, tk.pack(_torch(_grads(tree, 2))), LR, 1.0)
    g2 = tk.pack(_torch(_grads(tree, 3)))
    ts, _ = tk.final_step(ts, g2, LR, 1.0)
    assert not torch.equal(ts.position, pos0)
    ts, rejected, lap = tk.maybe_reject(ts, torch.tensor(1e30, dtype=torch.float64), 1.0,
                                        flip_on_reject=flip)
    assert rejected and lap == -1e30
    assert torch.equal(ts.position, pos0)
    assert torch.equal(ts.momentum, -mom0 if flip else mom0)
    assert torch.equal(ts.grads, g0)
    # accepting leaves the state alone; T=0 never rejects
    pos1 = ts.position.clone()
    _, rejected, _ = tk.maybe_reject(ts, -1e30, 1.0)
    assert not rejected and torch.equal(ts.position, pos1)
    _, rejected, _ = tk.maybe_reject(ts, 1e30, 0.0)
    assert not rejected


def test_sgld_step_matches_jax_at_t0():
    tree = _tree(np.float64)
    jk = jax_mcmc.SGLD(num_data=N_DATA, momentum=MOMENTUM, packing="flat",
                       use_pallas=False)
    tk = SGLD(num_data=N_DATA, momentum=MOMENTUM)
    js = jk.init(_jax(tree), jax.random.key(0))
    ts = tk.init(_torch(tree))
    for i in range(3):
        g = _grads(tree, 20 + i)
        js, jm = jk.step(js, jk.pack(_jax(g)), LR, 0.0)
        ts, tm = tk.step(ts, tk.pack(_torch(g)), LR, 0.0)
        for key in ("est_temperature", "est_config_temp"):
            np.testing.assert_allclose(
                [float(v) for v in tm[key].values()],
                [float(v) for v in jm[key].values()], rtol=1e-10)
    for ours, theirs in ((ts.position, js.position),
                         (ts.momentum, js.momentum),
                         (ts.square_avg, js.square_avg)):
        n = tk.packer.total  # see the v tail note above
        np.testing.assert_allclose(ours[:n].numpy(), np.asarray(theirs)[:n],
                                   rtol=1e-10)


def test_distribution_preservation(n_vars=50, n_dim=1000, n_samples=200,
                                   mh_freq=4, seed=12, store_success=False):
    """tests/test_verlet_sgld.py::test_distribution_preservation on the
    port: 50 independent N(1, 2²) blocks at temperature 3/4, M-H every 4
    steps. The Gaussian potential is written out here.

    The port draws other random numbers than JAX, so its seed is its own.
    Calibration (`python tests/test_torch_verlet_sgld.py 40` from the repo
    root with it on PYTHONPATH, CPU f64, seeds 0-39): acceptance>0.6 40/40,
    anderson_normal_p15 32/40, ks_normal_p30 27/40, ks_config_temp_p30
    30/40, ks_kinetic_temp_p30 28/40 — the nominal rates, as the JAX
    kernel's; seed 12 passes all checks."""
    mean, std = 1.0, 2.0
    temperature = 3 / 4
    lr = 1 / 32
    gen = torch.Generator().manual_seed(seed)
    params = {str(i): (mean + std * torch.randn(n_dim, generator=gen,
                                                 dtype=torch.float64)
                       - mean) * temperature ** 0.5 + mean
              for i in range(n_vars)}

    kernel = VerletSGLD(num_data=1, momentum=0.9)
    state = kernel.init(params, seed=seed, save_state=True)
    precs = torch.rand(n_vars, generator=gen, dtype=torch.float64)
    state.precond = kernel.packer.expand(kernel.packer.pack_leaf_scalars(
        {str(i): (precs[i] + 0.2) / math.sqrt(4) for i in range(n_vars)}))
    state = kernel.sample_momentum(state, temperature)
    log_norm = -math.log(std) - 0.5 * math.log(2 * math.pi)

    def grad_of(state):
        "potential = −Σ log N(θ; mean, std²), and its packed gradient"
        theta = state.position.detach().requires_grad_()
        pot = -sum((-0.5 * ((v - mean) / std) ** 2 + log_norm).sum()
                   for v in kernel.unpack(theta).values())
        g, = torch.autograd.grad(pot, theta)
        return float(pot.detach()), g

    sum_acceptance, n_acceptance = 0.0, 0
    prev_loss = None
    metrics = None
    for step in range(n_samples + 1):
        loss, grads = grad_of(state)
        if step % mh_freq == 0:
            if step != 0:
                state, metrics = kernel.final_step(state, grads, lr,
                                                   temperature)
                delta_energy = float(kernel.delta_energy(
                    state, grads, lr, prev_loss, loss))
                state, rejected, _ = kernel.maybe_reject(
                    state, delta_energy, temperature)
                if rejected:
                    assert np.allclose(prev_loss, grad_of(state)[0])
                n_acceptance += 1
                sum_acceptance += min(1.0, math.exp(-delta_energy))
                if step == n_samples:
                    break
                loss, grads = grad_of(state)
            prev_loss = loss
            state, _ = kernel.initial_step(state, grads, lr, temperature,
                                           save_state=True)
        else:
            state, _ = kernel.step(state, grads, lr, temperature)

    checks = {"acceptance>0.6": sum_acceptance / n_acceptance > 0.6}
    out = kernel.params_of(state)
    parameters = torch.cat([v.reshape(-1) for v in out.values()]).numpy()
    kinetic_temp = np.asarray([float(metrics["est_temperature"][k])
                               for k in out])
    config_temp = np.asarray([float(metrics["est_config_temp"][k])
                              for k in out])
    checks["anderson_normal_p15"] = anderson_normal_p15(parameters)

    def norm_cdf(x):
        return scipy.stats.norm.cdf(x, loc=mean,
                                    scale=std * temperature ** 0.5)
    checks["ks_normal_p30"] = bool(scipy.stats.ks_1samp(
        parameters, norm_cdf, mode="asymp").pvalue >= 0.3)

    def chi2_cdf(x):
        return scipy.stats.chi2.cdf(x, df=n_dim, loc=0.0,
                                    scale=temperature / n_dim)
    checks["ks_config_temp_p30"] = bool(scipy.stats.ks_1samp(
        config_temp, chi2_cdf, mode="exact").pvalue >= 0.3)
    checks["ks_kinetic_temp_p30"] = bool(scipy.stats.ks_1samp(
        kinetic_temp, chi2_cdf, mode="exact").pvalue >= 0.3)
    if store_success:
        return checks
    for name, ok in checks.items():
        assert ok, f"{name} failed (seed={seed}; see __main__ calibration)"


if __name__ == "__main__":
    # Flake-rate calibration over seeds, as in tests/test_verlet_sgld.py:
    # a calibrated sampler passes each p=.3 check ~70% of the time and the
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
