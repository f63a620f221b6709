"""The chain axis's building blocks: the `(K, T)` form of the fused update
(`fused_langevin_update_chains`), the packer's chain-batched forms and the
K-chain GGMC kernel (`VerletSGLDChains`), against the JAX package and
against the port's own single-chain forms.

On the CPU the wrappers run the plain versions; the CUDA kernel runs only
on a card and is held against its plain version by `chip_smoke.py`. The
Pallas kernel runs here in interpret mode under `jax.vmap` (how the JAX
package runs K chains), which draws zero noise bits (see tests/test_ops.py),
so that comparison is at noise_std=0 and the noise path is checked by
injecting one ξ per chain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu.ops import fused_langevin_update as jax_fused
from bnn_priors_tpu_torch.mcmc import Packer, VerletSGLD, VerletSGLDChains
from bnn_priors_tpu_torch.ops import fused_update as fu

from test_torch_models import torch_threads_per_worker  # noqa: F401

K = 3


def _chain_inputs(total, dtype, seed=3):
    "K chains' packed (θ, m, v, g, M) on a two-leaf tree, zero tails"
    n1 = total // 3
    pk = Packer({"a": torch.zeros(n1), "b": torch.zeros(total - n1)})
    T = pk.total_padded
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < total).astype(np.float64)
    theta, m, g = (rng.randn(K, T) * mask for _ in range(3))
    v = (np.abs(rng.randn(K, T)) + 0.1) * mask
    M = pk.expand(torch.as_tensor(np.abs(rng.randn(K, pk.n_leaves)) + 0.5))
    return pk, [a.astype(dtype) for a in (theta, m, v, g, M.numpy())]


@pytest.mark.parametrize("total", [1000, 3000])
@pytest.mark.parametrize("pos_c,alpha", [(0.01, 0.99), (0.0, 1.0)])
def test_chain_plain_version_matches_vmapped_pallas_kernel(total, pos_c,
                                                           alpha):
    """noise_std=0 for every chain: the port's (K, T) plain version equals
    `jax.vmap` of the Pallas kernel with per-chain seeds and noise_std"""
    _, arrs = _chain_inputs(total, np.float32)
    mom_decay, grad_lr = 0.9, -0.05

    def one(th, m, v, g, M, seed2, noise_std):
        return jax_fused(th, m, v, g, M, seed2,
                         (mom_decay, grad_lr, noise_std, pos_c, alpha),
                         total=total, block_rows=8, interpret=True)
    seeds2 = jnp.arange(2 * K, dtype=jnp.uint32).reshape(K, 2)
    jth, jm, jv, jparts = jax.vmap(one)(*(jnp.asarray(a) for a in arrs),
                                        seeds2, jnp.zeros(K, jnp.float32))
    th, m, v, g, M = (torch.as_tensor(a.copy()) for a in arrs)
    th, m, v, parts = fu.fused_langevin_update_chains_reference(
        th, m, v, g, M, torch.arange(K), torch.zeros(K),
        (mom_decay, grad_lr, pos_c, alpha), total=total)
    assert th.dtype == torch.float32 and parts.shape == (K, 3)
    for ours, theirs in ((th, jth), (m, jm), (v, jv)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)
        np.testing.assert_array_equal(ours[:, total:].numpy(), 0.0)
    # the two sum in different orders (per-block vs whole row)
    np.testing.assert_allclose(parts.numpy(), np.asarray(jparts),
                               rtol=2e-4, atol=1e-3)


def test_chain_rows_are_single_chain_updates_with_injected_noise():
    """f64, per-chain noise_std and one ξ row a chain: row k of the (K, T)
    plain version is the (T,) plain version on chain k's inputs"""
    total = 5000
    _, arrs = _chain_inputs(total, np.float64, seed=4)
    xi = np.random.RandomState(5).randn(K, arrs[0].shape[1])
    sigma = np.array([0.0, 0.3, 1.1])
    coeffs = (0.9, -0.05, 0.01, 0.99)
    T = lambda a: torch.as_tensor(np.array(a))
    th, m, v, parts = fu.fused_langevin_update_chains_reference(
        *(T(a) for a in arrs), torch.arange(K), T(sigma), coeffs,
        total=total, xi=T(xi))
    for k in range(K):
        rth, rm, rv, rparts = fu.fused_langevin_update_reference(
            *(T(a[k]) for a in arrs), k,
            (coeffs[0], coeffs[1], sigma[k], coeffs[2], coeffs[3]),
            total=total, xi=T(xi[k]))
        for ours, theirs in ((th[k], rth), (m[k], rm), (v[k], rv),
                             (parts[k], rparts)):
            np.testing.assert_allclose(ours.numpy(), theirs.numpy(),
                                       rtol=1e-12, atol=1e-15)


def test_chain_wrapper_on_cpu_runs_plain_version_without_launch():
    total = 3000
    _, arrs = _chain_inputs(total, np.float32, seed=6)
    seeds = torch.tensor([11, 12, 2 ** 40], dtype=torch.int64)
    sigma = torch.tensor([0.3, 0.0, 1.0])
    coeffs = (0.9, -0.05, 0.01, 0.99)
    a = [torch.as_tensor(x.copy()) for x in arrs]
    b = [torch.as_tensor(x.copy()) for x in arrs]
    before = (fu.launches, fu.chain_launches)
    out = fu.fused_langevin_update_chains(*a, seeds, sigma, coeffs,
                                          total=total)
    ref = fu.fused_langevin_update_chains_reference(*b, seeds, sigma, coeffs,
                                                    total=total)
    assert (fu.launches, fu.chain_launches) == before
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert out[0] is a[0] and out[1] is a[1] and out[2] is a[2]
    # each row draws the (T,) plain version's noise for its seed
    c = [torch.as_tensor(x[0].copy()) for x in arrs]
    fu.fused_langevin_update_reference(*c, 11, (0.9, -0.05, 0.3, 0.01, 0.99),
                                       total=total)
    np.testing.assert_array_equal(a[1][0].numpy(), c[1].numpy())
    # noise where σ > 0, masked off the padding tail
    assert float(a[1][2, :total].std()) > 0.5
    np.testing.assert_array_equal(a[1][:, total:].numpy(), 0.0)


def test_chain_wrapper_rejects_what_the_kernel_does_not_take():
    total = 1000
    _, arrs = _chain_inputs(total, np.float32)
    coeffs = (0.9, -0.05, 0.01, 0.99)
    seeds, sigma = torch.arange(K), torch.zeros(K)
    ok = lambda: [torch.as_tensor(x.copy()) for x in arrs]
    with pytest.raises(TypeError):
        fu.fused_langevin_update_chains(
            *[t.double() for t in ok()], seeds, sigma, coeffs, total=total)
    with pytest.raises(ValueError):  # a (T,) state is the other form's
        fu.fused_langevin_update_chains(*[t[0] for t in ok()], seeds, sigma,
                                        coeffs, total=total)
    with pytest.raises(ValueError):
        fu.fused_langevin_update_chains(*ok(), seeds.int(), sigma, coeffs,
                                        total=total)
    with pytest.raises(ValueError):
        fu.fused_langevin_update_chains(*ok(), seeds[:2], sigma, coeffs,
                                        total=total)
    with pytest.raises(ValueError):
        fu.fused_langevin_update_chains(*ok(), seeds, sigma[:1], coeffs,
                                        total=total)
    with pytest.raises(ValueError):
        fu.fused_langevin_update_chains(*[t.t().contiguous().t() for t in ok()],
                                        seeds, sigma, coeffs, total=total)


def test_packer_chain_forms():
    "pack/unpack/segment sums of a (K, T) bank are the rows' own, exactly"
    rng = np.random.RandomState(0)
    shapes = {"net.2.w": (4, 5), "net.10.w": (7,), "net.1.b": ()}
    pk = Packer({k: torch.zeros(s) for k, s in shapes.items()})
    trees = [{k: torch.as_tensor(rng.randn(*s)) for k, s in shapes.items()}
             for _ in range(K)]
    stacked = {k: torch.stack([t[k] for t in trees]) for k in shapes}
    bank = pk.pack(stacked)
    assert bank.shape == (K, pk.total_padded)
    for k in range(K):
        row = pk.pack(trees[k])
        np.testing.assert_array_equal(bank[k].numpy(), row.numpy())
        np.testing.assert_array_equal(pk.segment_sum(bank)[k].numpy(),
                                      pk.segment_sum(row).numpy())
        np.testing.assert_array_equal(pk.leaf_means(bank)[k].numpy(),
                                      pk.leaf_means(row).numpy())
    views = pk.unpack(bank)
    for name, s in shapes.items():
        assert views[name].shape == (K, *s)
        np.testing.assert_array_equal(views[name].numpy(),
                                      stacked[name].numpy())
    leaf = torch.as_tensor(rng.rand(K, pk.n_leaves))
    np.testing.assert_array_equal(pk.leaf_firsts(pk.expand(leaf)).numpy(),
                                  leaf.numpy())
    assert list(pk.unpack_leaf_scalars(leaf)["net.1.b"].shape) == [K]


def _tree(seed):
    rng = np.random.RandomState(seed)
    shapes = {"net.2.w": (40, 50), "net.10.w": (2000,), "net.1.b": (1000,)}
    return {k: rng.randn(*s) for k, s in shapes.items()}


def test_chain_kernel_rows_match_single_chain_kernels_and_jax_at_t0():
    """T=0, f64: every GGMC phase of VerletSGLDChains on K chains equals K
    single-chain VerletSGLD kernels and `jax.vmap` of the JAX kernel, per
    chain (positions, momenta, energy accumulators, metrics)"""
    N, a, lr = 100.0, 0.9, 1e-3
    trees = [_tree(s) for s in range(K)]
    stacked = {k: torch.as_tensor(np.stack([t[k] for t in trees]))
               for k in trees[0]}
    ck = VerletSGLDChains(num_data=N, momentum=a)
    cs = ck.init(stacked, seeds=[1, 2, 3], save_state=True)
    sks = [VerletSGLD(num_data=N, momentum=a) for _ in range(K)]
    sss = [sk.init({k: torch.as_tensor(v) for k, v in t.items()},
                   save_state=True) for sk, t in zip(sks, trees)]
    jk = jax_mcmc.VerletSGLD(num_data=N, momentum=a, packing="flat",
                             use_pallas=False)
    js = jax.vmap(lambda p, key: jk.init(p, key, save_state=True))(
        {k: jnp.asarray(v.numpy()) for k, v in stacked.items()},
        jax.random.split(jax.random.key(0), K))
    temps = torch.zeros(K, dtype=torch.float64)
    for i, kind in enumerate(["initial", "mid", "mid", "final"]):
        g = np.stack([0.1 * np.random.RandomState(10 * i + k).randn(
            ck.packer.total_padded) for k in range(K)])
        g[:, ck.packer.total:] = 0.0
        call = {"initial": lambda kn, s, gg, T: kn.initial_step(
                    s, gg, lr, T, save_state=True),
                "mid": lambda kn, s, gg, T: kn.step(s, gg, lr, T),
                "final": lambda kn, s, gg, T: kn.final_step(s, gg, lr, T)}[kind]
        cs, cm = call(ck, cs, torch.as_tensor(g), temps)
        js, jm = jax.vmap(lambda s, gg: call(jk, s, gg, 0.0))(js,
                                                               jnp.asarray(g))
        for k in range(K):
            sss[k], sm = call(sks[k], sss[k], torch.as_tensor(g[k]), 0.0)
            for ours, theirs in ((cs.position[k], sss[k].position),
                                 (cs.momentum[k], sss[k].momentum),
                                 (cs.delta_energy_acc[k],
                                  sss[k].delta_energy_acc),
                                 (cs.prev_nmd[k], sss[k].prev_nmd)):
                np.testing.assert_allclose(ours.numpy(), theirs.numpy(),
                                           rtol=1e-12, atol=1e-15)
            for key in ("est_temperature", "est_config_temp"):
                np.testing.assert_allclose(
                    [float(v[k]) for v in cm[key].values()],
                    [float(v) for v in sm[key].values()], rtol=1e-12)
        np.testing.assert_allclose(cs.position.numpy(),
                                   np.asarray(js.position), rtol=1e-10)
        np.testing.assert_allclose(cs.delta_energy_acc.numpy(),
                                   np.asarray(js.delta_energy_acc),
                                   rtol=1e-10)
    prev = torch.tensor([0.3, 0.1, 0.2], dtype=torch.float64)
    pot = torch.tensor([0.1, 0.4, 0.2], dtype=torch.float64)
    np.testing.assert_allclose(
        ck.delta_energy(cs, None, lr, prev, pot).numpy(),
        [float(sks[k].delta_energy(sss[k], None, lr, float(prev[k]),
                                   float(pot[k]))) for k in range(K)],
        rtol=1e-12)
    # the preconditioner: each chain's own leaf minimum
    cs.square_avg = torch.as_tensor(np.abs(np.stack(
        [np.random.RandomState(k).randn(ck.packer.total_padded)
         for k in range(K)])))
    cs = ck.update_preconditioner(cs)
    for k in range(K):
        sss[k].square_avg = cs.square_avg[k].clone()
        sss[k] = sks[k].update_preconditioner(sss[k])
        np.testing.assert_allclose(cs.precond[k].numpy(),
                                   sss[k].precond.numpy(), rtol=1e-14)


@pytest.mark.parametrize("flip", [False, True])
def test_chain_maybe_reject_restores_only_its_own_rows(flip):
    """ΔE = (+1e30, -1e30, +1e30) at T = (1, 1, 0): chain 0 rejects and
    gets its saved rows back bit for bit; chain 1 accepts; chain 2 is at
    T=0 and never rejects. One (K,) decision, no host loop."""
    trees = [_tree(s) for s in range(K)]
    stacked = {k: torch.as_tensor(np.stack([t[k] for t in trees]))
               for k in trees[0]}
    ck = VerletSGLDChains(num_data=100.0, momentum=0.9)
    temps = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64)
    cs = ck.init(stacked, seeds=[4, 5, 6], save_state=True)
    cs = ck.sample_momentum(cs, temps)
    assert float(cs.momentum[2].abs().max()) == 0.0  # T=0: no momentum
    g = lambda s: torch.as_tensor(np.stack([
        0.1 * np.random.RandomState(s + k).randn(ck.packer.total_padded)
        for k in range(K)]) * ck.packer.valid_mask(torch.float64).numpy())
    pos0, mom0, g0 = cs.position.clone(), cs.momentum.clone(), g(0)
    cs, _ = ck.initial_step(cs, g0, 1e-3, temps, save_state=True)
    cs, _ = ck.step(cs, g(10), 1e-3, temps)
    cs, _ = ck.final_step(cs, g(20), 1e-3, temps)
    moved_pos, moved_mom = cs.position.clone(), cs.momentum.clone()
    de = torch.tensor([1e30, -1e30, 1e30], dtype=torch.float64)
    cs, rejected, lap = ck.maybe_reject(cs, de, temps, flip_on_reject=flip)
    assert rejected.tolist() == [True, False, False]
    assert lap[0] == -1e30 and lap[1] == 1e30
    assert torch.equal(cs.position[0], pos0[0])
    assert torch.equal(cs.momentum[0], -mom0[0] if flip else mom0[0])
    assert torch.equal(cs.grads[0], g0[0])
    for k in (1, 2):
        assert torch.equal(cs.position[k], moved_pos[k])
        assert torch.equal(cs.momentum[k], moved_mom[k])
        assert not torch.equal(cs.position[k], pos0[k])
