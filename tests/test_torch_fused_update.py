"""The port's fused Langevin update (`bnn_priors_tpu_torch.ops.fused_update`)
against the JAX package's Pallas kernel and its XLA formula.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel
itself runs only on a card and is held against that plain version by
`chip_smoke.py`. The Pallas kernel runs here in interpret mode, which draws
zero noise bits (see tests/test_ops.py), so the kernel comparison is at
noise_std=0 and the noise path is checked by injecting one ξ into both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.mcmc.packing import Packer as JaxPacker
from bnn_priors_tpu.ops import fused_langevin_update as jax_fused
from bnn_priors_tpu_torch.mcmc.packing import PACK_ALIGN, Packer
from bnn_priors_tpu_torch.ops import fused_update as fu

from test_torch_models import torch_threads_per_worker  # noqa: F401


def _inputs(total, dtype, seed=3):
    "packed (θ, m, v, g, M) on a two-leaf tree, zero tails, from numpy"
    n1 = total // 3
    tree = {"a": np.zeros(n1), "b": np.zeros(total - n1)}
    pk = Packer({k: torch.as_tensor(v) for k, v in tree.items()})
    T = pk.total_padded
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < total).astype(np.float64)
    theta, m, g = (rng.randn(T) * mask for _ in range(3))
    v = (np.abs(rng.randn(T)) + 0.1) * mask
    M = pk.expand(torch.as_tensor(np.abs(rng.randn(pk.n_leaves)) + 0.5)).numpy()
    return pk, [a.astype(dtype) for a in (theta, m, v, g, M)]


@pytest.mark.parametrize("total", [1000, 70000])
@pytest.mark.parametrize("pos_c,alpha", [(0.01, 0.99), (0.0, 1.0)])
def test_plain_version_matches_pallas_kernel(total, pos_c, alpha):
    "noise_std=0: the port's plain version equals the Pallas kernel"
    pk, arrs = _inputs(total, np.float32)
    coeffs = (0.9, -0.05, 0.0, pos_c, alpha)
    jth, jm, jv, jparts = jax_fused(
        *(jnp.asarray(a) for a in arrs), jnp.zeros((2,), jnp.uint32), coeffs,
        total=total, block_rows=64, interpret=True)
    th, m, v, g, M = (torch.as_tensor(a.copy()) for a in arrs)
    th, m, v, parts = fu.fused_langevin_update_reference(
        th, m, v, g, M, 0, coeffs, total=total)
    assert th.dtype == torch.float32
    for ours, theirs in ((th, jth), (m, jm), (v, jv)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)
        np.testing.assert_array_equal(ours[total:].numpy(), 0.0)
    # the two sum in different orders (per-block vs whole vector)
    np.testing.assert_allclose(parts.numpy(), np.asarray(jparts),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["initial", "mid", "final"])
def test_injected_noise_matches_jax_formula(kind):
    """The plain version with ξ injected equals the JAX XLA branch of
    `VerletSGLD._step` (verlet_sgld.py:127-136) on the same ξ, in f64."""
    total = 5000
    pk, (theta, m, v, g, M) = _inputs(total, np.float64, seed=4)
    xi = np.random.RandomState(5).randn(pk.total_padded)
    a, lr, N, temp = 0.9, 1e-3, 100.0, 0.7
    bh, bhn = np.sqrt(lr / N), np.sqrt(lr * N)
    mom_decay, grad_v, noise_var = {
        "initial": (a ** 0.5, 1.0, (1 - a) * temp),
        "mid": (a, 1.0 + a, (1 - a ** 2) * temp),
        "final": (a ** 0.5, a ** 0.5, (1 - a) * temp)}[kind]
    noise_std = np.sqrt(noise_var)
    grad_lr = -0.5 * grad_v * bhn
    pos_c, alpha = (0.0, 1.0) if kind == "final" else (bh, 0.99)

    # JAX: the XLA branch, with the padding-masked ξ of Packer.normal_like
    jpk = JaxPacker({"a": jnp.zeros(total // 3),
                     "b": jnp.zeros(total - total // 3)})
    J = jnp.asarray
    noise = jpk.mask_pad(J(xi))
    jm = noise_std * noise + grad_lr * (J(M) * J(g)) + mom_decay * J(m)
    jth = J(theta) + pos_c * (J(M) * jm)
    jv = alpha * J(v) + (1 - alpha) * J(g) * J(g)
    jparts = [jnp.sum(J(M) * J(g) * J(m)), jnp.sum(J(M) * J(g) * jm),
              jnp.sum((J(M) * J(g)) ** 2)]

    T = lambda a: torch.as_tensor(a.copy())
    th2, m2, v2, parts = fu.fused_langevin_update_reference(
        T(theta), T(m), T(v), T(g), T(M), 0,
        (mom_decay, grad_lr, noise_std, pos_c, alpha), total=total, xi=T(xi))
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jth), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(v2[:total].numpy(), np.asarray(jv)[:total],
                               rtol=1e-12)
    np.testing.assert_array_equal(v2[total:].numpy(), 0.0)
    np.testing.assert_allclose(parts.numpy(), np.asarray(jparts), rtol=1e-10)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    total = 70000
    _, arrs = _inputs(total, np.float32, seed=6)
    coeffs = (0.9, -0.05, 0.3, 0.01, 0.99)
    a = [torch.as_tensor(x.copy()) for x in arrs]
    b = [torch.as_tensor(x.copy()) for x in arrs]
    before = fu.launches
    out = fu.fused_langevin_update(*a, 11, coeffs, total=total)
    ref = fu.fused_langevin_update_reference(*b, 11, coeffs, total=total)
    assert fu.launches == before
    # same seed, same plain version: bitwise equal, updated in place
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert out[0] is a[0] and out[1] is a[1] and out[2] is a[2]
    assert not np.array_equal(a[0].numpy(), arrs[0])
    # noise is drawn, and masked off the padding tail
    assert float(a[1][:total].std()) > 0.1
    np.testing.assert_array_equal(a[1][total:].numpy(), 0.0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    total = 1000
    _, arrs = _inputs(total, np.float32)
    coeffs = (0.9, -0.05, 0.0, 0.01, 0.99)
    f64 = [torch.as_tensor(x.astype(np.float64)) for x in arrs]
    with pytest.raises(TypeError):
        fu.fused_langevin_update(*f64, 0, coeffs, total=total)
    short = [torch.as_tensor(x[:PACK_ALIGN - 24].copy()) for x in arrs]
    with pytest.raises(ValueError):
        fu.fused_langevin_update(*short, 0, coeffs, total=total)
    ok = [torch.as_tensor(x.copy()) for x in arrs]
    with pytest.raises(ValueError):
        fu.fused_langevin_update(*ok, 0, coeffs, total=PACK_ALIGN + 1)
    strided = [torch.as_tensor(np.repeat(x, 2))[::2] for x in arrs]
    with pytest.raises(ValueError):
        fu.fused_langevin_update(*strided, 0, coeffs, total=total)
