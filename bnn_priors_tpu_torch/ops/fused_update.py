"""Fused Langevin/GGMC parameter update: Triton kernels for Hopper (sm_90a),
their plain PyTorch versions, and the wrappers that pick between them.

Replaces the Pallas TPU kernel
`bnn_priors_tpu/ops/fused_update.py::_update_kernel` (wrapper
`fused_langevin_update`) in both of the forms the JAX package runs it in:
one chain's `(T,)` state (`fused_langevin_update`), and K chains' `(K, T)`
state, which the JAX package gets by `jax.vmap` of the same call
(`fused_langevin_update_chains`). One pass over the flat-packed chain state
(reads θ, m, v, g, M; writes θ', m', v' in place) computes

    ξ   ~ N(0, I)                 (Philox normals keyed by the seed and the
                                   element's index within its chain, drawn
                                   in registers, never stored)
    m'  = noise_std·ξ + grad_lr·(M·g) + mom_decay·m
    θ'  = θ + pos_c·(M·m')
    v'  = alpha·v + (1-alpha)·g²
    partials = [Σ (M·g)·m, Σ (M·g)·m', Σ (M·g)²]

The coefficients are runtime values, so one compiled kernel serves the SGLD
step and all three GGMC phases. Elements at index ≥ `total` (the Packer's
padding tail) are written as 0 and left out of the partials.

Design on the card. The TPU kernel walks a sequential grid and keeps its
partial sums in one SMEM row per block; on Hopper the programs run in
parallel, so each program writes its three partial sums to its own row of a
`(n_blocks, 3)` buffer (`(K, n_blocks, 3)` for K chains) and a fixed-order
sum over the block axis gives the partials: no float atomics, so ΔE is
reproducible run to run. The noise is keyed by the element's index within
its chain, not by the block or the chain's row, so it depends neither on
BLOCK nor on K: row k of a `(K, T)` launch is bit for bit a `(T,)` launch
with chain k's seed and noise_std, because both kernels run one shared
block body (`_update_block`).

The chain form takes each chain's seed and noise_std (tempering gives every
chain its own temperature) as `(K,)` device tensors, so a step of K chains
is one launch with no host-to-device copy; mom_decay, grad_lr, pos_c and
alpha stay host floats, one schedule value for every chain.

Bound. The function must read 5 and write 3 f32 vectors: 32 B per element.
ResNet-20 (T = 273,408): 8.75 MB a chain, about 2.6 µs at the H100's
3.35 TB/s; K=8 chains 70 MB, about 21 µs. At one chain launch latency
dominates; the chain form amortises one launch over K chains. The design's
answer to the bytes is one pass: the noise is never stored and the partials
are never re-read.
"""
from __future__ import annotations

import torch

from ..mcmc.packing import PACK_ALIGN

# Elements per program. T % PACK_ALIGN == 0, so BLOCK divides T exactly.
BLOCK = 1024

# Launches of the Triton kernels since import (or since a caller reset
# them): `launches` counts the (T,) form, `chain_launches` the (K, T) form.
# Each wrapper adds one where it launches its kernel and nowhere else.
launches = 0
chain_launches = 0

_kernels = None


def _build_kernels():
    "compile-on-first-use: triton is imported only where a kernel launches"
    global _kernels
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def _update_block(th_ptr, m_ptr, v_ptr, g_ptr, M_ptr, offs, total, seed,
                      noise_std, mom_decay, grad_lr, pos_c, alpha):
        "one block of one chain; pointers at the chain's row, offs within it"
        valid = offs < total
        th = tl.load(th_ptr + offs)
        m = tl.load(m_ptr + offs)
        v = tl.load(v_ptr + offs)
        g = tl.load(g_ptr + offs)
        M = tl.load(M_ptr + offs)
        xi = tl.where(valid, tl.randn(seed, offs), 0.0)
        Mg = tl.where(valid, M * g, 0.0)
        m_old = tl.where(valid, m, 0.0)
        new_m = noise_std * xi + grad_lr * Mg + mom_decay * m_old
        tl.store(m_ptr + offs, new_m)
        tl.store(th_ptr + offs, tl.where(valid, th + pos_c * (M * new_m), 0.0))
        tl.store(v_ptr + offs,
                 tl.where(valid, alpha * v + (1.0 - alpha) * g * g, 0.0))
        return (tl.sum(Mg * m_old, axis=0), tl.sum(Mg * new_m, axis=0),
                tl.sum(Mg * Mg, axis=0))

    # the seed changes every call: keep it out of the specialisation key
    @triton.jit(do_not_specialize=["seed"])
    def langevin_update_kernel(th_ptr, m_ptr, v_ptr, g_ptr, M_ptr, part_ptr,
                               total, seed, mom_decay, grad_lr, noise_std,
                               pos_c, alpha, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        s0, s1, s2 = _update_block(th_ptr, m_ptr, v_ptr, g_ptr, M_ptr, offs,
                                   total, seed, noise_std, mom_decay, grad_lr,
                                   pos_c, alpha)
        tl.store(part_ptr + pid * 3 + 0, s0)
        tl.store(part_ptr + pid * 3 + 1, s1)
        tl.store(part_ptr + pid * 3 + 2, s2)

    @triton.jit
    def langevin_update_chains_kernel(th_ptr, m_ptr, v_ptr, g_ptr, M_ptr,
                                      part_ptr, seed_ptr, noise_ptr, T, total,
                                      mom_decay, grad_lr, pos_c, alpha,
                                      BLOCK: tl.constexpr):
        # grid (K, T // BLOCK): program (k, b) owns block b of chain k.
        # Offsets are int32: the wrapper requires K·T < 2**31 (ResNet-20 at
        # K=8 is 2.2M elements), so k·T + offs cannot wrap.
        k = tl.program_id(0)
        blk = tl.program_id(1)
        row = k * T
        offs = blk * BLOCK + tl.arange(0, BLOCK)
        seed = tl.load(seed_ptr + k)
        noise_std = tl.load(noise_ptr + k)
        s0, s1, s2 = _update_block(th_ptr + row, m_ptr + row, v_ptr + row,
                                   g_ptr + row, M_ptr + row, offs, total,
                                   seed, noise_std, mom_decay, grad_lr,
                                   pos_c, alpha)
        part = part_ptr + (k * tl.num_programs(1) + blk) * 3
        tl.store(part + 0, s0)
        tl.store(part + 1, s1)
        tl.store(part + 2, s2)

    _kernels = (langevin_update_kernel, langevin_update_chains_kernel)
    return _kernels


def _check(theta, momentum, square_avg, grads, precond, total, ndim):
    vecs = (theta, momentum, square_avg, grads, precond)
    shape = tuple(theta.shape)
    for a in vecs:
        if a.dtype != torch.float32:
            raise TypeError(f"fused_langevin_update takes float32, got {a.dtype}")
        if a.ndim != ndim or tuple(a.shape) != shape:
            raise ValueError(f"expected {ndim}-d state of shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError("fused_langevin_update takes contiguous vectors")
        if a.device != theta.device:
            raise ValueError(f"vectors on {a.device} and {theta.device}")
    T = shape[-1]
    if T % PACK_ALIGN or not 0 <= total <= T:
        raise ValueError(f"need T % {PACK_ALIGN} == 0 and total <= T "
                         f"(T={T}, total={total})")


def fused_langevin_update(theta, momentum, square_avg, grads, precond, seed,
                          coeffs, *, total: int):
    """One fused transition over packed float32 state vectors, IN PLACE.

    theta/momentum/square_avg/grads/precond: (T,) float32, contiguous, on one
    device, T % PACK_ALIGN == 0, zeros beyond `total`. θ, m and v are
    overwritten with θ', m', v' (the counterpart of the TPU kernel's
    `input_output_aliases`). seed: int in [0, 2**63) for the noise.
    coeffs: (mom_decay, grad_lr, noise_std, pos_c, alpha) host floats.
    Returns (theta, momentum, square_avg, partials) with partials a (3,)
    tensor [Σ Mg·m_old, Σ Mg·m_new, Σ Mg²] on the vectors' device.

    A CUDA tensor launches the Triton kernel; a CPU tensor goes to the plain
    version. Any other device, or anything the kernel does not take, raises.
    """
    global launches
    _check(theta, momentum, square_avg, grads, precond, total, 1)
    if theta.device.type == "cpu":
        return fused_langevin_update_reference(
            theta, momentum, square_avg, grads, precond, seed, coeffs,
            total=total)
    if theta.device.type != "cuda":
        raise ValueError(f"no kernel for device {theta.device}")
    kernel, _ = _build_kernels()
    T = theta.shape[0]
    n_blocks = T // BLOCK
    part = torch.empty((n_blocks, 3), dtype=torch.float32, device=theta.device)
    mom_decay, grad_lr, noise_std, pos_c, alpha = (float(c) for c in coeffs)
    kernel[(n_blocks,)](theta, momentum, square_avg, grads, precond, part,
                        int(total), int(seed), mom_decay, grad_lr, noise_std,
                        pos_c, alpha, BLOCK=BLOCK, num_warps=4)
    launches += 1
    return theta, momentum, square_avg, part.sum(dim=0)


def fused_langevin_update_reference(theta, momentum, square_avg, grads,
                                    precond, seed, coeffs, *, total: int,
                                    xi=None):
    """Plain PyTorch version of `fused_langevin_update`, same signature and
    the same in-place contract, any float dtype and device: the one-chain
    case of `fused_langevin_update_chains_reference`. `xi` injects the
    standard-normal noise (tests); otherwise it is drawn from a generator
    seeded with `seed` (other bits than the kernel's Philox stream)."""
    mom_decay, grad_lr, noise_std, pos_c, alpha = (float(c) for c in coeffs)
    *_, partials = fused_langevin_update_chains_reference(
        *(a[None] for a in (theta, momentum, square_avg, grads, precond)),
        torch.tensor([int(seed)]),
        torch.tensor([noise_std], dtype=theta.dtype, device=theta.device),
        (mom_decay, grad_lr, pos_c, alpha), total=total,
        xi=None if xi is None else xi[None])
    return theta, momentum, square_avg, partials[0]


def _check_chains(theta, seeds, noise_std):
    K, T = theta.shape
    if seeds.dtype != torch.int64 or tuple(seeds.shape) != (K,):
        raise ValueError(f"seeds must be ({K},) int64, got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if tuple(noise_std.shape) != (K,) or not noise_std.is_floating_point():
        raise ValueError(f"noise_std must be ({K},) float, got "
                         f"{noise_std.dtype} {tuple(noise_std.shape)}")
    for a in (seeds, noise_std):
        if a.device != theta.device or not a.is_contiguous():
            raise ValueError("seeds and noise_std must be contiguous, on the "
                             f"state's device {theta.device}")


def fused_langevin_update_chains(theta, momentum, square_avg, grads, precond,
                                 seeds, noise_std, coeffs, *, total: int):
    """One fused transition of K chains, IN PLACE, in one launch.

    theta/momentum/square_avg/grads/precond: (K, T) float32, contiguous, on
    one device, T % PACK_ALIGN == 0, zeros at index `total` and beyond in
    every row. seeds: (K,) int64 and noise_std: (K,) float32, on the same
    device (chain k's noise seed and σ; they stay on the device, so a step
    needs no host copy). coeffs: (mom_decay, grad_lr, pos_c, alpha) host
    floats shared by all chains. Returns (theta, momentum, square_avg,
    partials) with partials (K, 3): each chain's [Σ Mg·m_old, Σ Mg·m_new,
    Σ Mg²].

    Row k is bit for bit `fused_langevin_update` on row k with seed
    seeds[k] and noise_std[k]. A CUDA tensor launches the Triton kernel; a
    CPU tensor goes to the plain version; anything else raises."""
    global chain_launches
    _check(theta, momentum, square_avg, grads, precond, total, 2)
    _check_chains(theta, seeds, noise_std)
    if theta.device.type == "cpu":
        return fused_langevin_update_chains_reference(
            theta, momentum, square_avg, grads, precond, seeds, noise_std,
            coeffs, total=total)
    if theta.device.type != "cuda":
        raise ValueError(f"no kernel for device {theta.device}")
    if noise_std.dtype != torch.float32:
        raise TypeError(f"noise_std must be float32, got {noise_std.dtype}")
    K, T = theta.shape
    n_blocks = T // BLOCK
    if K * T >= 2 ** 31 or n_blocks >= 2 ** 16:
        raise ValueError(f"(K, T) = ({K}, {T}) overflows the kernel's int32 "
                         "offsets or its grid")
    _, kernel = _build_kernels()
    part = torch.empty((K, n_blocks, 3), dtype=torch.float32,
                       device=theta.device)
    mom_decay, grad_lr, pos_c, alpha = (float(c) for c in coeffs)
    kernel[(K, n_blocks)](theta, momentum, square_avg, grads, precond, part,
                          seeds, noise_std, T, int(total), mom_decay, grad_lr,
                          pos_c, alpha, BLOCK=BLOCK, num_warps=4)
    chain_launches += 1
    return theta, momentum, square_avg, part.sum(dim=1)


def fused_langevin_update_chains_reference(theta, momentum, square_avg, grads,
                                           precond, seeds, noise_std, coeffs,
                                           *, total: int, xi=None):
    """Plain PyTorch version of `fused_langevin_update_chains`, same
    signature and the same in-place contract, any float dtype and device.
    `xi` (K, T) injects the standard-normal noise (tests); otherwise row k
    is drawn from a generator on the state's device seeded with seeds[k]
    (other bits than the kernel's Philox stream)."""
    mom_decay, grad_lr, pos_c, alpha = (float(c) for c in coeffs)
    K, T = theta.shape
    dev, dt = theta.device, theta.dtype
    valid = torch.arange(T, device=dev) < total
    if xi is None:
        xi = torch.stack([
            torch.randn(T, dtype=dt, device=dev, generator=torch.Generator(
                device=dev).manual_seed(int(s))) for s in seeds.tolist()])
    zero = torch.zeros((), dtype=dt, device=dev)
    sigma = noise_std.to(dt)[:, None]
    xi = torch.where(valid, xi, zero)
    Mg = torch.where(valid, precond * grads, zero)
    m_old = torch.where(valid, momentum, zero)
    new_m = sigma * xi + grad_lr * Mg + mom_decay * m_old
    new_th = torch.where(valid, theta + pos_c * (precond * new_m), zero)
    new_v = torch.where(valid, alpha * square_avg + (1.0 - alpha) * grads * grads,
                        zero)
    partials = torch.stack([(Mg * m_old).sum(-1), (Mg * new_m).sum(-1),
                            (Mg * Mg).sum(-1)], dim=-1)
    theta.copy_(new_th)
    momentum.copy_(new_m)
    square_avg.copy_(new_v)
    return theta, momentum, square_avg, partials


__all__ = ("fused_langevin_update", "fused_langevin_update_reference",
           "fused_langevin_update_chains",
           "fused_langevin_update_chains_reference", "BLOCK")
