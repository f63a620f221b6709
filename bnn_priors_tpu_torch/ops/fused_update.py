"""Fused Langevin/GGMC parameter update: a Triton kernel for Hopper (sm_90a),
its plain PyTorch version, and the wrapper that picks between them.

Replaces the Pallas TPU kernel
`bnn_priors_tpu/ops/fused_update.py::_update_kernel` (wrapper
`fused_langevin_update`). One pass over the flat-packed chain state
(reads θ, m, v, g, M; writes θ', m', v' in place) computes

    ξ   ~ N(0, I)                 (Philox normals keyed by the global element
                                   index, drawn in registers, never stored)
    m'  = noise_std·ξ + grad_lr·(M·g) + mom_decay·m
    θ'  = θ + pos_c·(M·m')
    v'  = alpha·v + (1-alpha)·g²
    partials = [Σ (M·g)·m, Σ (M·g)·m', Σ (M·g)²]

The five coefficients are plain host floats, so one compiled kernel serves
the SGLD step and all three GGMC phases. Elements at index ≥ `total` (the
Packer's padding tail) are written as 0 and left out of the partials.

Design on the card. The TPU kernel walks a sequential grid and keeps its
partial sums in one SMEM row per block; on Hopper the programs run in
parallel, so each program writes its three partial sums to its own row of a
`(n_blocks, 3)` buffer and a fixed-order sum over that buffer gives the
partials: no float atomics, so ΔE is reproducible run to run. The noise is
keyed by the element index, not the block, so it does not depend on BLOCK.

Bound. The function must read 5 and write 3 f32 vectors: 32 B per element,
8.75 MB per call for ResNet-20 (T = 273,408), about 2.6 µs at the H100's
3.35 TB/s. At that size launch latency dominates. The design's answer is one
pass: the noise is never stored and the partials are never re-read.
Making the call itself cheaper (CUDA graphs, fusing into the gradient's
last kernel) is later work.
"""
from __future__ import annotations

import torch

from ..mcmc.packing import PACK_ALIGN

# Elements per program. T % PACK_ALIGN == 0, so BLOCK divides T exactly.
BLOCK = 1024

# Launches of the Triton kernel since import (or since a caller reset it).
# The wrapper adds one where it launches the kernel and nowhere else.
launches = 0

_kernel = None


def _build_kernel():
    "compile-on-first-use: triton is imported only where a kernel launches"
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    # the seed changes every call: keep it out of the specialisation key
    @triton.jit(do_not_specialize=["seed"])
    def langevin_update_kernel(th_ptr, m_ptr, v_ptr, g_ptr, M_ptr, part_ptr,
                               total, seed, mom_decay, grad_lr, noise_std,
                               pos_c, alpha, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
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
        tl.store(part_ptr + pid * 3 + 0, tl.sum(Mg * m_old, axis=0))
        tl.store(part_ptr + pid * 3 + 1, tl.sum(Mg * new_m, axis=0))
        tl.store(part_ptr + pid * 3 + 2, tl.sum(Mg * Mg, axis=0))

    _kernel = langevin_update_kernel
    return _kernel


def _check(theta, momentum, square_avg, grads, precond, total):
    vecs = (theta, momentum, square_avg, grads, precond)
    T = theta.shape[0]
    for a in vecs:
        if a.dtype != torch.float32:
            raise TypeError(f"fused_langevin_update takes float32, got {a.dtype}")
        if a.ndim != 1 or a.shape[0] != T:
            raise ValueError(f"expected ({T},) vectors, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError("fused_langevin_update takes contiguous vectors")
        if a.device != theta.device:
            raise ValueError(f"vectors on {a.device} and {theta.device}")
    if T % PACK_ALIGN or not 0 <= total <= T:
        raise ValueError(f"need T % {PACK_ALIGN} == 0 and total <= T "
                         f"(T={T}, total={total})")


def fused_langevin_update(theta, momentum, square_avg, grads, precond, seed,
                          coeffs, *, total: int):
    """One fused transition over packed float32 state vectors, IN PLACE.

    theta/momentum/square_avg/grads/precond: (T,) float32, contiguous, on one
    device, T % PACK_ALIGN == 0, zeros beyond `total`. θ, m and v are
    overwritten with θ', m', v' (the counterpart of the TPU kernel's
    `input_output_aliases`). seed: int in [0, 2**31) for the noise.
    coeffs: (mom_decay, grad_lr, noise_std, pos_c, alpha) host floats.
    Returns (theta, momentum, square_avg, partials) with partials a (3,)
    tensor [Σ Mg·m_old, Σ Mg·m_new, Σ Mg²] on the vectors' device.

    A CUDA tensor launches the Triton kernel; a CPU tensor goes to the plain
    version. Any other device, or anything the kernel does not take, raises.
    """
    global launches
    _check(theta, momentum, square_avg, grads, precond, total)
    if theta.device.type == "cpu":
        return fused_langevin_update_reference(
            theta, momentum, square_avg, grads, precond, seed, coeffs,
            total=total)
    if theta.device.type != "cuda":
        raise ValueError(f"no kernel for device {theta.device}")
    kernel = _build_kernel()
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
    the same in-place contract, any float dtype and device. `xi` injects the
    standard-normal noise (tests); otherwise it is drawn from a generator
    seeded with `seed` (other bits than the kernel's Philox stream)."""
    mom_decay, grad_lr, noise_std, pos_c, alpha = (float(c) for c in coeffs)
    T = theta.shape[0]
    valid = torch.arange(T, device=theta.device) < total
    if xi is None:
        gen = torch.Generator(device=theta.device).manual_seed(int(seed))
        xi = torch.randn(T, generator=gen, dtype=theta.dtype,
                         device=theta.device)
    zero = torch.zeros((), dtype=theta.dtype, device=theta.device)
    xi = torch.where(valid, xi, zero)
    Mg = torch.where(valid, precond * grads, zero)
    m_old = torch.where(valid, momentum, zero)
    new_m = noise_std * xi + grad_lr * Mg + mom_decay * m_old
    new_th = torch.where(valid, theta + pos_c * (precond * new_m), zero)
    new_v = torch.where(valid, alpha * square_avg + (1.0 - alpha) * grads * grads,
                        zero)
    partials = torch.stack([(Mg * m_old).sum(), (Mg * new_m).sum(),
                            (Mg * Mg).sum()])
    theta.copy_(new_th)
    momentum.copy_(new_m)
    square_avg.copy_(new_v)
    return theta, momentum, square_avg, partials


__all__ = ("fused_langevin_update", "fused_langevin_update_reference",
           "BLOCK")
