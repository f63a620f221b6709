"""Fused Langevin/GGMC parameter update: one CUDA C++ kernel for Hopper
(sm_90a), its plain PyTorch version, the wrappers that pick between them,
and the earlier Triton design kept for comparison.

Replaces the Pallas TPU kernel
`bnn_priors_tpu/ops/fused_update.py::_update_kernel` (wrapper
`fused_langevin_update`) in both of the forms the JAX package runs it in:
one chain's `(T,)` state (`fused_langevin_update`), and K chains' `(K, T)`
state, which the JAX package gets by `jax.vmap` of the same call
(`fused_langevin_update_chains`). One pass over the flat-packed chain state
(reads θ, m, v, g, M; writes θ', m', v' in place) computes

    ξ   ~ N(0, I)                 (Philox4x32-10 + Box–Muller, keyed by the
                                   seed and the element's index within its
                                   chain, drawn in registers, never stored)
    m'  = noise_std·ξ + grad_lr·(M·g) + mom_decay·m
    θ'  = θ + pos_c·(M·m')
    v'  = alpha·v + (1-alpha)·g²
    partials = [Σ (M·g)·m, Σ (M·g)·m', Σ (M·g)²]

The coefficients are runtime values, so one compiled kernel serves the SGLD
step and all three GGMC phases. Elements at index ≥ `total` (the Packer's
padding tail) are written as 0 and left out of the partials.

Design on the card (`csrc/fused_update.cu`, built by `_cuda_lib` with nvcc
at first use and called through ctypes). Both forms are ONE kernel, grid
(blocks_per_chain, K), and a call is ONE launch: each block writes its
three sums to a row of a cached scratch buffer and takes a ticket on its
chain's counter, and the block with the last ticket sums the chain's rows
in index order. No float atomics, so ΔE is bitwise the same run to run; no
second launch for the partials, no host sync. The noise of element i of a
chain is Box–Muller on the words of Philox4x32-10 with key = the 64-bit
seed and counter = (i // 4, 0, 0, 0): it depends neither on the grid nor on
K, so row k of a `(K, T)` launch is bit for bit a `(T,)` launch with chain
k's seed and noise_std, and the plain version draws the same stream
(`philox_normals`), so the kernel is held against it with the noise on.

Bound. The function must read 5 and write 3 f32 vectors: 32 B per element.
ResNet-20 (T = 273,408): 8.75 MB a chain, about 2.6 µs at the H100's
3.35 TB/s; K=8 chains 70 MB, about 21 µs.

The earlier design, two Triton kernels (one program per 1024 elements,
`tl.randn` noise, a second launch to sum the per-block rows), is
kept as `fused_langevin_update_triton` and `fused_langevin_update_chains_
triton` with their own launch counters. No path of the port calls them.
"""
from __future__ import annotations

import math

import torch

from ..mcmc.packing import PACK_ALIGN
from . import _cuda_lib

# Launches of the CUDA kernel since import (or since a caller reset them):
# `launches` counts the (T,) form, `chain_launches` the (K, T) form. Each
# wrapper adds one where it launches its kernel and nowhere else.
launches = 0
chain_launches = 0
# Launches of the earlier Triton kernels, likewise.
triton_launches = 0
triton_chain_launches = 0

# Blocks in flight per SM that the grid aims for (the grid is about this
# many times the SM count; each thread walks its chain in float4 steps).
WAVES = 4
MAX_CHAINS = 65535  # the grid's y dimension

# ----------------------------------------------------------------- noise --
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, x):
    """(hi, lo) 32-bit words of a·x for a < 2**32 and int64 x in [0, 2**32),
    exact in int64 by 16-bit halves of x"""
    xl, xh = x & 0xFFFF, x >> 16
    lo_p, hi_p = a * xl, a * xh                 # each < 2**48
    return ((hi_p + (lo_p >> 16)) >> 16,
            (lo_p + ((hi_p & 0xFFFF) << 16)) & _U32)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) in int64 torch arithmetic on
    broadcastable tensors (or ints) holding 32-bit words; returns the four
    output words as int64 tensors in [0, 2**32)"""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(x, dtype=torch.int64)
                              for x in (c0, c1, c2, c3, k0, k1))
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & _U32, (k1 + PHILOX_W1) & _U32
    return c0, c1, c2, c3


def philox_normals(seeds, T: int, dtype=torch.float32, device=None):
    """(K, T) standard normals of the kernel's stream: element i of row k is
    from Philox4x32-10 with key (seeds[k] & 0xffffffff, seeds[k] >> 32) and
    counter (i // 4, 0, 0, 0); the words (x0, x1) give elements 4j and
    4j + 1, (x2, x3) elements 4j + 2 and 4j + 3, by Box–Muller in the JAX
    kernel's form, computed in `dtype` (the kernel's float32 to a few ulps)"""
    device = seeds.device if device is None else device
    s = seeds.to(device=device, dtype=torch.int64)[:, None]
    j = torch.arange(T // 4, dtype=torch.int64, device=device)
    x0, x1, x2, x3 = philox4x32_10(j & _U32, j >> 32, 0, 0, s & _U32,
                                   (s >> 32) & _U32)
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=device)

    def box_muller(a, b):
        u1 = 1.0 - (a >> 8).to(dtype) * 2.0 ** -24   # (0, 1], exact
        u2 = (b >> 8).to(dtype) * 2.0 ** -24         # [0, 1), exact
        r = torch.sqrt(-2.0 * torch.log(u1))
        t = u2 * two_pi
        return r * torch.cos(t), r * torch.sin(t)
    n0, n1 = box_muller(x0, x1)
    n2, n3 = box_muller(x2, x3)
    return torch.stack([n0, n1, n2, n3], dim=-1).reshape(s.shape[0], T)


# ---------------------------------------------------------------- checks --
# The checks run on every call, so the common case is one pass of cheap
# tests; `_explain` finds and reports what failed.
_F32 = torch.float32
_I64 = torch.int64


def _explain(vecs, total, ndim):
    "raise the first reason the state vectors are refused"
    theta = vecs[0]
    shape = tuple(theta.shape)
    for a in vecs:
        if a.dtype != _F32:
            raise TypeError(f"fused_langevin_update takes float32, got {a.dtype}")
        if a.ndim != ndim or tuple(a.shape) != shape:
            raise ValueError(f"expected {ndim}-d state of shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError("fused_langevin_update takes contiguous vectors")
        if a.device != theta.device:
            raise ValueError(f"vectors on {a.device} and {theta.device}")
        if a.data_ptr() % 16:
            raise ValueError("fused_langevin_update takes 16-byte aligned "
                             "vectors (float4 loads)")
    raise ValueError(f"need T % {PACK_ALIGN} == 0 and total <= T "
                     f"(T={shape[-1]}, total={total})")


def _check(theta, momentum, square_avg, grads, precond, total, ndim):
    """float32, one shape of `ndim` dims, contiguous, one device, 16-byte
    aligned (a meta tensor's address is 0), T % PACK_ALIGN == 0, total ≤ T"""
    vecs = (theta, momentum, square_avg, grads, precond)
    shape, dev = theta.shape, theta.device
    for a in vecs:
        if (a.dtype is not _F32 or a.shape != shape or not a.is_contiguous()
                or a.device != dev or a.data_ptr() & 15):
            _explain(vecs, total, ndim)
    if len(shape) != ndim or shape[-1] % PACK_ALIGN or not 0 <= total <= shape[-1]:
        _explain(vecs, total, ndim)


def _check_chains(theta, seeds, noise_std):
    K, dev = theta.shape[0], theta.device
    if seeds.dtype is not _I64 or seeds.shape != (K,):
        raise ValueError(f"seeds must be ({K},) int64, got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if noise_std.shape != (K,) or not noise_std.is_floating_point():
        raise ValueError(f"noise_std must be ({K},) float, got "
                         f"{noise_std.dtype} {tuple(noise_std.shape)}")
    if (seeds.device != dev or noise_std.device != dev
            or not seeds.is_contiguous() or not noise_std.is_contiguous()):
        raise ValueError("seeds and noise_std must be contiguous, on the "
                         f"state's device {dev}")


def _check_card(theta):
    if theta.device.type != "cuda":
        raise ValueError(f"no kernel for device {theta.device}")


# ------------------------------------------------------- the CUDA kernel --
_scratch: dict = {}
_sm_count: dict = {}


def _grid_and_scratch(dev, K, T, stream):
    """blocks a chain, and the scratch rows and zeroed tickets of one
    (device, K, T, stream), made once and kept"""
    key = (dev.index, K, T, stream)
    hit = _scratch.get(key)
    if hit is None:
        sms = _sm_count.get(dev.index)
        if sms is None:
            sms = _sm_count[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        threads = _cuda_lib.load().bnn_fused_update_threads()
        nb = max(1, min(-(-(T // 4) // threads), -(-WAVES * sms // K)))
        hit = (nb, torch.empty(K * nb * 3, dtype=torch.float32, device=dev),
               torch.zeros(K, dtype=torch.int32, device=dev))
        _scratch[key] = hit
    return hit


def _launch(theta, momentum, square_avg, grads, precond, seeds, sigmas,
            seed, sigma, seed_offset, coeffs4, total):
    """one launch of the kernel on the tensors' device's current stream
    (which must be the current device); returns the fresh partials"""
    lib = _cuda_lib.lib or _cuda_lib.load()
    dev = theta.device
    K, T = (1, theta.shape[0]) if theta.ndim == 1 else theta.shape
    if not 1 <= K <= MAX_CHAINS:
        raise ValueError(f"K = {K} chains; the kernel takes 1..{MAX_CHAINS}")
    # the raw handle of torch.cuda.current_stream(dev), without making a
    # Stream object on every call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    nb, rows, tickets = _grid_and_scratch(dev, K, T, stream)
    partials = torch.empty((3,) if theta.ndim == 1 else (K, 3), dtype=_F32,
                           device=dev)
    mom_decay, grad_lr, pos_c, alpha = coeffs4
    rc = lib.bnn_fused_langevin_update(
        theta.data_ptr(), momentum.data_ptr(), square_avg.data_ptr(),
        grads.data_ptr(), precond.data_ptr(), rows.data_ptr(),
        tickets.data_ptr(), partials.data_ptr(),
        None if seeds is None else seeds.data_ptr(),
        None if sigmas is None else sigmas.data_ptr(),
        seed, sigma, seed_offset, K, T, total, nb, mom_decay, grad_lr, pos_c,
        alpha, dev.index, stream)
    if rc:
        raise RuntimeError(f"fused_langevin_update launch on {dev} failed: "
                           f"CUDA error {rc} "
                           f"({lib.bnn_cuda_error_string(rc).decode()})")
    return partials


def fused_langevin_update(theta, momentum, square_avg, grads, precond, seed,
                          coeffs, *, total: int):
    """One fused transition over packed float32 state vectors, IN PLACE.

    theta/momentum/square_avg/grads/precond: (T,) float32, contiguous,
    16-byte aligned, on one device, T % PACK_ALIGN == 0, zeros beyond
    `total`. θ, m and v are overwritten with θ', m', v' (the counterpart of
    the TPU kernel's `input_output_aliases`). seed: int in [0, 2**63) for
    the noise. coeffs: (mom_decay, grad_lr, noise_std, pos_c, alpha) host
    floats. Returns (theta, momentum, square_avg, partials) with partials a
    fresh (3,) tensor [Σ Mg·m_old, Σ Mg·m_new, Σ Mg²] on the vectors'
    device.

    A CUDA tensor launches the CUDA kernel; a CPU tensor goes to the plain
    version. Any other device, or anything the kernel does not take, raises.
    """
    global launches
    _check(theta, momentum, square_avg, grads, precond, total, 1)
    if theta.device.type == "cpu":
        return fused_langevin_update_reference(
            theta, momentum, square_avg, grads, precond, seed, coeffs,
            total=total)
    _check_card(theta)
    mom_decay, grad_lr, noise_std, pos_c, alpha = coeffs
    partials = _launch(theta, momentum, square_avg, grads, precond, None, None,
                       int(seed), float(noise_std), 0,
                       (float(mom_decay), float(grad_lr), float(pos_c),
                        float(alpha)), int(total))
    launches += 1
    return theta, momentum, square_avg, partials


def fused_langevin_update_reference(theta, momentum, square_avg, grads,
                                    precond, seed, coeffs, *, total: int,
                                    xi=None):
    """Plain PyTorch version of `fused_langevin_update`, same signature and
    the same in-place contract, any float dtype and device: the one-chain
    case of `fused_langevin_update_chains_reference`. `xi` injects the
    standard-normal noise (tests); otherwise it is the kernel's stream for
    `seed` (`philox_normals`)."""
    mom_decay, grad_lr, noise_std, pos_c, alpha = (float(c) for c in coeffs)
    *_, partials = fused_langevin_update_chains_reference(
        *(a[None] for a in (theta, momentum, square_avg, grads, precond)),
        torch.tensor([int(seed)], device=theta.device),
        torch.tensor([noise_std], dtype=theta.dtype, device=theta.device),
        (mom_decay, grad_lr, pos_c, alpha), total=total,
        xi=None if xi is None else xi[None])
    return theta, momentum, square_avg, partials[0]


def fused_langevin_update_chains(theta, momentum, square_avg, grads, precond,
                                 seeds, noise_std, coeffs, *, total: int,
                                 seed_offset: int = 0):
    """One fused transition of K chains, IN PLACE, in one launch.

    theta/momentum/square_avg/grads/precond: (K, T) float32, contiguous,
    16-byte aligned, on one device, T % PACK_ALIGN == 0, zeros at index
    `total` and beyond in every row. seeds: (K,) int64 and noise_std: (K,)
    float32, on the same device (chain k's noise seed and σ; they stay on
    the device, so a step needs no host copy); chain k draws with seed
    seeds[k] + seed_offset. coeffs: (mom_decay, grad_lr, pos_c, alpha) host
    floats shared by all chains. Returns (theta, momentum, square_avg,
    partials) with partials a fresh (K, 3) tensor: each chain's
    [Σ Mg·m_old, Σ Mg·m_new, Σ Mg²].

    Row k is bit for bit `fused_langevin_update` on row k with seed
    seeds[k] + seed_offset and noise_std[k]. A CUDA tensor launches the
    CUDA kernel; a CPU tensor goes to the plain version; anything else
    raises."""
    global chain_launches
    _check(theta, momentum, square_avg, grads, precond, total, 2)
    _check_chains(theta, seeds, noise_std)
    if theta.device.type == "cpu":
        return fused_langevin_update_chains_reference(
            theta, momentum, square_avg, grads, precond, seeds, noise_std,
            coeffs, total=total, seed_offset=seed_offset)
    _check_card(theta)
    if noise_std.dtype != torch.float32:
        raise TypeError(f"noise_std must be float32, got {noise_std.dtype}")
    partials = _launch(theta, momentum, square_avg, grads, precond, seeds,
                       noise_std, 0, 0.0, int(seed_offset),
                       tuple(float(c) for c in coeffs), int(total))
    chain_launches += 1
    return theta, momentum, square_avg, partials


def fused_langevin_update_chains_reference(theta, momentum, square_avg, grads,
                                           precond, seeds, noise_std, coeffs,
                                           *, total: int, seed_offset: int = 0,
                                           xi=None):
    """Plain PyTorch version of `fused_langevin_update_chains`, same
    signature and the same in-place contract, any float dtype and device.
    `xi` (K, T) injects the standard-normal noise (tests); otherwise row k
    is the kernel's stream for seeds[k] + seed_offset (`philox_normals`,
    in the state's dtype)."""
    mom_decay, grad_lr, pos_c, alpha = (float(c) for c in coeffs)
    K, T = theta.shape
    dev, dt = theta.device, theta.dtype
    valid = torch.arange(T, device=dev) < total
    if xi is None:
        xi = philox_normals(seeds.to(dev) + int(seed_offset), T, dt, dev)
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


# ------------------------------------- the earlier design: Triton kernels --
# Elements per Triton program. T % PACK_ALIGN == 0, so BLOCK divides T.
BLOCK = 1024

_triton_kernels = None


def _build_triton_kernels():
    "compile-on-first-use: triton is imported only where a kernel launches"
    global _triton_kernels
    if _triton_kernels is not None:
        return _triton_kernels
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

    _triton_kernels = (langevin_update_kernel, langevin_update_chains_kernel)
    return _triton_kernels


def fused_langevin_update_triton(theta, momentum, square_avg, grads, precond,
                                 seed, coeffs, *, total: int):
    """The earlier design of `fused_langevin_update`, same signature and
    contract, but its own noise stream (`tl.randn`), so it agrees with the
    plain version at noise_std = 0 only. A CPU tensor goes to the plain
    version."""
    global triton_launches
    _check(theta, momentum, square_avg, grads, precond, total, 1)
    if theta.device.type == "cpu":
        return fused_langevin_update_reference(
            theta, momentum, square_avg, grads, precond, seed, coeffs,
            total=total)
    _check_card(theta)
    kernel, _ = _build_triton_kernels()
    T = theta.shape[0]
    n_blocks = T // BLOCK
    part = torch.empty((n_blocks, 3), dtype=torch.float32, device=theta.device)
    mom_decay, grad_lr, noise_std, pos_c, alpha = (float(c) for c in coeffs)
    kernel[(n_blocks,)](theta, momentum, square_avg, grads, precond, part,
                        int(total), int(seed), mom_decay, grad_lr, noise_std,
                        pos_c, alpha, BLOCK=BLOCK, num_warps=4)
    triton_launches += 1
    return theta, momentum, square_avg, part.sum(dim=0)


def fused_langevin_update_chains_triton(theta, momentum, square_avg, grads,
                                        precond, seeds, noise_std, coeffs, *,
                                        total: int, seed_offset: int = 0):
    """The earlier design of `fused_langevin_update_chains`, same signature
    and contract; its noise is `tl.randn`'s. A non-zero seed_offset costs
    one more launch (seeds + seed_offset on the device)."""
    global triton_chain_launches
    _check(theta, momentum, square_avg, grads, precond, total, 2)
    _check_chains(theta, seeds, noise_std)
    if theta.device.type == "cpu":
        return fused_langevin_update_chains_reference(
            theta, momentum, square_avg, grads, precond, seeds, noise_std,
            coeffs, total=total, seed_offset=seed_offset)
    _check_card(theta)
    if noise_std.dtype != torch.float32:
        raise TypeError(f"noise_std must be float32, got {noise_std.dtype}")
    K, T = theta.shape
    n_blocks = T // BLOCK
    if K * T >= 2 ** 31 or n_blocks >= 2 ** 16:
        raise ValueError(f"(K, T) = ({K}, {T}) overflows the kernel's int32 "
                         "offsets or its grid")
    _, kernel = _build_triton_kernels()
    if seed_offset:
        seeds = seeds + int(seed_offset)
    part = torch.empty((K, n_blocks, 3), dtype=torch.float32,
                       device=theta.device)
    mom_decay, grad_lr, pos_c, alpha = (float(c) for c in coeffs)
    kernel[(K, n_blocks)](theta, momentum, square_avg, grads, precond, part,
                          seeds, noise_std, T, int(total), mom_decay, grad_lr,
                          pos_c, alpha, BLOCK=BLOCK, num_warps=4)
    triton_chain_launches += 1
    return theta, momentum, square_avg, part.sum(dim=1)


__all__ = ("fused_langevin_update", "fused_langevin_update_reference",
           "fused_langevin_update_chains",
           "fused_langevin_update_chains_reference", "philox4x32_10",
           "philox_normals", "fused_langevin_update_triton",
           "fused_langevin_update_chains_triton")
