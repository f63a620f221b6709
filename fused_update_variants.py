#!/usr/bin/env python3
"""Where the fused update kernel's device time goes, on one NVIDIA GPU.

    python3 fused_update_variants.py

Builds variants of `bnn_priors_tpu_torch/csrc/fused_update.cu` by text
substitution (into build/variants/, one nvcc each, all at once) and times
each with the profiler at the main path's shapes (ResNet-20's T = 273,408,
one chain and K = 8), hot (the state left in L2 by the previous call) and
cold (128 MB written between calls), beside the earlier Triton kernel.
Two rounds, in the same order. The variants:

  as_is      the kernel as it is
  no_tail    each block writes its row of sums and stops: no fence, no
             ticket, no final sum (partials not written)
  no_ticket  the row and the fence, but no ticket (partials not written)
  no_fence   the ticket without the fence before it
  no_reads   the last block does not read the rows (partials wrong)
  unroll2    two float4 steps a thread per loop turn, ten loads first
  stcs       streaming (evict-first) stores of θ', m', v'
  t128, t512 128 or 512 threads a block instead of 256

Only `as_is` is right; the others exist to price one part of the kernel.
As a yardstick of the memory rate it also times `torch.add(a, b, out=c)`
moving the K=8 form's 70 MB (two reads, one write of 23.3 MB each). It
prints the card's name and power limit, then one line per variant.
"""
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from bnn_priors_tpu_torch.ops import _cuda_lib
from bnn_priors_tpu_torch.ops import fused_update as fu

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                   "variants")


def variant_sources():
    with open(_cuda_lib.SOURCE) as f:
        src = f.read()
    fence_ticket = ("    __threadfence();\n"
                    "    is_last = atomicAdd(tickets + k, 1u) == nb - 1;")
    reads = src[src.index("  for (unsigned int b = threadIdx.x; b < nb;"):
                src.index("  s = block_sum(acc, warp_part);\n  if")]
    loop = src[src.index("  for (int64_t q = static_cast<int64_t>"):
               src.index("  // this block's row")]
    stores = "  p.th[q] = o_th;\n  p.m[q] = o_m;\n  p.v[q] = o_v;\n"
    threads = "constexpr int kThreads = 256;"
    for part in (fence_ticket, stores, threads):
        assert part in src, part
    unroll2 = """  int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; q + stride < n4; q += 2 * stride) {
    const Step a = load_step(p, q), b = load_step(p, q + stride);
    update_step(p, a, q, total, k0, k1, c, acc);
    update_step(p, b, q + stride, total, k0, k1, c, acc);
  }
  if (q < n4) update_step(p, load_step(p, q), q, total, k0, k1, c, acc);

"""
    return {
        "as_is": src,
        "no_tail": src.replace(fence_ticket, "    is_last = false;"),
        "no_ticket": src.replace(fence_ticket,
                                 "    __threadfence();\n    is_last = false;"),
        "no_fence": src.replace(fence_ticket, fence_ticket.split("\n")[1]),
        "no_reads": src.replace(reads, ""),
        "unroll2": src.replace(loop, unroll2),
        "stcs": src.replace(stores, "  __stcs(p.th + q, o_th);\n"
                            "  __stcs(p.m + q, o_m);\n"
                            "  __stcs(p.v + q, o_v);\n"),
        "t128": src.replace(threads, threads.replace("256", "128")),
        "t512": src.replace(threads, threads.replace("256", "512")),
    }


def build_all(sources):
    "one nvcc a variant, all started together; returns {name: CDLL}"
    nvcc = _cuda_lib.find_nvcc()
    os.makedirs(OUT, exist_ok=True)

    def build(name):
        cu, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
        with open(cu, "w") as f:
            f.write(sources[name])
        r = subprocess.run([nvcc, *_cuda_lib.NVCC_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{r.stderr}")
        return name, _cuda_lib.bind(ctypes.CDLL(so))
    with ThreadPoolExecutor(len(sources)) as ex:
        return dict(ex.map(build, sources))


def main():
    if not torch.cuda.is_available():
        print("fused_update_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all(variant_sources())
    print(cs.card_line())
    gen = torch.Generator().manual_seed(0)
    T, total, K = 273408, 272474, cs.K_CHAINS
    one = cs.kernel_inputs(T, total, gen)
    bank = cs.chain_kernel_inputs(K, T, total, gen)
    seeds = cs.chain_seeds(K)
    sigma = torch.linspace(0.1, 1.0, K, device="cuda")
    mom_decay, grad_lr, _, pos_c, alpha = cs.coefficient_sets(
        0.01, cs.N_TRAIN, 0.994, 0.99)["ggmc_mid"]
    c5, c4 = (mom_decay, grad_lr, 0.5, pos_c, alpha), (mom_decay, grad_lr,
                                                       pos_c, alpha)
    forms = {
        "(T,)": (lambda: fu.fused_langevin_update(*one, 7, c5, total=total),
                 lambda: fu.fused_langevin_update_triton(*one, 7, c5,
                                                         total=total)),
        f"(K, T) K={K}": (
            lambda: fu.fused_langevin_update_chains(*bank, seeds, sigma, c4,
                                                    total=total),
            lambda: fu.fused_langevin_update_chains_triton(
                *bank, seeds, sigma, c4, total=total)),
    }
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def cold(fn):
        def run():
            flush.zero_()
            fn()
        return run
    fmt = lambda x: "not measured" if x is None else f"{x:6.2f} us"

    def line(label, fn):
        match = "langevin_update" if "torch.add" not in label else "Functor_add"
        hot, _ = cs.device_us(fn, match, n=50)
        cld, _ = cs.device_us(cold(fn), match, n=50)
        print(f"{label:28s} device a launch: hot {fmt(hot)}, cold {fmt(cld)}",
              flush=True)
    n = 32 * K * T // 12
    a, b, out = (torch.randn(n, device="cuda") for _ in range(3))
    for rnd in (1, 2):
        line(f"round {rnd} torch.add 70 MB", lambda: torch.add(a, b, out=out))
        for form, (cuda, triton) in forms.items():
            line(f"round {rnd} {form} triton", triton)
            for name, lib in libs.items():
                _cuda_lib.lib = lib
                fu._scratch.clear()
                line(f"round {rnd} {form} {name}", cuda)
    return 0


if __name__ == "__main__":
    sys.exit(main())
