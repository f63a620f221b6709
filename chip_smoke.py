#!/usr/bin/env python3
"""Run the PyTorch port (`bnn_priors_tpu_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

0. set-up: a CUDA card must be present; prints the card's name and power
   limit, and turns TF32 off for matmuls and cuDNN convolutions, so float32
   means float32 throughout. Builds the CUDA kernel
   (`bnn_priors_tpu_torch/csrc/fused_update.cu`, nvcc for sm_90a into
   build/kernels/) and prints ptxas's registers, shared memory and spills.
1. the CUDA kernel's `(T,)` form `fused_langevin_update` against its plain
   PyTorch version on the card, at ResNet-20's packed length (T=273,408,
   total=272,474) and at a ragged T=70,656 (total=70,000), for the SGLD step
   and the three GGMC phases: at noise_std=0 (θ, m, v within atol 1e-6,
   partials within rtol 1e-4) and at noise_std=1, where the plain version
   draws the kernel's Philox stream (θ, m, v within atol 1e-5: ulps of
   logf, sinf and cosf; partials within rtol 1e-4); padding tails exactly
   0; partials bitwise equal over 10 repeats of one launch; then its noise
   over 2^20 elements (mean, std, KS test; same seed bitwise equal, new seed
   different); then the earlier Triton kernel against the plain version at
   noise_std=0, and the two in turns (Triton, CUDA, CUDA, Triton): a call
   (CUDA events around one call, median of 100), back to back (events
   around 100 calls / 100), device time a launch (profiler) and host
   enqueue time a call (perf_counter around 1,000 calls before one sync);
   and the plain version's call time.
2. the main path: `get_data("fake_cifar10")`, `get_model("googleresnet")`
   at full width and depth 20, `he_initialize`, then
   `VerletSGLDRunnerReject(...).run()` — GGMC with exact full-data
   gradients and an M-H test at the sampling boundary. n_train is cut from
   50,000 to 5,000 for time. The CUDA kernel's launch count over the run
   must equal the count the protocol implies (every transition went
   through it), and the Triton kernels must not launch.
3. a reference check: the same runner at temperature 0 on a small input, on
   the card in float32 (kernel) and on the CPU in float64 (plain version),
   must agree.
4. the main path's time per minibatch step (CUDA events), with the CUDA
   kernel and with the Triton wrapper assigned in its place, in turns; then
   a torch.profiler window over the same steps: device time per step, the
   device's busy share and the kernels that take it; then the step's time
   in bf16 compute.
5. the `(K, T)` chain form `fused_langevin_update_chains` against its plain
   version on the card, at K=8 chains of ResNet-20's T and of the ragged T,
   for the same four coefficient sets with every chain's noise_std 0
   (atol 1e-6) and with per-chain noise_std on (atol 1e-5); partials within
   rtol 1e-4, tails exactly 0, partials bitwise over 10 repeats; then row k
   of a (K, T) launch against a (T,) launch with chain k's seed, noise_std
   and inputs (θ, m, v bit for bit); then the noise of 8 chains over 2^20
   draws each (|corr| < 5e-3 between every two chains, mean, std and KS per
   chain); then the Triton chain kernel at noise_std=0, the two timed in
   turns as in phase 1, K (T,) launches and the plain version.
6. the chain axis: `MultiChainRunnerReject` with K=8 chains of full-width
   ResNet-20 at per-chain temperatures, bf16 compute, batch 128 a chain,
   one cycle of 2 epochs (1 warmup, 1 sampling) on the same cut data. The
   (K, T) kernel's launch count must equal the protocol's, the (T,) form
   and the Triton kernels must not launch; potentials finite, one (K,)
   decision at the boundary, a (1, K, ...) sample bank, per-chain test
   metrics in [0, 1].
7. a reference check of the chain axis: the K-chain runner at temperature
   0 on a small input, on the card in float32 (kernel) and on the CPU in
   float64 (plain version), must agree.
8. aggregate chain-steps/s (K × steps / time, CUDA events around 50
   minibatch steps) at K = 1, 4 and 8 in bf16, to set beside phase 4's
   single-chain steps, and at K=8 with the Triton chain wrapper assigned in
   the CUDA one's place, in turns; then a profiler window over K=8 chain
   steps: device busy share and the top kernels.

It prints one JSON line describing both kernel forms, then the card's name
and power limit, and as its last line {"ok": true, "device": {...}}.
"""
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_TRAIN, N_TEST = 5000, 1000  # cut from CIFAR-10's 50,000/10,000 for time
H100_BYTES_PER_S = 3.35e12    # HBM3 rate of one H100 SXM (data sheet)
H100_F32_OPS_PER_S = 67e12    # float32 rate outside the tensor cores
K_CHAINS = 8                  # the chain axis's bank on one card
CHAIN_TEMPS = [0.01, 0.1, 0.3, 1.0] * 2  # a tempering grid, twice
CU_SOURCE = "bnn_priors_tpu_torch/csrc/fused_update.cu"


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, n):
    "median ms of `n` calls, each between two CUDA events (after a warm-up)"
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def back_to_back_ms(fn, n=100):
    "ms a call of `n` calls between two CUDA events"
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def enqueue_us(fn, n=1000):
    "host µs a call: perf_counter around `n` calls, read before one sync"
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def device_us(fn, match, n=20):
    """profiler over `n` calls: µs of device time a launch of the kernels
    whose name holds `match`, and µs of all device time a call"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    hit = [e for e in ev if match in e.key]
    if not hit:
        return None, None
    return (sum(e.self_device_time_total for e in hit)
            / sum(e.count for e in hit),
            sum(e.self_device_time_total for e in ev) / n)


def compare_in_turns(label, fns):
    """the Triton and CUDA wrappers in turns (triton, cuda, cuda, triton):
    a call, back to back, device time a launch, host enqueue a call"""
    out = {"triton": [], "cuda": []}
    for route in ("triton", "cuda", "cuda", "triton"):
        fn = fns[route]
        dev, dev_call = device_us(fn, "langevin_update", n=50)
        m = {"call_ms": time_ms(fn, 100), "b2b_ms": back_to_back_ms(fn),
             "device_us": dev, "device_call_us": dev_call,
             "enqueue_us": enqueue_us(fn)}
        out[route].append(m)
        fmt = lambda x, f: "not measured" if x is None else format(x, f)
        print(f"{label} {route:6s}: a call {m['call_ms']:.4f} ms, back to "
              f"back {m['b2b_ms']:.4f} ms, device {fmt(dev, '.2f')} us a "
              f"launch ({fmt(dev_call, '.2f')} us a call), enqueue "
              f"{m['enqueue_us']:.2f} us a call")
    def mean(route, k):
        got = [m[k] for m in out[route] if m[k] is not None]
        return float(np.mean(got)) if got else None
    return {route: {k: mean(route, k) for k in out[route][0]}
            for route in out}, out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 0 --
def phase_build():
    "build the CUDA kernel from the checkout's source; print ptxas's report"
    from bnn_priors_tpu_torch.ops import _cuda_lib
    t0 = time.perf_counter()
    path = _cuda_lib.build()
    lib = _cuda_lib.load()
    print(f"build: {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s"
          f" ({' '.join(_cuda_lib.NVCC_FLAGS)}), {lib.bnn_fused_update_threads()}"
          " threads a block")
    report = [ln.strip() for ln in _cuda_lib.build_log().splitlines()
              if "ptxas" in ln]
    for ln in report:
        print("build:", ln)
    check(any("registers" in ln for ln in report), "no ptxas report")


# ---------------------------------------------------------------- phase 1 --
def kernel_inputs(T, total, gen):
    "random packed state on the card, O(1) values, zero padding tail"
    dev = "cuda"
    mk = lambda: torch.randn(T, generator=gen).to(dev)
    mask = (torch.arange(T) < total).to(dev, torch.float32)
    theta, m = mk() * mask, mk() * mask
    g = 0.05 * mk() * mask
    v = (mk().abs() + 0.1) * mask
    # leaf-constant preconditioner: 40 leaves of ragged sizes
    bounds = torch.linspace(0, total, 41).long()
    M = torch.ones(T)
    for i in range(40):
        M[bounds[i]:bounds[i + 1]] = 0.5 + torch.rand((), generator=gen)
    return theta, m, v, g, M.to(dev)


def coefficient_sets(lr, N, a, alpha):
    "SGLD mid step and the three GGMC phases, noise_std forced to 0"
    from bnn_priors_tpu_torch.mcmc import VerletSGLD
    k = VerletSGLD(num_data=N, momentum=a, rmsprop_alpha=alpha)
    out = {"sgld_mid": (a, -math.sqrt(lr * N), 0.0, math.sqrt(lr / N),
                        alpha)}
    for kind in ("initial", "mid", "final"):
        bh, bhn, mom_decay, grad_v, _ = k._constants(lr, 1.0, kind)
        final = kind == "final"
        out["ggmc_" + kind] = (mom_decay, -0.5 * grad_v * bhn, 0.0,
                               0.0 if final else bh, 1.0 if final else alpha)
    return out


def with_sigma(coeffs, sigma):
    return coeffs[:2] + (sigma,) + coeffs[3:]


def compare_to_plain(label, ker, ref, pk, pr, total, atol, tails):
    "θ, m, v within atol, padding tails 0, partials within rtol 1e-4"
    torch.cuda.synchronize()
    errs = []
    for i, what in enumerate(("theta", "momentum", "square_avg")):
        err = float((ker[i] - ref[i]).abs().max())
        check(err <= atol, f"{label}: {what} off by {err} (atol {atol})")
        check(bool((tails(ker[i]) == 0).all()),
              f"{label}: {what} padding tail not zero")
        errs.append(err)
    rel = float(((pk - pr).abs() / pr.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-4, f"{label}: partials {pk} vs {pr}")
    return max(errs), rel


def phase_kernel(fu):
    import scipy.stats
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for T, total in ((273408, 272474), (70656, 70000)):
        base = kernel_inputs(T, total, gen)
        for name, coeffs in coefficient_sets(0.01, N_TRAIN, 0.994,
                                             0.99).items():
            for sigma, atol in ((0.0, 1e-6), (1.0, 1e-5)):
                c = with_sigma(coeffs, sigma)
                ker = [t.clone() for t in base]
                ref = [t.clone() for t in base]
                *_, pk = fu.fused_langevin_update(*ker, 1234, c, total=total)
                *_, pr = fu.fused_langevin_update_reference(*ref, 1234, c,
                                                            total=total)
                err, rel = compare_to_plain(
                    f"{name} T={T} sigma={sigma}", ker, ref, pk, pr, total,
                    atol, lambda t: t[total:])
                if T == 273408:
                    max_err = max(max_err, err)
                print(f"kernel == plain: {name:13s} T={T:6d} total={total:6d}"
                      f" sigma={sigma}: max |d| {err:.2e}, partials rel err "
                      f"{rel:.2e}")

    # the partials are the same, bit for bit, launch after launch
    T, total = 273408, 272474
    base = kernel_inputs(T, total, gen)
    c = with_sigma(coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"],
                   1.0)
    parts = []
    for _ in range(10):
        *_, p = fu.fused_langevin_update(*[t.clone() for t in base], 99, c,
                                         total=total)
        parts.append(p)
    check(all(torch.equal(parts[0], p) for p in parts),
          f"partials differ between repeats: {parts}")
    print(f"kernel: partials bitwise equal over 10 launches: {parts[0]}")

    # noise: mom_decay = grad_lr = 0, noise_std = 1 ⇒ m' = ξ
    T = 1 << 20
    z = lambda: torch.zeros(T, device="cuda")
    o = lambda: torch.ones(T, device="cuda")
    draws = []
    for seed in (123, 123, 456):
        m = z()
        fu.fused_langevin_update(z(), m, o(), z(), o(), seed,
                                 (0.0, 0.0, 1.0, 0.0, 1.0), total=T)
        draws.append(m.cpu().numpy())
    xi = draws[0]
    ks = scipy.stats.kstest(xi[::16], "norm").pvalue
    print(f"noise: mean {xi.mean():.2e} std {xi.std():.6f} KS p {ks:.3f}")
    check(abs(xi.mean()) < 5e-3 and abs(xi.std() - 1.0) < 5e-3,
          "noise moments")
    check(ks > 1e-3, f"noise KS p = {ks}")
    check(np.array_equal(draws[0], draws[1]), "same seed, other draws")
    check(not np.array_equal(draws[0], draws[2]), "new seed, same draws")

    # the earlier design: right at noise_std = 0, then both timed in turns
    T, total = 273408, 272474
    base = kernel_inputs(T, total, gen)
    coeffs = coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"]
    ker = [t.clone() for t in base]
    ref = [t.clone() for t in base]
    *_, pk = fu.fused_langevin_update_triton(*ker, 5, coeffs, total=total)
    *_, pr = fu.fused_langevin_update_reference(*ref, 5, coeffs, total=total)
    err, _ = compare_to_plain("triton (T,)", ker, ref, pk, pr, total, 1e-6,
                              lambda t: t[total:])
    print(f"triton (T,) == plain at noise_std=0: max |d| {err:.2e}")
    c = with_sigma(coeffs, 0.5)
    vecs = kernel_inputs(T, total, gen)
    means, _ = compare_in_turns("(T,)", {
        "triton": lambda: fu.fused_langevin_update_triton(*vecs, 7, c,
                                                          total=total),
        "cuda": lambda: fu.fused_langevin_update(*vecs, 7, c, total=total)})
    plain_ms = time_ms(lambda: fu.fused_langevin_update_reference(
        *vecs, 7, c, total=total), 100)
    # bytes: read θ, m, v, g, M, write θ', m', v' (f32); ops: ~14 a element
    bound_ms = 1e3 * max(32 * T / H100_BYTES_PER_S,
                         14 * T / H100_F32_OPS_PER_S)
    print(f"(T,) cuda {means['cuda']['call_ms']:.4f} ms a call, triton "
          f"{means['triton']['call_ms']:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms (32 B x {T})")
    return {"max_abs_err": max_err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, **means}


# ---------------------------------------------------------------- phase 2 --
def make_runner(data, model, device, **kw):
    from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
    args = dict(batch_size=128, learning_rate=0.01, momentum=0.994,
                temperature=1.0, cycles=1, epochs_per_cycle=2,
                warmup_epochs=1, sample_epochs=1, precond_update=1,
                reject_samples=True, seed=0)
    args.update(kw)
    return VerletSGLDRunnerReject(model, data.norm.train, data.norm.test,
                                  device=device, **args)


def reset_counts(fu):
    fu.launches = fu.chain_launches = 0
    fu.triton_launches = fu.triton_chain_launches = 0


def phase_main_path(fu):
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    print(f"main path: fake_cifar10 n_train={N_TRAIN} (cut from 50,000 for "
          f"time), n_test={N_TEST}; googleresnet depth 20, batch 128")
    data = get_data("fake_cifar10", n_train=N_TRAIN, n_test=N_TEST)
    model = get_model("googleresnet", weight_prior="gaussian",
                      weight_scale=2 ** 0.5)
    he_initialize(model, torch.Generator().manual_seed(0))
    runner = make_runner(data, model, "cuda")
    pk = runner.kernel.packer
    check((pk.n_leaves, pk.total, pk.total_padded) == (65, 272474, 273408),
          f"ResNet-20 packing {pk.n_leaves} {pk.total} {pk.total_padded}")
    n_boundaries = sum(runner._is_sampling_epoch(e)
                       for e in range(runner.epochs_per_cycle))
    expected = (1 + runner.steps_per_epoch * runner.epochs_per_cycle
                * runner.cycles + 2 * n_boundaries * runner.cycles)

    reset_counts(fu)
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, chain = fu.launches, fu.chain_launches
    triton = fu.triton_launches + fu.triton_chain_launches

    pots = np.asarray(runner.potentials)
    check(len(pots) == runner.steps_per_epoch * runner.epochs_per_cycle
          and np.all(np.isfinite(pots)), "minibatch potentials")
    check(len(runner.boundaries) == n_boundaries == 1,
          f"M-H decisions {runner.boundaries}")
    b = runner.boundaries[0]
    check(math.isfinite(b["delta_energy"]) and isinstance(b["rejected"], bool),
          f"boundary {b}")
    samples = runner.get_samples()
    check(all(v.shape[0] == 1 for v in samples.values())
          and set(samples) == set(model.state_dict()), "sample bank")
    check(all(np.all(np.isfinite(v)) for v in samples.values()),
          "sample values")
    ev = runner.last_eval
    check(0.0 <= ev["test/acc"] <= 1.0 and math.isfinite(ev["test/loss"]),
          f"test metrics {ev}")
    check(launches == expected and chain == 0 and triton == 0,
          f"kernel launches {launches} ((K, T) form {chain}, Triton "
          f"{triton}), protocol implies {expected}")
    print(f"main path ok in {wall:.1f} s: potentials {pots[0]:.4f} -> "
          f"{pots[-1]:.4f}, boundary dE {b['delta_energy']:.4f} rejected "
          f"{b['rejected']}, test acc {ev['test/acc']:.4f} loss "
          f"{ev['test/loss']:.4f}, CUDA kernel launches {launches} == "
          f"{expected}, Triton launches 0")
    return runner, launches


# ---------------------------------------------------------------- phase 3 --
def phase_reference():
    "T=0 run on a small input: card f32 (kernel) vs CPU f64 (plain version)"
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        data = get_data("fake_cifar10", n_train=80, n_test=16,
                        dtype="float64" if dtype == torch.float64
                        else "float32", device=device)
        model = get_model("googleresnet", dtype=dtype, device=device)
        he_initialize(model, torch.Generator().manual_seed(3))
        r = make_runner(data, model, device, batch_size=32, temperature=0.0,
                        learning_rate=1e-3)
        r.run()
        out[device] = (r.kernel.params_of(r.chain), r.potentials,
                       r.boundaries[0]["delta_energy"])
    (pc, potc, dec), (pr, potr, der) = out["cuda"], out["cpu"]
    err = max(float((pc[k].double().cpu() - pr[k]).abs().max()) for k in pr)
    check(err < 1e-3, f"card vs CPU params differ by {err}")
    check(np.allclose(potc, potr, rtol=1e-4, atol=1e-4),
          f"potentials {potc} vs {potr}")
    print(f"reference check ok: params max |card f32 - CPU f64| {err:.2e}, "
          f"boundary dE {dec:.6f} vs {der:.6f}")


# ---------------------------------------------------------------- phase 4 --
def phase_step_time(runner):
    "ms per minibatch step of the main path (gradient + fused update)"
    perm = torch.randperm(runner.N, device="cuda")
    B = runner.batch_size

    def steps(n):
        for i in range(n):
            runner._plain_step(perm[(i % runner.n_full) * B:
                                    (i % runner.n_full + 1) * B], i, 1.0)
    steps(5)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    n = 100
    a.record()
    steps(n)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def with_triton(fu, fn):
    """run fn() with the Triton wrappers assigned in the CUDA ones' place
    (the runners look the wrappers up in the module at every call)"""
    saved = fu.fused_langevin_update, fu.fused_langevin_update_chains
    fu.fused_langevin_update = fu.fused_langevin_update_triton
    fu.fused_langevin_update_chains = fu.fused_langevin_update_chains_triton
    try:
        return fn()
    finally:
        fu.fused_langevin_update, fu.fused_langevin_update_chains = saved


def steps_in_turns(fu, label, fn, unit):
    "fn() with the CUDA kernel and with the Triton one: cuda, triton, triton, cuda"
    res = {"cuda": [], "triton": []}
    for route in ("cuda", "triton", "triton", "cuda"):
        before = fu.triton_launches + fu.triton_chain_launches
        x = fn() if route == "cuda" else with_triton(fu, fn)
        used = fu.triton_launches + fu.triton_chain_launches - before
        check((used > 0) == (route == "triton"),
              f"{label}: {used} Triton launches in a {route} run")
        res[route].append(x)
        print(f"{label} with the {route} kernel: {x:.3f} {unit}")
    return {r: float(np.mean(v)) for r, v in res.items()}


def phase_profile(runner, step_ms, label="cuda", n=10):
    """device time of a window of minibatch steps, by kernel; the busy
    share is kernel time over the unprofiled CUDA-event step time"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    perm = torch.randperm(runner.N, device="cuda")
    B = runner.batch_size
    run = lambda: [runner._plain_step(perm[i * B:(i + 1) * B], i, 1.0)
                   for i in range(n)]
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # kernels only: an aten op's device time is its kernels' time again
    kernels = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    total = sum(k[0] for k in kernels)
    calls = sum(k[1] for k in kernels)
    tag = f"profile ({label} update)"
    if total == 0:
        print(f"{tag}: no device time recorded (not measured)")
        return
    print(f"{tag}: {calls:.0f} kernels, {total:.3f} ms of kernel time per "
          f"step over {step_ms:.3f} ms per step: device busy "
          f"{total / step_ms:.1%}")
    for ms, count, key in kernels[:12]:
        print(f"{tag}:   {ms:8.4f} ms/step {count:5.1f} calls/step  "
              f"{key[:80]}")
    for ms, count, key in kernels:
        if "langevin_update" in key:
            print(f"{tag}: update kernel {ms / count * 1e3:.2f} us a launch "
                  f"on the device, {count:.0f} a step")


# ---------------------------------------------------------------- phase 5 --
def chain_kernel_inputs(K, T, total, gen):
    "K chains' packed state on the card: each row as `kernel_inputs` makes"
    rows = [kernel_inputs(T, total, gen) for _ in range(K)]
    return [torch.stack([r[i] for r in rows]).contiguous() for i in range(5)]


def chain_seeds(K):
    """per-chain seeds as the chain runner makes them (random 62-bit keys
    plus an update counter); the last two rows are row 0's seed plus 1 and
    2, as chain 0 sees them on its next two updates"""
    gen = torch.Generator().manual_seed(5)
    keys = torch.randint(0, 2 ** 62, (K,), generator=gen)
    keys[K - 2:] = keys[0] + torch.tensor([1, 2])
    return keys.cuda()


def phase_chain_kernel(fu):
    import scipy.stats
    K = K_CHAINS
    gen = torch.Generator().manual_seed(1)
    seeds = chain_seeds(K)
    sigmas = {"sigma=0": torch.zeros(K, device="cuda"),
              "sigma per chain": torch.linspace(0.1, 1.0, K, device="cuda")}
    max_err = 0.0
    for T, total in ((273408, 272474), (70656, 70000)):
        base = chain_kernel_inputs(K, T, total, gen)
        for name, coeffs in coefficient_sets(0.01, N_TRAIN, 0.994,
                                             0.99).items():
            mom_decay, grad_lr, _, pos_c, alpha = coeffs
            c4 = (mom_decay, grad_lr, pos_c, alpha)
            for (sname, sigma), atol in zip(sigmas.items(), (1e-6, 1e-5)):
                ker = [t.clone() for t in base]
                ref = [t.clone() for t in base]
                *_, pk = fu.fused_langevin_update_chains(
                    *ker, seeds, sigma, c4, total=total, seed_offset=3)
                *_, pr = fu.fused_langevin_update_chains_reference(
                    *ref, seeds, sigma, c4, total=total, seed_offset=3)
                check(pk.shape == (K, 3), f"partials shape {pk.shape}")
                err, rel = compare_to_plain(
                    f"chains {name} T={T} {sname}", ker, ref, pk, pr, total,
                    atol, lambda t: t[:, total:])
                if T == 273408:
                    max_err = max(max_err, err)
                print(f"chain kernel == plain: {name:13s} K={K} T={T:6d} "
                      f"total={total:6d} {sname}: max |d| {err:.2e}, "
                      f"partials rel err {rel:.2e}")

    # row k of a (K, T) launch is a (T,) launch with chain k's seed and σ
    T, total = 273408, 272474
    base = chain_kernel_inputs(K, T, total, gen)
    sigma = sigmas["sigma per chain"]
    mom_decay, grad_lr, _, pos_c, alpha = coefficient_sets(
        0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"]
    c4 = (mom_decay, grad_lr, pos_c, alpha)
    bank = [t.clone() for t in base]
    *_, pb = fu.fused_langevin_update_chains(*bank, seeds, sigma, c4,
                                             total=total, seed_offset=7)
    prel = 0.0
    for k in range(K):
        row = [t[k].clone() for t in base]
        *_, pt = fu.fused_langevin_update(
            *row, int(seeds[k]) + 7,
            (mom_decay, grad_lr, float(sigma[k]), pos_c, alpha), total=total)
        for i, what in enumerate(("theta", "momentum", "square_avg")):
            check(torch.equal(bank[i][k], row[i]),
                  f"chain {k}: (K, T) row {what} differs from the (T,) launch")
        # the two grids differ (fewer blocks a chain at K=8), so the
        # partials are summed in another order
        prel = max(prel, float(((pb[k] - pt).abs() / pt.abs()).max()))
        check(torch.allclose(pb[k], pt, rtol=1e-5, atol=0),
              f"chain {k}: partials {pb[k]} vs {pt}")
    print(f"chain kernel: every row of a K={K} launch equals the (T,) launch "
          f"with its seed and noise_std, bit for bit (partials within "
          f"{prel:.1e})")
    parts = []
    for _ in range(10):
        *_, p = fu.fused_langevin_update_chains(
            *[t.clone() for t in base], seeds, sigma, c4, total=total)
        parts.append(p)
    check(all(torch.equal(parts[0], p) for p in parts),
          "chain partials differ between repeats")
    print("chain kernel: partials bitwise equal over 10 launches")

    # noise: mom_decay = grad_lr = 0, noise_std = 1 ⇒ m' = ξ, per chain
    Tn = 1 << 20
    z = lambda: torch.zeros(K, Tn, device="cuda")
    o = lambda: torch.ones(K, Tn, device="cuda")
    m = z()
    fu.fused_langevin_update_chains(z(), m, o(), z(), o(), seeds,
                                    torch.ones(K, device="cuda"),
                                    (0.0, 0.0, 0.0, 1.0), total=Tn)
    xi = m.double().cpu().numpy()
    corr = np.corrcoef(xi)
    off = np.abs(corr[~np.eye(K, dtype=bool)]).max()
    print(f"chain noise: max |corr| between chains {off:.2e} over 2^20 draws "
          "(rows 0, 6, 7: seeds s, s+1, s+2)")
    check(off < 5e-3, f"chains' noise correlated: {off}")
    for k in range(K):
        ks = scipy.stats.kstest(xi[k, ::16], "norm").pvalue
        print(f"chain noise {k}: mean {xi[k].mean():.2e} std "
              f"{xi[k].std():.6f} KS p {ks:.3f}")
        check(abs(xi[k].mean()) < 5e-3 and abs(xi[k].std() - 1.0) < 5e-3,
              f"chain {k} noise moments")
        check(ks > 1e-3, f"chain {k} noise KS p = {ks}")

    # the earlier design: right at noise_std = 0, then both timed in turns
    ker = [t.clone() for t in base]
    ref = [t.clone() for t in base]
    zero = sigmas["sigma=0"]
    *_, pk = fu.fused_langevin_update_chains_triton(*ker, seeds, zero, c4,
                                                    total=total)
    *_, pr = fu.fused_langevin_update_chains_reference(*ref, seeds, zero, c4,
                                                       total=total)
    err, _ = compare_to_plain("triton (K, T)", ker, ref, pk, pr, total, 1e-6,
                              lambda t: t[:, total:])
    print(f"triton (K, T) == plain at noise_std=0: max |d| {err:.2e}")
    vecs = chain_kernel_inputs(K, T, total, gen)
    means, _ = compare_in_turns(f"(K, T) K={K}", {
        "triton": lambda: fu.fused_langevin_update_chains_triton(
            *vecs, seeds, sigma, c4, total=total),
        "cuda": lambda: fu.fused_langevin_update_chains(
            *vecs, seeds, sigma, c4, total=total)})
    rows = [[t[k] for t in vecs] for k in range(K)]
    k_single_ms = time_ms(lambda: [fu.fused_langevin_update(
        *rows[k], 7 + k, (mom_decay, grad_lr, 0.5, pos_c, alpha), total=total)
        for k in range(K)], 100)
    plain_ms = time_ms(lambda: fu.fused_langevin_update_chains_reference(
        *vecs, seeds, sigma, c4, total=total), 100)
    bound_ms = 1e3 * max(32 * K * T / H100_BYTES_PER_S,
                         14 * K * T / H100_F32_OPS_PER_S)
    print(f"(K, T) cuda {means['cuda']['call_ms']:.4f} ms a call of K={K}, "
          f"triton {means['triton']['call_ms']:.4f} ms, {K} (T,) cuda calls "
          f"{k_single_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (32 B x {K} x {T})")
    return {"max_abs_err": max_err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "k_single_ms": k_single_ms, **means}


# ---------------------------------------------------------------- phase 6 --
def make_chain_runner(data, model, device, n_chains, **kw):
    "MultiChainRunnerReject with per-chain He inits (one generator a chain)"
    from bnn_priors_tpu_torch.exp_utils import he_initialize
    from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject
    args = dict(batch_size=128, learning_rate=0.01, momentum=0.994,
                temperatures=(CHAIN_TEMPS * n_chains)[:n_chains], cycles=1,
                epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
                precond_update=1, seed=0, compute_dtype=torch.bfloat16)
    args.update(kw)
    init = lambda i, g: he_initialize(copy.deepcopy(model), g).params()
    return MultiChainRunnerReject(model, data.norm.train, n_chains,
                                  test_data=data.norm.test,
                                  init_params_fn=init, device=device, **args)


def phase_chain_path(fu):
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model
    K = K_CHAINS
    print(f"chain axis: K={K} chains at temperatures {CHAIN_TEMPS}, bf16 "
          f"compute, batch 128 a chain; fake_cifar10 n_train={N_TRAIN} (cut "
          f"from 50,000 for time), n_test={N_TEST}; googleresnet depth 20")
    data = get_data("fake_cifar10", n_train=N_TRAIN, n_test=N_TEST)
    model = get_model("googleresnet", weight_prior="gaussian",
                      weight_scale=2 ** 0.5)
    runner = make_chain_runner(data, model, "cuda", K)
    pk = runner.kernel.packer
    check(tuple(runner.chains.position.shape) == (K, 273408)
          and pk.total == 272474, f"chain bank {runner.chains.position.shape}")
    n_boundaries = sum(runner._is_sampling_epoch(e)
                       for e in range(runner.epochs_per_cycle))
    expected = (1 + runner.n_full * runner.epochs_per_cycle * runner.cycles
                + 2 * n_boundaries * runner.cycles)

    reset_counts(fu)
    t0 = time.perf_counter()
    hist = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, single = fu.chain_launches, fu.launches
    triton = fu.triton_launches + fu.triton_chain_launches

    pots = np.concatenate(runner.potentials)
    check(pots.shape == (runner.n_full * runner.epochs_per_cycle, K)
          and np.all(np.isfinite(pots)), "chain potentials")
    check(not runner.nan_chains, f"NaN chains {runner.nan_chains}")
    check(len(runner.rejections) == n_boundaries == 1
          and runner.rejections[0].shape == (K,)
          and runner.rejections[0].dtype == bool, "one (K,) M-H decision")
    de = runner.delta_energies[0]
    check(np.all(np.isfinite(de)), f"boundary dE {de}")
    bank = runner.get_samples()
    check(set(bank) == set(model.state_dict())
          and all(v.shape[:2] == (1, K) for v in bank.values())
          and all(np.all(np.isfinite(v)) for v in bank.values()),
          "chain sample bank")
    acc, loss = hist[-1]["test/acc"], hist[-1]["test/loss"]
    check(acc.shape == (K,) and np.all((0 <= acc) & (acc <= 1))
          and np.all(np.isfinite(loss)), f"test metrics {acc} {loss}")
    check(single == 0, f"the (T,) form launched {single} times")
    check(triton == 0, f"the Triton kernels launched {triton} times")
    check(launches == expected,
          f"(K, T) kernel launches {launches}, protocol implies {expected}")
    print(f"chain axis ok in {wall:.1f} s: potentials {pots[0].round(4)} -> "
          f"{pots[-1].round(4)}")
    print(f"chain axis: boundary dE {de.round(4)} rejected "
          f"{runner.rejections[0].astype(int)}, test acc {acc.round(4)}, "
          f"(K, T) CUDA launches {launches} == {expected}, (T,) launches 0, "
          "Triton launches 0")
    return runner, launches, data


# ---------------------------------------------------------------- phase 7 --
def phase_chain_reference():
    "T=0 K-chain run on a small input: card f32 (kernel) vs CPU f64 (plain)"
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        data = get_data("fake_cifar10", n_train=64, n_test=16,
                        dtype="float64" if dtype == torch.float64
                        else "float32", device=device)
        model = get_model("googleresnet", dtype=dtype, device=device)
        r = make_chain_runner(data, model, device, 3, batch_size=32,
                              temperatures=0.0, learning_rate=1e-3,
                              compute_dtype=None)
        r.run()
        out[device] = (r.chains.position, np.concatenate(r.potentials),
                       r.delta_energies[0])
    (pc, potc, dec), (pr, potr, der) = out["cuda"], out["cpu"]
    err = float((pc.double().cpu() - pr).abs().max())
    check(err < 1e-3, f"chains: card vs CPU params differ by {err}")
    check(np.allclose(potc, potr, rtol=1e-4, atol=1e-4),
          f"chain potentials {potc} vs {potr}")
    print(f"chain reference check ok: params max |card f32 - CPU f64| "
          f"{err:.2e}, boundary dE {dec.round(6)} vs {der.round(6)}")


# ---------------------------------------------------------------- phase 8 --
def chain_step_ms(runner, n=50):
    "ms per minibatch step of all the runner's chains (CUDA events)"
    idxs = runner._epoch_idxs(0, 0)
    temps = runner._temps_for(runner.epochs_per_cycle - 1)

    def steps(k):
        for i in range(k):
            runner._chain_step(idxs[:, i % runner.n_full], i, temps)
    steps(5)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    steps(n)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def phase_chain_throughput(fu, runner8, data, card):
    "aggregate chain-steps/s at K = 1, 4, 8 (bf16), one call, one card"
    rates = {}
    for K in (1, 4, 8):
        runner = runner8 if K == 8 else make_chain_runner(
            data, runner8.model, "cuda", K)
        ms = chain_step_ms(runner)
        rates[K] = (ms, K * 1e3 / ms)
        print(f"chain axis K={K}: {ms:.3f} ms a step of {K} chains, "
              f"{K * 1e3 / ms:.1f} aggregate chain-steps/s (bf16, batch 128 "
              f"a chain, ResNet-20) on {card}")
    K = K_CHAINS
    turns = steps_in_turns(fu, f"chain axis K={K}",
                           lambda: K * 1e3 / chain_step_ms(runner8),
                           "aggregate chain-steps/s")
    return rates, turns


def phase_chain_profile(runner, step_ms, label="cuda", n=10):
    "device busy share of K=8 chain steps, and the kernels that take it"
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    idxs = runner._epoch_idxs(0, 0)
    temps = runner._temps_for(runner.epochs_per_cycle - 1)
    run = lambda: [runner._chain_step(idxs[:, i], i, temps) for i in range(n)]
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    total = sum(k[0] for k in kernels)
    tag = f"chain profile ({label} update)"
    if total == 0:
        print(f"{tag}: no device time recorded (not measured)")
        return
    print(f"{tag}: {sum(k[1] for k in kernels):.0f} kernels, "
          f"{total:.3f} ms of kernel time per K={runner.n_chains} step over "
          f"{step_ms:.3f} ms per step: device busy {total / step_ms:.1%}")
    for ms, count, key in kernels[:12]:
        print(f"{tag}:   {ms:8.4f} ms/step {count:5.1f} calls/step  "
              f"{key[:80]}")
    for ms, count, key in kernels:
        if "langevin_update" in key:
            print(f"{tag}: update kernel {ms / count * 1e3:.2f} us a launch "
                  f"on the device, {count:.0f} a step")


def kernel_record(name, launches, timing):
    "one entry of the `kernels` JSON line"
    cuda, triton = timing["cuda"], timing["triton"]
    return {"name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": "bnn_priors_tpu/ops/fused_update.py:47",
            "launches": launches, "max_abs_err": timing["max_abs_err"],
            "ms": cuda["call_ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "b2b_ms": cuda["b2b_ms"],
            "enqueue_us": cuda["enqueue_us"], "device_us": cuda["device_us"],
            "earlier_route": "triton", "earlier_ms": triton["call_ms"],
            "earlier_b2b_ms": triton["b2b_ms"],
            "earlier_enqueue_us": triton["enqueue_us"],
            "earlier_device_us": triton["device_us"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Triton's compiled kernels go under the checkout, not $HOME
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "triton_cache"))
    from bnn_priors_tpu_torch.ops import fused_update as fu
    card = card_line()
    print(card)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)
    phase_build()

    timing = phase_kernel(fu)
    runner, launches = phase_main_path(fu)
    phase_reference()
    steps = steps_in_turns(fu, "main path (f32)",
                           lambda: phase_step_time(runner),
                           f"ms per minibatch step (batch 128, ResNet-20) on "
                           f"{card}")
    phase_profile(runner, steps["cuda"])
    with_triton(fu, lambda: phase_profile(runner, steps["triton"], "triton"))
    runner.compute_dtype = torch.bfloat16
    print(f"main path: {phase_step_time(runner):.3f} ms per minibatch step "
          f"in bf16 compute on {card}")
    del runner
    chain_timing = phase_chain_kernel(fu)
    chains, chain_launches, data = phase_chain_path(fu)
    phase_chain_reference()
    rates, turns = phase_chain_throughput(fu, chains, data, card)
    phase_chain_profile(chains, rates[K_CHAINS][0])
    with_triton(fu, lambda: phase_chain_profile(
        chains, K_CHAINS * 1e3 / turns["triton"], "triton"))
    check("jax" not in sys.modules and "bnn_priors_tpu" not in sys.modules,
          "JAX was imported")

    print(json.dumps({"kernels": [
        kernel_record("fused_langevin_update", launches, timing),
        kernel_record("fused_langevin_update_chains", chain_launches,
                      chain_timing)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
