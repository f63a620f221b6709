#!/usr/bin/env python3
"""Run the PyTorch port (`bnn_priors_tpu_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

0. set-up: a CUDA card must be present; prints the card's name and power
   limit, and turns TF32 off for matmuls and cuDNN convolutions, so float32
   means float32 throughout.
1. the Triton kernel `fused_langevin_update` against its plain PyTorch
   version on the card, at ResNet-20's packed length (T=273,408,
   total=272,474) and at a ragged T=70,656 (total=70,000), for the SGLD step
   and the three GGMC phases at noise_std=0 (θ, m, v within atol 1e-6,
   partials within rtol 1e-4, padding tail exactly 0); then its noise over
   2^20 elements (mean, std, KS test; same seed bitwise equal, new seed
   different); then its time and the plain version's (CUDA events, median
   of 100 calls).
2. the main path: `get_data("fake_cifar10")`, `get_model("googleresnet")`
   at full width and depth 20, `he_initialize`, then
   `VerletSGLDRunnerReject(...).run()` — GGMC with exact full-data
   gradients and an M-H test at the sampling boundary. n_train is cut from
   50,000 to 5,000 for time. The kernel's launch count over the run must
   equal the count the protocol implies (every transition went through it).
3. a reference check: the same runner at temperature 0 on a small input, on
   the card in float32 (kernel) and on the CPU in float64 (plain version),
   must agree.
4. the main path's time per minibatch step (CUDA events), then a
   torch.profiler window over the same steps: device time per step, the
   device's busy share and the kernels that take it; then the step's time
   in bf16 compute.
5. the (K, T) chain form `fused_langevin_update_chains` against its plain
   version on the card, at K=8 chains of ResNet-20's T and of the ragged T,
   for the same four coefficient sets with every chain's noise_std 0 (θ, m,
   v within atol 1e-6, partials within rtol 1e-4, tails exactly 0); then
   row k of a (K, T) launch against a (T,) launch with chain k's seed,
   noise_std and inputs (bit for bit); then the noise of 8 chains over 2^20
   draws each (|corr| < 5e-3 between every two chains, mean, std and KS per
   chain); then one (K, T) launch against K (T,) launches and the plain
   version (CUDA events, median of 100).
6. the chain axis: `MultiChainRunnerReject` with K=8 chains of full-width
   ResNet-20 at per-chain temperatures, bf16 compute, batch 128 a chain,
   one cycle of 2 epochs (1 warmup, 1 sampling) on the same cut data. The
   (K, T) kernel's launch count must equal the protocol's and the (T,)
   form must not launch; potentials finite, one (K,) decision at the
   boundary, a (1, K, ...) sample bank, per-chain test metrics in [0, 1].
7. a reference check of the chain axis: the K-chain runner at temperature
   0 on a small input, on the card in float32 (kernel) and on the CPU in
   float64 (plain version), must agree.
8. aggregate chain-steps/s (K × steps / time, CUDA events around 50
   minibatch steps) at K = 1, 4 and 8 in bf16, to set beside phase 4's
   single-chain steps; then a profiler window over K=8 chain steps: device
   busy share and the top kernels.

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


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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


def phase_kernel(fu):
    import scipy.stats
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for T, total in ((273408, 272474), (70656, 70000)):
        base = kernel_inputs(T, total, gen)
        for name, coeffs in coefficient_sets(0.01, N_TRAIN, 0.994,
                                             0.99).items():
            ker = [t.clone() for t in base]
            ref = [t.clone() for t in base]
            *_, pk = fu.fused_langevin_update(*ker, 1234, coeffs, total=total)
            *_, pr = fu.fused_langevin_update_reference(*ref, 1234, coeffs,
                                                        total=total)
            torch.cuda.synchronize()
            for i, what in enumerate(("theta", "momentum", "square_avg")):
                err = float((ker[i] - ref[i]).abs().max())
                check(err <= 1e-6, f"{name} T={T}: {what} off by {err}")
                check(bool((ker[i][total:] == 0).all()),
                      f"{name} T={T}: {what} padding tail not zero")
                if T == 273408:
                    max_err = max(max_err, err)
            rel = float(((pk - pr).abs() / pr.abs().clamp_min(1e-30)).max())
            check(rel <= 1e-4, f"{name} T={T}: partials {pk} vs {pr}")
            print(f"kernel == plain: {name:13s} T={T:6d} total={total:6d} "
                  f"partials rel err {rel:.2e}")

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

    # time at the main path's shape
    T, total = 273408, 272474
    vecs = kernel_inputs(T, total, gen)
    coeffs = coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"]
    ms = time_ms(lambda: fu.fused_langevin_update(*vecs, 7, coeffs,
                                                  total=total), 100)
    plain_ms = time_ms(lambda: fu.fused_langevin_update_reference(
        *vecs, 7, coeffs, total=total), 100)
    # bytes: read θ, m, v, g, M, write θ', m', v' (f32); ops: ~14 a element
    bound_ms = 1e3 * max(32 * T / H100_BYTES_PER_S,
                         14 * T / H100_F32_OPS_PER_S)
    print(f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (32 B x {T})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


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

    fu.launches = fu.chain_launches = 0
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, chain = fu.launches, fu.chain_launches

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
    check(launches == expected and chain == 0,
          f"kernel launches {launches} ((K, T) form {chain}), protocol "
          f"implies {expected}")
    print(f"main path ok in {wall:.1f} s: potentials {pots[0]:.4f} -> "
          f"{pots[-1]:.4f}, boundary dE {b['delta_energy']:.4f} rejected "
          f"{b['rejected']}, test acc {ev['test/acc']:.4f} loss "
          f"{ev['test/loss']:.4f}, kernel launches {launches} == {expected}")
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


def phase_profile(runner, step_ms, n=10):
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
    if total == 0:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile: {calls:.0f} kernels, {total:.3f} ms of kernel time per "
          f"step over {step_ms:.3f} ms per step: device busy "
          f"{total / step_ms:.1%}")
    for ms, count, key in kernels[:12]:
        print(f"profile:   {ms:8.4f} ms/step {count:5.1f} calls/step  "
              f"{key[:80]}")
    for ms, count, key in kernels:
        if "langevin_update" in key:
            print(f"profile: fused_langevin_update kernel {ms / count * 1e3:.2f}"
                  f" us a launch on the device, {count:.0f} a step")


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
    zero_sigma = torch.zeros(K, device="cuda")
    max_err = 0.0
    for T, total in ((273408, 272474), (70656, 70000)):
        base = chain_kernel_inputs(K, T, total, gen)
        for name, coeffs in coefficient_sets(0.01, N_TRAIN, 0.994,
                                             0.99).items():
            mom_decay, grad_lr, _, pos_c, alpha = coeffs
            c4 = (mom_decay, grad_lr, pos_c, alpha)
            ker = [t.clone() for t in base]
            ref = [t.clone() for t in base]
            *_, pk = fu.fused_langevin_update_chains(*ker, seeds, zero_sigma,
                                                     c4, total=total)
            *_, pr = fu.fused_langevin_update_chains_reference(
                *ref, seeds, zero_sigma, c4, total=total)
            torch.cuda.synchronize()
            for i, what in enumerate(("theta", "momentum", "square_avg")):
                err = float((ker[i] - ref[i]).abs().max())
                check(err <= 1e-6, f"chains {name} T={T}: {what} off by {err}")
                check(bool((ker[i][:, total:] == 0).all()),
                      f"chains {name} T={T}: {what} padding tail not zero")
                if T == 273408:
                    max_err = max(max_err, err)
            rel = float(((pk - pr).abs() / pr.abs().clamp_min(1e-30)).max())
            check(pk.shape == (K, 3) and rel <= 1e-4,
                  f"chains {name} T={T}: partials {pk} vs {pr}")
            print(f"chain kernel == plain: {name:13s} K={K} T={T:6d} "
                  f"total={total:6d} partials rel err {rel:.2e}")

    # row k of a (K, T) launch is a (T,) launch with chain k's seed and σ
    T, total = 273408, 272474
    base = chain_kernel_inputs(K, T, total, gen)
    sigma = torch.linspace(0.1, 1.0, K, device="cuda")
    mom_decay, grad_lr, _, pos_c, alpha = coefficient_sets(
        0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"]
    bank = [t.clone() for t in base]
    *_, pb = fu.fused_langevin_update_chains(
        *bank, seeds, sigma, (mom_decay, grad_lr, pos_c, alpha), total=total)
    for k in range(K):
        row = [t[k].clone() for t in base]
        *_, pt = fu.fused_langevin_update(
            *row, int(seeds[k]),
            (mom_decay, grad_lr, float(sigma[k]), pos_c, alpha), total=total)
        for i, what in enumerate(("theta", "momentum", "square_avg")):
            check(torch.equal(bank[i][k], row[i]),
                  f"chain {k}: (K, T) row {what} differs from the (T,) launch")
        check(torch.allclose(pb[k], pt, rtol=1e-6, atol=0),
              f"chain {k}: partials {pb[k]} vs {pt}")
    print(f"chain kernel: every row of a K={K} launch equals the (T,) launch "
          "with its seed and noise_std, bit for bit")

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

    # time at the chain axis's shape: one (K, T) launch vs K (T,) launches
    vecs = chain_kernel_inputs(K, T, total, gen)
    c4 = (mom_decay, grad_lr, pos_c, alpha)
    ms = time_ms(lambda: fu.fused_langevin_update_chains(
        *vecs, seeds, sigma, c4, total=total), 100)
    rows = [[t[k] for t in vecs] for k in range(K)]
    k_single_ms = time_ms(lambda: [fu.fused_langevin_update(
        *rows[k], 7 + k, (mom_decay, grad_lr, 0.5, pos_c, alpha), total=total)
        for k in range(K)], 100)
    plain_ms = time_ms(lambda: fu.fused_langevin_update_chains_reference(
        *vecs, seeds, sigma, c4, total=total), 100)
    bound_ms = 1e3 * max(32 * K * T / H100_BYTES_PER_S,
                         14 * K * T / H100_F32_OPS_PER_S)
    print(f"chain kernel {ms:.4f} ms a launch of K={K}, {K} (T,) launches "
          f"{k_single_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (32 B x {K} x {T})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "k_single_ms": k_single_ms}


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

    fu.launches = fu.chain_launches = 0
    t0 = time.perf_counter()
    hist = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, single = fu.chain_launches, fu.launches

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
    check(launches == expected,
          f"(K, T) kernel launches {launches}, protocol implies {expected}")
    print(f"chain axis ok in {wall:.1f} s: potentials {pots[0].round(4)} -> "
          f"{pots[-1].round(4)}")
    print(f"chain axis: boundary dE {de.round(4)} rejected "
          f"{runner.rejections[0].astype(int)}, test acc {acc.round(4)}, "
          f"(K, T) launches {launches} == {expected}, (T,) launches 0")
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


def phase_chain_throughput(runner8, data, card):
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
    return rates


def phase_chain_profile(runner, step_ms, n=10):
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
    if total == 0:
        print("chain profile: no device time recorded (not measured)")
        return
    print(f"chain profile: {sum(k[1] for k in kernels):.0f} kernels, "
          f"{total:.3f} ms of kernel time per K={runner.n_chains} step over "
          f"{step_ms:.3f} ms per step: device busy {total / step_ms:.1%}")
    for ms, count, key in kernels[:12]:
        print(f"chain profile:   {ms:8.4f} ms/step {count:5.1f} calls/step  "
              f"{key[:80]}")
    for ms, count, key in kernels:
        if "langevin_update_chains" in key:
            print(f"chain profile: fused_langevin_update_chains kernel "
                  f"{ms / count * 1e3:.2f} us a launch on the device, "
                  f"{count:.0f} a step")


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

    timing = phase_kernel(fu)
    runner, launches = phase_main_path(fu)
    phase_reference()
    step_ms = phase_step_time(runner)
    print(f"main path: {step_ms:.3f} ms per minibatch step (batch 128, "
          f"ResNet-20, f32) on {card}")
    phase_profile(runner, step_ms)
    runner.compute_dtype = torch.bfloat16
    print(f"main path: {phase_step_time(runner):.3f} ms per minibatch step "
          f"in bf16 compute on {card}")
    del runner
    chain_timing = phase_chain_kernel(fu)
    chains, chain_launches, data = phase_chain_path(fu)
    phase_chain_reference()
    rates = phase_chain_throughput(chains, data, card)
    phase_chain_profile(chains, rates[K_CHAINS][0])
    check("jax" not in sys.modules and "bnn_priors_tpu" not in sys.modules,
          "JAX was imported")

    common = {"route": "triton",
              "source": "bnn_priors_tpu_torch/ops/fused_update.py",
              "replaces": "bnn_priors_tpu/ops/fused_update.py:47",
              "bound_by": "bytes", "library_ms": None}
    print(json.dumps({"kernels": [
        dict(common, name="fused_langevin_update", launches=launches,
             **{k: timing[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms")}),
        dict(common, name="fused_langevin_update_chains",
             launches=chain_launches,
             **{k: chain_timing[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms")})]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
