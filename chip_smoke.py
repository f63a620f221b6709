#!/usr/bin/env python3
"""Run the PyTorch port (`bnn_priors_tpu_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

0. set-up: a CUDA card must be present; prints the card's name and power
   limit, and turns TF32 off for matmuls and cuDNN convolutions, process
   wide, so float32 means float32 wherever no `matmul_precision` mode is
   entered (a mode sets its flags and restores these on exit). Builds
   the three CUDA kernels (`bnn_priors_tpu_torch/csrc/fused_update.cu`,
   `csrc/fused_update_segments.cu` and `csrc/split_operand.cu`, one nvcc
   for sm_90a each, started together, into build/kernels/) and prints ptxas's registers, shared
   memory and spills, one line a distinct report.
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
   gradients and an M-H test at the sampling boundary — at `train_bnn`'s
   default `matmul_precision` (bfloat16: the convolutions and products on
   bf16 operands, `bnn_priors_tpu_torch/precision.py`). n_train is cut from
   50,000 to 5,000 for time. The CUDA kernel's launch count over the run
   must equal the count the protocol implies (every transition went
   through it), and the Triton kernels must not launch; the split
   kernel's launches must equal the count the schedule implies (7,124:
   one weight table a minibatch step, exact pass and test pass, the
   layers' inputs and gradients, `RESNET20_SPLITS`).
3. a reference check: the same runner at temperature 0 on a small input, on
   the card in float32 (kernel; `matmul_precision="float32"`, as every
   runner `make_runner` builds unless told otherwise) and on the CPU in
   float64 (plain version), must agree.
4. the main path's time per minibatch step (CUDA events) at
   `matmul_precision="float32"`, with the CUDA
   kernel and with the Triton wrapper assigned in its place, in turns; then
   a torch.profiler window over the same steps: device time per step, the
   device's busy share and the kernels that take it, and the host's ops a
   step with those that take most of its time; then the step's time in
   bf16 compute.
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
8. aggregate chain-steps/s (K × steps / time, CUDA events around 25
   minibatch steps) at K = 1, 4 and 8 in bf16, to set beside phase 4's
   single-chain steps, and at K=8 with the Triton chain wrapper assigned in
   the CUDA one's place, in turns; then a profiler window over K=8 chain
   steps: device busy share and the top kernels.
   Phase 4 also times the single-chain step as the CLI runs it: with a
   metrics saver (per-leaf diagnostics each step), then with augmentation
   too, beside the bare step, in turns.
9. the paper's command line on the card: `train_bnn.main` with
   data=fake_cifar10 model=googleresnet inference=VerletSGLDReject
   reject_samples=True at the CLI's own data size (50,000 / 10,000),
   augmented, one cycle of 2 epochs (warmup=1 n_samples=1). run.json
   COMPLETED, the four run files, finite potentials and result, the CUDA
   kernel's launches equal to the schedule's (1 + 391 × 2 + 2), no `(K, T)`
   or Triton launch, the split kernel's the schedule's (69,634, each exact
   pass splitting the weights once); prints the epoch's time, its minibatch steps/s and
   augmentation share, the M-H boundary's time by part and the time of
   `evaluate_model` over the bank; and a profiler window over 3 minibatch
   steps in the middle of epoch 1, printed as phase 4's (kernels and host
   ops a step, to set beside phase 4's step). Where h5py does not import,
   prints `h5py: absent` and the CLI phases write their run files through
   in-memory stand-ins with the savers' interface (`hdf5_or_stand_in`).
10. the chain CLI: `train_bnn.main` with n_chains=8 compute_dtype=bfloat16
   on fake_cifar10 cut to 5,000 / 1,000 (as phases 6-8): 8 chain run dirs
   COMPLETED with their results and acceptance, the pooled result, and the
   `(K, T)` launches equal to the schedule's (1 + 39 × 2 + 2).
11. `eval_bnn.main` on phase 9's run dir with calibration_eval=True
    reproduces the CLI's result (rtol 1e-5), ece in [0, 1].
12. `evaluate_model` over phase 10's pooled bank (8 samples) on 128 test
    points (cut from 256), on the card in float32 and on the CPU in
    float64: log-probs within 1e-4, lp_* within 1e-4, accuracies within
    one point.
13. checkpoint and resume on the card, at n_train 640 / 1,000: one chain
    (`VerletSGLDRunnerReject`, f32) and K=8 chains (bf16), each two cycles
    of 2 epochs (1 warmup, 1 sampling) run (a) uninterrupted, (b) again,
    (c) stopped after epoch 2 with its checkpoint (`checkpoint_every=1`,
    cycles lowered on the runner) and (d) by a fresh runner of another
    seed resumed from (c)'s file. Prints the largest |(a) − (b)| and
    |(a) − (d)| of position, momentum, square_avg, precond, the last
    sample, ΔE and the M-H decisions; in a subprocess
    (`chip_smoke.py resume-deterministic`, `CUBLAS_WORKSPACE_CONFIG` set
    before CUDA starts) with cuDNN's deterministic algorithms on,
    autotuning off and `torch.use_deterministic_algorithms(True,
    warn_only=True)`, where (a) = (d) must hold bit for bit (or, if an op
    on the path has no deterministic CUDA implementation, which it names,
    within the (a) − (b) spread); meanwhile here at the default settings
    (the two at once, for the script's time). The
    checkpoint's size and write and read times (each call between two
    synchronisations); (d)'s launches must equal the schedule's (12 `(T,)`
    and 12 `(K, T)` at 640 points; 22 and 22 at 1,280).
14. HMC on the card: `train_bnn` with inference=HMCReject (batch 128, M-H
    on), OurHMC (batch 128) and HMC (classical: one batch of all 5,000
    points), cycles=1 warmup=1 n_samples=2 burnin=0 temperature=1
    momentum=1: `(T,)` launches equal to the schedule's (125, 123, 8),
    none of the other form; the acceptance rate, ΔE at the boundaries,
    `torch.cuda.max_memory_allocated`, the minibatch step's and the exact
    pass's time (synchronised, median). Then one classical-HMC run
    (batch = N = 80, two M-H tests, T=1) with the momentum injected, on
    the card in f32 against the CPU in f64: the same decisions, params
    and momentum within 1e-3, ΔE within 1e-5 of ½‖m‖² + N·max|U| (the
    terms it cancels).

15. priors and CIFAR-10 files: (a) the first 100 `(T,)` launches of
    phase 2's runner (rebuilt with its seed) draw with seeds key + n, all
    different, and phase 13's deterministic resume was bitwise; (b)
    synthetic CIFAR-10 python batches (50,000 / 10,000 uint8 images from
    seed 0) written under build/, `BNN_PRIORS_DATA` pointed at them, and
    `get_data("cifar10")` on the card: load time, the train set's channel
    mean 0 and std 1; (c) the log prior and its gradient of googleresnet
    with each of the 29 registry priors that build on it, and of
    correlatedgoogleresnet with convcorrnormal, in f32 on the card against
    CPU f64 at the same parameters (relative 1e-5 on the value and the
    gradient's norm); (d) the paper's grid rows through the single-chain
    CLI on `data=cifar10_small`: improper, gaussian, laplace, student-t,
    convcorrnormal (correlatedgoogleresnet) and gaussian_gamma after a
    gaussian run, each with its `(T,)` launches against the schedule
    (83), a finite ΔE, its median synchronised minibatch step and, over a
    profiler window of 3 steps (cut from 5), its host ops, kernels and
    kernel time a step; (e)
    `n_chains=8 compute_dtype=bfloat16 init_method=prior` with
    gaussian_gamma after a gaussian run: `(K, T)` launches (81), no
    chain NaN, chain-steps/s.

16. segmented and hybrid chain states: (a) the segments kernel
    (`fused_langevin_update_segments` and its K-chain form) against its
    plain version on ResNet-20's 22 hybrid and 65 segmented segments, one
    chain and K=8, and on resnet18's states, one chain: the six coefficient
    sets at noise_std 0 (atol 1e-6) and on (atol 1e-5), partials within
    rtol 1e-4 and bitwise over 10 launches; every element's ξ bit for bit
    the flat kernel's at its flat index; the whole update against the flat
    kernel with the noise on; row k of a K=8 launch bit for bit a
    one-chain launch, and of a K=64 launch on the segmented state (every
    block at its 16 groups); then its time at ResNet-20's one chain and
    K=8 and resnet18's one chain: device µs a launch in a CUDA graph of 50
    over a ring of copies larger than L2 and over one copy (hot), a call,
    back to back, a hot launch (profiler) and enqueue, beside the flat
    kernel's, the plain version's and its byte bound; (b)
    `VerletSGLDRunnerReject` as phase 2 with `packing="hybrid"` and
    `"segmented"` on 5,000 points (`SEG_N`; 1,280 before): 83 segments
    launches and no flat one each, and phase 3's card-f32 vs CPU-f64 check
    for each; (c) `MultiChainRunnerReject` as phase 6 (K=8, bf16) with
    `packing="hybrid"` and `"segmented"` on the same points, 81 launches
    each, the protocol's; (d) the
    minibatch step with flat, hybrid and segmented states in turns (flat,
    hybrid, segmented, segmented, hybrid, flat), one chain in f32 and K=8
    in bf16, and a profiler window of 3 steps each: kernels, kernel
    time, host ops and cuDNN layout conversions a step; (e) phase 13's
    deterministic resume with hybrid states (`chip_smoke.py
    resume-deterministic hybrid`, one chain and K=8): bit for bit. (d)
    runs after (a); (e)'s process runs while (b) and (c), which read no
    time, run here.

17. every inference on the chain axis, full-width ResNet-20, bf16: (a)
    the `(K, T)` kernel against its plain version at K=4 on SGLD's
    coefficients (momentum 0.994 and 0, σ_k = sqrt(2(1−a)T_k) at T = 0,
    0.01, 0.1, 1) and HMC's (momentum decay 1, σ = 0), atol 1e-5,
    partials rtol 1e-4; (b) `train_bnn` with n_chains=4 for SGLD,
    VerletSGLD, OurHMC, SGLDReject and HMCReject on fake_cifar10 cut to
    1,280 / 1,000 (`CHAIN_N`; cut from 5,000 and then 2,560), one
    cycle (SGLD three epochs with eval_skip=2, the others two): 4 chain
    run dirs COMPLETED with finite results and pooled result, `(K, T)`
    launches equal to the count the runners' code implies
    (`chain_expected_launches`: 30, 20, 20, 22, 23) and no other kernel's;
    (c) classical HMC with n_chains=2 at batch 1,280 (5 launches), its
    peak memory under 40 GiB; (d) the
    eval_skip=2 run's test passes (2 of 3 epochs); (e) the K=4 chain CLI of
    VerletSGLDReject and SGLD on 640 points run for two cycles, for one with
    checkpoint_every=1, and for two resumed from that file, in a
    subprocess with deterministic algorithms (`chip_smoke.py
    resume-cli-chains`, running while (a)-(c) run here): the resumed run's final checkpoint equal to the
    uninterrupted run's in every entry, bit for bit, and its launches
    (12, 10 at 640 points); (f) the K=8 minibatch step with
    chain_group_size 8, 4, 2 and 1 in turns (8, 4, 2, 1, 1, 2, 4, 8), 5
    steps a turn (cut from 10): ms a step, chain-steps/s, and a
    profiler window of 2 steps each (kernels, kernel time, host ops a
    step).

18. the CLI's own defaults, MNIST-family data and UCI regression: (a) the
    `(T,)` kernel against its plain version at this slice's lengths
    (47,560 the CNN, 42,310 the FCNN, 3,302 densenet on UCI_boston; T
    padded to 1024) and the `(K, T)` form at K=8 of the CNN's, SGLD and
    the three GGMC sets at noise_std 0 and on (phase 1's tolerances),
    with each length's call time, the plain version's and the byte bound;
    (b) synthetic IDX files in MNIST's format from seed 0 (60,000 /
    10,000 images, and 5,000 / 1,000 of them gzipped as MNIST and
    FashionMNIST) under build/, `BNN_PRIORS_DATA` pointed at them, and
    `train_bnn` with no data, model, width, depth or inference given
    (data=mnist classificationconvnet width 50 depth 3
    VerletSGLDReject), one cycle of 2 epochs uncut: `(T,)` launches
    against the schedule's (1 + 469 × 2 + 2), no other kernel; the epoch,
    its steps and test pass, the M-H boundary and its exact pass
    (synchronised); then `eval_bnn` on its dir with calibration_eval=True
    (the run's result within rtol 1e-5) and with eval_data=rotated_mnist;
    (c) the FCNN, the correlated CNN (convcorrnormal with lengthscale_1
    and lengthscale_2) and the CNN on fashion_mnist at 5,000 / 1,000, 83
    launches each; (d) the chain CLI: the CNN at K=8 in bf16
    (VerletSGLDReject), the FCNN at K=4 (SGLD, the plain loop), densenet
    on UCI_boston at K=4 through both (f32 reject, bf16 SGLD), `(K, T)`
    launches against `chain_expected_launches` and no other kernel; (e)
    densenet on UCI_boston, one chain, two sampling epochs (17 launches),
    `noise_std` finite and positive, `eval_bnn` reproducing the result,
    and `evaluate_model` over its bank on the card in f32 against the CPU
    in f64 (rel 1e-4); (f) each new model's forward pass and
    log-likelihood on 256 points, card f32 against CPU f64 (f within 1e-4
    of its scale, the log-likelihood rel 1e-4), and the K=8 chain fold
    against 8 single forwards on the card; (g) ms a minibatch step (CUDA
    events): the CNN and the FCNN, one chain f32, 25 steps in turns, and
    the CNN at K=8 in bf16, 25 steps, with a 10-step profiler window each.
19. the PreAct ResNets and the data-driven models at full width: (a) the
    `(T,)` kernel at resnet18's T = 11,171,840 and the `(K, T)` kernel at
    K=8 × T against their plain versions with the noise on (phase 1's
    tolerances; a partial that cancels also within 1e-7 of its summed
    magnitudes), their device µs a launch against the byte bounds 0.107
    and 0.854 ms; (b) `train_bnn data=cifar10 model=resnet18
    inference=VerletSGLDReject` on synthetic CIFAR-10 batches of 5,000 /
    1,000 images, one cycle of 2 epochs: 83 `(T,)` launches, no other
    kernel, the M-H boundary and its exact pass, ms a step over 25 steps
    and a profiler window (the update's share of the step); (c) the same
    with n_chains=8 compute_dtype=bfloat16 on 640 / 256 images: 13
    `(K, T)` launches, peak memory, chain-steps/s and a window; (d) card
    f32 against CPU f64 at
    He-initialised parameters: forward, log prior and potential of
    resnet18, datadriven_resnet18 (mean_covs) and
    datadrivendoublegammaconv, and resnet18's ΔE at a T=0 boundary on 16
    points (cut from 32; within 1e-6 of N·U, and its kinetic part
    ΔE − N·ΔU within 1e-4 of its own size); (e) ten one-chain CLI runs on
    640 / 256
    images (thin_resnet18, resnet34, vwidth_resnet18 at 32, both fits of
    datadriven_resnet18, resnet18 with the fitted lengthscales, the two
    data-driven CNNs on IDX files, both MVT ResNet-20s): 13 launches each
    and ms a step.
20. the paper's grid-and-evaluate pipeline: (a) the `(K, T)` kernel at
    K=30 × ResNet-20's T (262.5 MB a launch, above the L2) against its
    plain version with every chain's noise on (θ, m, v atol 1e-5,
    partials rtol 1e-4 plus 1e-7 of their summed magnitudes), its device
    µs a launch against the 0.0784 ms byte bound; (b) `sweep_tempering
    data=cifar10 model=googleresnet inference=VerletSGLDReject
    compute_dtype=bfloat16` with the paper's 6 × 5 grid (30 chains in one
    bank) on synthetic CIFAR-10 batches of 1,280 / 256 images, cycles=1
    warmup=1 n_samples=2: `(K, T)` launches against the runners' count
    (35), no other kernel, 30 run dirs COMPLETED with each config's
    temperature and replicate as c = r·6 + t says, peak memory and wall
    time; then the K=30 minibatch step beside K=8 in turns (30, 8, 8, 30;
    events over 20 steps) and a profiler window at K=30; (c)
    `run_evaluation.sh`'s three `eval_bnn` calls (plain;
    `cifar10c-gaussian_blur` with calibration on a synthetic NHWC file of
    5,000 rows, severity None; `svhn` with `ood_eval` on synthetic .mat
    files of 2,000 / 1,000, with `marglik_eval` on the first) on chain 0
    (T=0.001) and chain 5 (T=1.0), each call's seconds, every ECE, ACE,
    RMSCE, AUROC and AUPRC in [0, 1]; (d) on chain 0, the card's f32
    evaluation against the port's CPU f64 one on the same bank and files:
    each point's max-probability score within 1e-5, AUROC and AUPRC
    within 1e-3, every sample's log prior within 1e-6 relative, and the
    CLI's results equal to the functions' on the card.
21. the remaining models, the synthetic data, train_sgd and profile_dir:
    (a) `bnn_priors_tpu_torch.experiments.train_sgd.main` (what `python
    -m` runs) at its defaults (thin_resnet18, cifar10_augmented, batch
    128, lr 0.05, momentum 0.9, stairs) on synthetic CIFAR-10 batches of
    5,000 / 1,000 images, `--n_epochs 3 --epochs_per_sample 1
    --skip_first 1`: run.json
    COMPLETED, `(T,)` launches against the schedule's (3 × 40 + 1, every
    one at noise_std 0), no other kernel, each epoch's seconds; then ms a
    SGD step (events, 25 steps, twice) and the `(T,)` kernel at
    thin_resnet18's T = 701,440 against its plain version (noise_std 0,
    phase 1's tolerances), its device µs a launch against the 32 B × T
    byte bound; (b) `train_bnn data=synthetic.mnist.gaussian` with the
    CLI's CNN on synthetic MNIST IDX files at 60,000 / 10,000, one cycle
    of 2 epochs (941 launches), and `eval_bnn` on its dir regenerating the
    labels bit for bit and the result within 1e-5; (c) raobdensenet of
    width 50 on UCI_protein's 41,157 training rows, card f32 net with the
    f64 Woodbury form against the CPU in f64 at the same parameters: the
    marginal log-likelihood, its gradient (noise_std.p included),
    posterior_w and predictive within 1e-3 relative, and the ms of one
    likelihood-and-gradient call; (d) the distribution-preservation check
    of tests/test_torch_verlet_sgld.py on GaussianModel(50, 1000) through
    the `(T,)` kernel and its Philox noise (a launch a transition), then
    `train_bnn data=random model=test_gaussian inference=VerletSGLDReject`
    (19 launches, log-likelihood 0); (e) `train_bnn profile_dir=...` on
    densenet over data=random in batches of 16: the Chrome trace of epoch
    1 holds CUDA kernel events, among them at most 50 (the window)
    `fused_langevin_update` launches, and the run's samples and result are
    bit for bit an unprofiled run's.

22. the chain axis across processes and devices, and the pipelined
    epoch, on full-width ResNet-20: first the `(K, T)` kernel against its
    plain version at the sub-banks' own shapes, K_d = 4 and 15 × 273,408
    (phase 17 (a)'s inputs and seeds, σ_k of the sub-bank's tempering
    grid, GGMC's and SGLD's coefficient sets, θ, m, v atol 1e-5, partials
    as phase 20 (a)); then all in two processes on cuda:0
    (`chip_smoke.py ranks`, `CUBLAS_WORKSPACE_CONFIG` set, cuDNN's and
    cuBLAS's deterministic algorithms on): (b) one program over gloo on
    localhost: train_bnn n_chains=8 n_devices=2 num_processes=2 with
    phase 10's run on 2,560 / 1,000 points (`MESH_N`; cut from 5,000;
    VerletSGLDReject, reject_samples, bf16): 4 chains a rank, 43 `(K, T)`
    launches a rank, each rank's run dirs its
    own chains'; then the sweep's K=30 bank at 1,280 / 256 (15 a rank, 35
    launches a rank); the shared diagnostics equal on both ranks; (c) one
    `ChainMesh` step of 2 ResNet-20 chains (no batchnorm) at T=0 with the
    minibatch of 128 split over the two ranks' `data` positions (the
    gradient summed by gloo over CUDA tensors) against the whole batch on
    one rank: position change and potential within `MESH_CM_TOL`; then in
    rank 0 alone: rank 0's gathered checkpoint after epoch 1 resumed in one
    process (22 launches), (a) phase 10's run with pipeline=True and
    pipeline=False in turns: equal histories and M-H records, bit for bit
    equal sample banks, 43 launches each, `timings/epoch_s` and
    `timings/wall_s` (dispatch to dispatch, the pipeline's only), and the
    device's busy share over 10 steps around epoch 0's end (a CUDA-only
    profiler window between two synchronisations); every rank's chain
    against the one-process runs ((a)'s, phase 20's), and the resumed run
    against (a)'s, within `MESH_TOL` (‖difference‖ / ‖one process‖ over a
    chain's samples: bf16 groups of K/2 chains round otherwise than
    groups of K); (d) `evaluate_model` over (a)'s 8-sample bank with
    `mesh=` (two positions on the card) against without: equal.

23. the Hessian spectrum of a posterior sample and the task queue: (a)
    `eff_dim` on full-width ResNet-20 at phase 9's last sample, the loss
    the potential at train=False over 2 batches of 128 fake_cifar10
    points in f32 (TF32 off): one Hessian-vector product on the card
    against the same product on the CPU in f64, taken on the card's ReLU
    masks (relative ‖·‖ gap `HVP_TOL`; the card's f64 product on those
    masks against the CPU's, `ROUTE_TOL`; the ReLU signs f32 flips and
    the gap they make printed), u·(Hv) against v·(Hu) (`SYM_TOL`),
    `hessian_eigs_positive_lanczos` with 50 iterations (max |QᵀQ − I| of
    the Ritz basis `ORTHO_TOL`, the top Ritz pair's ‖Hq − λq‖ / |λ| from
    one more product `RESIDUAL_TOL`, the top 3 Ritz values against a
    40-iteration run `CONVERGED_TOL`), the positive Ritz values' count
    and N_eff(z) at z = 1, 10, 100, ms a product, ms a Lanczos iteration
    by part (CUDA events), the spectrum's time and peak memory; (b) two
    `chip_smoke.py taskqueue` worker processes on the card share one
    jugdir and declare the same four `train_sgd` tasks (googleresnet on
    fake_cifar10 cut to 1,280 / 256, 2 epochs, stairs, seeds 0 and 1 ×
    lr 0.05 and 0.01), each task train_sgd's `main` in the worker's
    process: all four done, each claimed and run once, no lock left, each
    run COMPLETED with its `(T,)` launches the schedule's (2 × 10 + 1),
    every one at noise_std 0, and no other kernel's. `plot` and
    `notebook_utils` do no card work (and the card's machine has neither
    matplotlib nor pandas): the CPU tests hold them, and
    `run_script_task`'s `python -m` subprocess launch.
24. the paper-figure notebooks' compute (`experiments/figures.py`), without
    their plots (the card's machine has no matplotlib): (a) Figs 1-2:
    `classificationconvnet` at the CLI's width 50 and depth 3 trained on
    fake_mnist's 60,000 images by `sgd_weights` (`SGLDRunner` at
    temperature 0, 2 epochs, batch 128): `(T,)` launches the schedule's (2
    × 469 + 1), every one at noise_std 0, no other kernel; the weights
    finite, the first weight leaves' normal, Laplace and Student-t fits
    finite, each leaf's t df and the SGD step's ms (CUDA events) printed;
    (b) sampler health at ResNet-20's full width: `temperature_diagnostics`
    (`VerletSGLDRunner` at temperature 1, the notebook's 3 cycles of 4
    warmup and 4 sampling epochs, the CLI's lr and momentum) on
    fake_cifar10 cut to 1,280 images, its metrics through the in-memory
    stand-in: launches the schedule's, every leaf's kinetic and
    configurational temperatures finite, the χ² coverage computed and its
    95% counts over the sampling epochs printed, and the ms a step with
    and without the per-leaf diagnostics in turns (CUDA events); (c) the
    tempering curve from phase 20's K=30 sweep dirs
    (`notebook_utils.run_records`, `grid_matrix`, `tempering_curve`, no
    pandas, no launch): the 6 × 5 lp_ensemble matrix equal to phase 20's
    own per-chain results, bit for bit; (d) Figs 3, 4, 5 and A.10 from the
    port's fits copies on the host: shapes, finite values, symmetric
    covariances, the GenNorm β per layer printed.
25. `matmul_precision` on the card (`bnn_priors_tpu_torch/precision.py`):
    (a) the split kernel (`csrc/split_operand.cu`) against its plain
    version, bit for bit, into outputs filled with NaN, at ResNet-20's
    and resnet18's widest activations (n = 1, 2, 3 bf16 and f16 parts,
    X3's and X6's forward layouts), at odd offsets and an M that is not
    a multiple of 4, into an unaligned output, and in its table form on
    odd operands, on 70 operands (two launches) and on both models'
    weight tables at bfloat16, F16_F16_F32, X3 and X6; its device time a
    launch in a CUDA graph of 50 launches (CUDA events around 10
    replays), its host µs a call and the plain version's time beside the
    byte bound, at those activations (one part, X3, X6) and weight tables (one
    part, X3); the port's `Conv2d` and `Linear`, one chain and K chains, at
    ResNet-20's shapes, forward, dgrad and wgrad: TF32 against the
    float32 op (TF32 off) on TF32-rounded operands within two TF32 ulps
    of the magnitudes (the card may truncate where the reference rounds)
    plus 1e-5; bfloat16, F16_F16_F32, BF16_BF16_F32_X3, _X6, F16_F16_F16
    and F64_F64_F64 against a float64 emulation of their arithmetic on the
    same operands (the parts, the pairs, the result's rounding) within
    1e-5 of the magnitudes plus the result's rounding, float32 results
    (the repaired bfloat16's gradients not bf16 values), X3 within
    3·2^-16 + 1e-5 of the magnitudes of the exact product, X6 and float64
    within 1e-5; (b) full-width ResNet-20 at He-initialised
    parameters on 1,280 points and one batch of 128, with cuDNN's
    deterministic algorithms, at every mode against float32: float32 bit
    for bit the run without a mode; the minibatch gradient with float32's
    ReLU masks replayed and the exact pass's potential within
    `PRECISION_BOUNDS` relative L2 (2e-2 TF32, 1e-1 bf16, 2e-2 the f16
    modes, 1e-3 X3, 1e-4 X6 and float64); the gradient with its ReLUs free
    (a ReLU whose input changes sign moves it by O(1)) within half the
    minibatch noise ‖g(batch 2) − g(batch 1)‖ / ‖g(batch 1)‖; (c)
    `train_bnn` at BF16_BF16_F32_X3 (its other keys the defaults) on
    fake_cifar10 cut to 1,280 / 1,000, one cycle of 3 epochs (1 warmup, 2
    sampling): `(T,)` launches the schedule's (1 + 10 × 3 + 2 × 2), no
    other update kernel, split launches the schedule's (5,616: a weight
    table an evaluation, `RESNET20_SPLITS`), the forward products on bf16
    parts, M-H acceptance in [0, 1], a profiler window of 3 steps showing
    the split kernel, and the update kernel on the run's last state and
    an X3 gradient against its plain version (atol 1e-5, partials rtol
    1e-4); (d) ms a minibatch step (CUDA events, 15 steps) at the eight
    modes in turns (forwards, then backwards), the split kernel's
    launches a step, and a profiler window of 2 steps at float32,
    bfloat16, X3, X6 and float64 for the busy share, full-width ResNet-20
    and resnet18, one chain, batch 128.

It prints one JSON line describing every kernel (`launches` on the
runners' paths of phases 2, 6 and 16, `cli_launches` on the CLIs' of
phases 9 and 10, `resume_launches` on phase 13's and 16's resumed runs,
`hmc_launches` on phase 14's CLIs, `priors_launches` on phase 15's,
`segments_launches`/`segments_expected` on phase 16's (both packings;
the segments entries' `forms` hold device µs a launch over the ring and
hot at each of phase 16 (a)'s forms),
`chain_paths_launches`/`chain_paths_expected` on phase 17's, and
`mnist_launches`/`mnist_expected`, `uci_launches`/`uci_expected` and
`mnist_lengths` (a call, the plain version and the bound at this slice's
lengths) on phase 18's, and `preact_launches`/`preact_expected`,
`preact_lengths` and `preact_step` on phase 19's, and on the `(K, T)`
entry `sweep_launches`/`sweep_expected`, `sweep_kernel` (K=30: a call, back
to back, device µs, the plain version, the bound and its share),
`sweep_step` (ms a step at K=30 and K=8, chain-steps/s, the profiler
window, peak memory, the sweep's wall time) and `sweep_card_vs_cpu` on
phase 20's, and on the `(T,)` entry phase 21's `sgd_*`, `synthetic_*`,
`gaussian_*`, `test_gaussian_*` and `profile_*` launches and schedules,
`sgd_kernel` (thin_resnet18's T) and `raob_*`, and on the `(K, T)` entry
phase 22's `pipeline_*` (launches, epoch_s, wall_s, busy), `mesh_*`
(the ranks' launches, the resumed run's, their schedules, the gaps to
the one-process runs, `mesh_max_abs_err` of the kernel at K_d = 4 and
15), `chain_mesh` and `eval_*_ms`, and on the `(T,)` entry phase 23's
`taskqueue_launches`/`taskqueue_expected` and phase 24's
`figures_sgd_*` and `figures_diag_*` launches, schedules and step ms,
and phase 25's `precision_*`: the CLI's launches, schedule and
acceptance, the layers' largest relative error, (b)'s errors and (d)'s
ms a step and busy shares by model and mode; and the split kernel's
entry: `launches` on phase 2's path, `cli_launches` on phase 9's,
`x3_cli_launches` on phase 25 (c)'s, its launches a step by model and
mode, and its timing by size and layout),
then the card's name and power limit, and as its last line {"ok": true,
"device": {...}}.
"""
import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_TRAIN, N_TEST = 5000, 1000  # cut from CIFAR-10's 50,000/10,000 for time
RESUME_N = 640                # the resume phases' (13, 16 (e), 17 (e)) points
                              # (1,280 in PRs 11-12)
CLI_N_TRAIN, CLI_N_TEST = 50000, 10000  # the CLI's fake_cifar10, uncut
H100_BYTES_PER_S = 3.35e12    # HBM3 rate of one H100 SXM (data sheet)
H100_F32_OPS_PER_S = 67e12    # float32 rate outside the tensor cores
K_CHAINS = 8                  # the chain axis's bank on one card
PROFILE_STEPS = 3             # minibatch steps in a profiler window
CHAIN_TEMPS = [0.01, 0.1, 0.3, 1.0] * 2  # a tempering grid, twice
CU_SOURCE = "bnn_priors_tpu_torch/csrc/fused_update.cu"
# the CLI phases' run directories (git-ignored, emptied at their start)
RUNS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_runs")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


@contextlib.contextmanager
def alongside(*args, env=None, timeout=900):
    """`chip_smoke.py *args` in a process of its own while the block runs
    (its output into files under build/, so a full pipe never stalls it);
    yields a dict whose "proc" holds its CompletedProcess once the block
    is left. If the block raises, the process is killed."""
    build = os.path.dirname(RUNS_DIR)
    os.makedirs(build, exist_ok=True)
    out = {}
    with tempfile.TemporaryFile("w+", dir=build) as so, \
            tempfile.TemporaryFile("w+", dir=build) as se:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 *args], env=env, stdout=so, stderr=se,
                                text=True)
        t0 = time.perf_counter()
        try:
            yield out
            proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        so.seek(0)
        se.seek(0)
        out["proc"] = subprocess.CompletedProcess(proc.args, proc.returncode,
                                                  so.read(), se.read())


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


def events_ms(fn):
    "ms of one fn() between two CUDA events, synchronised"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


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
    """build every CUDA kernel from the checkout's sources, one nvcc each,
    started together; print ptxas's reports"""
    from bnn_priors_tpu_torch.ops import _cuda_lib
    from bnn_priors_tpu_torch.ops import split_operand as so
    t0 = time.perf_counter()
    paths = _cuda_lib.build_all()
    lib, seg = _cuda_lib.load(), _cuda_lib.load("fused_update_segments")
    split = _cuda_lib.load("split_operand")
    check(split.bnn_split_max_select() == so.MAX_SELECT,
          f"split kernel takes {split.bnn_split_max_select()} blocks a row")
    print(f"build: {', '.join(os.path.relpath(p) for p in paths.values())} in"
          f" {time.perf_counter() - t0:.1f} s ({' '.join(_cuda_lib.NVCC_FLAGS)}"
          f"), {lib.bnn_fused_update_threads()} threads a block; segments: "
          f"{seg.bnn_segments_threads()} threads, {seg.bnn_segments_chunk()} "
          f"flat elements a chunk, {seg.bnn_segments_piece_cols()} columns "
          f"a piece; split: {split.bnn_split_threads()} threads")
    for name in paths:
        report = [ln.strip() for ln in _cuda_lib.build_log(name=name
                                                           ).splitlines()
                  if "ptxas" in ln]
        entries = sum("Compiling entry" in ln for ln in report)
        # one line a distinct report (the split kernel's 32 instantiations
        # share a few), with how many kernels gave it
        lines = [ln.split("ptxas info    : ")[-1] for ln in report
                 if "registers" in ln or "spill" in ln or "stack" in ln]
        for ln in dict.fromkeys(lines):
            print(f"build {name}: {lines.count(ln)} of {entries} "
                  f"kernels: {ln}")
        check(any("registers" in ln for ln in report),
              f"no ptxas report for {name}")


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
    """SGLD mid step (momentum a, and the SGLD kernel's default 0), the
    three GGMC phases and HMC's mid step (momentum decay 1), noise_std
    forced to 0"""
    from bnn_priors_tpu_torch.mcmc import HMC, VerletSGLD
    k = VerletSGLD(num_data=N, momentum=a, rmsprop_alpha=alpha)
    out = {"sgld_mid": (a, -math.sqrt(lr * N), 0.0, math.sqrt(lr / N),
                        alpha),
           "sgld_a0_mid": (0.0, -math.sqrt(lr * N), 0.0, math.sqrt(lr / N),
                           alpha)}
    for kind in ("initial", "mid", "final"):
        bh, bhn, mom_decay, grad_v, _ = k._constants(lr, 1.0, kind)
        final = kind == "final"
        out["ggmc_" + kind] = (mom_decay, -0.5 * grad_v * bhn, 0.0,
                               0.0 if final else bh, 1.0 if final else alpha)
    bh, bhn, mom_decay, grad_v, _ = HMC(num_data=N)._constants(lr, 1.0, "mid")
    out["hmc_mid"] = (mom_decay, -0.5 * grad_v * bhn, 0.0, bh, alpha)
    return out


def with_sigma(coeffs, sigma):
    return coeffs[:2] + (sigma,) + coeffs[3:]


def compare_to_plain(label, ker, ref, pk, pr, total, atol, tails,
                     partial_atol=None):
    """θ, m, v within atol, padding tails 0, partials within rtol 1e-4
    (plus `partial_atol` where given: the allowance of a sum that cancels)"""
    torch.cuda.synchronize()
    errs = []
    for i, what in enumerate(("theta", "momentum", "square_avg")):
        err = float((ker[i] - ref[i]).abs().max())
        check(err <= atol, f"{label}: {what} off by {err} (atol {atol})")
        check(bool((tails(ker[i]) == 0).all()),
              f"{label}: {what} padding tail not zero")
        errs.append(err)
    d = (pk - pr).abs()
    rel = float((d / pr.abs().clamp_min(1e-30)).max())
    if partial_atol is None:
        check(rel <= 1e-4, f"{label}: partials {pk} vs {pr}")
    else:
        check(bool((d <= 1e-4 * pr.abs() + partial_atol).all()),
              f"{label}: partials {pk} vs {pr} (allowance {partial_atol})")
    return max(errs), rel


def partials_allowance(base, ref):
    """f32's rounding of a partial's summed magnitudes, 1e-7 · Σ|term| a
    partial (float64): at 11M random terms Σ(M·g)·m cancels to ~1e-6 of
    its magnitudes, where rtol alone would hold the sum's rounding to the
    cancelled value"""
    Mg = base[4].double() * base[3].double()
    return 1e-7 * torch.stack([(Mg * base[1].double()).abs().sum(-1),
                               (Mg * ref[1].double()).abs().sum(-1),
                               (Mg * Mg).sum(-1)], -1).float()


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
                reject_samples=True, seed=0, matmul_precision="float32")
    args.update(kw)
    return VerletSGLDRunnerReject(model, data.norm.train, data.norm.test,
                                  device=device, **args)


# split calls of one ResNet-20 evaluation (models/layers.py), by parts an
# operand: 22 multiplying layers (21 convolutions, the head); the forward
# splits their inputs, 20 (the two projection shortcuts take their block's
# input), the weights come split ahead, one table a minibatch step, exact
# pass or test pass; the backward splits each incoming gradient once at
# one part, and at P > 1 twice (dgrad, wgrad) and the input once (wgrad),
# the first layer's dgrad left out: 22 or 3 x 21 + 2 = 65
RESNET20_SPLITS = {1: (20, 22), 2: (20, 65), 3: (20, 65)}


def resnet20_splits(parts, steps, exact_passes, exact_batches, eval_passes,
                    eval_batches):
    """split launches of a ResNet-20 run: minibatch steps, exact passes
    of `exact_batches` batches in all, test passes of `eval_batches`"""
    fwd, bwd = RESNET20_SPLITS[parts]
    return (steps * (1 + fwd + bwd) + exact_passes + exact_batches
            * (fwd + bwd) + eval_passes + eval_batches * fwd)


def runner_splits(runner, n_test):
    """the split launches a one-cycle VerletSGLDRunnerReject run makes at
    one part"""
    boundaries = sum(runner._is_sampling_epoch(e)
                     for e in range(runner.epochs_per_cycle))
    epochs = runner.epochs_per_cycle
    return resnet20_splits(
        1, runner.steps_per_epoch * epochs, 1 + boundaries,
        (1 + boundaries) * runner.steps_per_epoch, epochs,
        epochs * -(-n_test // runner.eval_batch_size))


def reset_counts(fu):
    from bnn_priors_tpu_torch.ops import split_operand as so
    so.launches = 0
    fu.launches = fu.chain_launches = 0
    fu.triton_launches = fu.triton_chain_launches = 0
    fu.segments_launches = fu.segments_chain_launches = 0


def phase_main_path(fu):
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    from bnn_priors_tpu_torch.experiments import train_bnn
    print(f"main path: fake_cifar10 n_train={N_TRAIN} (cut from 50,000 for "
          f"time), n_test={N_TEST}; googleresnet depth 20, batch 128")
    data = get_data("fake_cifar10", n_train=N_TRAIN, n_test=N_TEST)
    model = get_model("googleresnet", weight_prior="gaussian",
                      weight_scale=2 ** 0.5)
    he_initialize(model, torch.Generator().manual_seed(0))
    # the CLI's default matmul_precision (bfloat16 operands), as train_bnn
    # passes it on the card
    precision = train_bnn.DEFAULTS["matmul_precision"]
    runner = make_runner(data, model, "cuda", matmul_precision=precision)
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
    from bnn_priors_tpu_torch.ops import split_operand as so
    splits = so.launches

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
    # the default mode splits every float32 product's operands, the
    # weights once an evaluation
    split_expected = runner_splits(runner, N_TEST)
    check(splits == split_expected, f"split launches {splits} at "
          f"{precision}, the schedule implies {split_expected}")
    print(f"main path ok in {wall:.1f} s: potentials {pots[0]:.4f} -> "
          f"{pots[-1]:.4f}, boundary dE {b['delta_energy']:.4f} rejected "
          f"{b['rejected']}, test acc {ev['test/acc']:.4f} loss "
          f"{ev['test/loss']:.4f}, CUDA kernel launches {launches} == "
          f"{expected}, Triton launches 0, split launches {splits} == "
          f"{split_expected}, "
          f"matmul_precision {precision}")
    return runner, launches, splits, data


# ---------------------------------------------------------------- phase 3 --
def phase_reference(packing="flat"):
    """T=0 run on a small input: card f32 (kernel) vs CPU f64 (plain
    version), with the chain state packed `packing`"""
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
                        learning_rate=1e-3, packing=packing)
        r.run()
        out[device] = (r.kernel.params_of(r.chain), r.potentials,
                       r.boundaries[0]["delta_energy"])
    (pc, potc, dec), (pr, potr, der) = out["cuda"], out["cpu"]
    err = max(float((pc[k].double().cpu() - pr[k]).abs().max()) for k in pr)
    check(err < 1e-3, f"card vs CPU params differ by {err}")
    check(np.allclose(potc, potr, rtol=1e-4, atol=1e-4),
          f"potentials {potc} vs {potr}")
    print(f"reference check ok ({packing}): params max |card f32 - CPU f64| "
          f"{err:.2e}, boundary dE {dec:.6f} vs {der:.6f}")
    return err


# ---------------------------------------------------------------- phase 4 --
def phase_step_time(runner, n=25, temperature=1.0):
    "ms per minibatch step of the main path (gradient + fused update)"
    perm = torch.randperm(runner.N, device=runner.device)
    B = runner.batch_size

    def steps(n):
        for i in range(n):
            runner._plain_step(perm[(i % runner.n_full) * B:
                                    (i % runner.n_full + 1) * B], i,
                               temperature)
    steps(5)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    steps(n)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def phase_step_parts(data, model, card):
    """the single-chain step as the CLI runs it: with a metrics saver (the
    per-leaf diagnostics each step), then with augmentation too, beside the
    bare step of phase 4, in turns (bare, +metrics, +augment, +augment,
    +metrics, bare)"""
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    variants = {"bare": {}, "+metrics": {"metrics_saver": MemMetrics(None)},
                "+augment": {"metrics_saver": MemMetrics(None),
                             "augment_fn": FakeCIFAR10.augment_fn}}
    res = {k: [] for k in variants}
    for name in ("bare", "+metrics", "+augment", "+augment", "+metrics",
                 "bare"):
        ms = phase_step_time(make_runner(data, model, "cuda",
                                         **variants[name]))
        res[name].append(ms)
        print(f"step parts ({name:8s}): {ms:.3f} ms per minibatch step "
              f"(f32, batch 128, ResNet-20) on {card}")
    return {k: float(np.mean(v)) for k, v in res.items()}


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


def window_counts(prof, n):
    "host ops, kernels and kernel ms a step of an `n`-step profiler window"
    from torch.autograd import DeviceType
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    return (sum(e.count for e in ev if e.device_type == DeviceType.CPU) / n,
            sum(e.count for e in kernels) / n,
            sum(e.self_device_time_total for e in kernels) / 1e3 / n)


def print_window(prof, n, step_ms, tag):
    """a profiler window of `n` steps: kernels and their device time a step
    against `step_ms`, the top kernels, and the host's ops a step with the
    ones that take most of its time"""
    from torch.autograd import DeviceType
    ev = prof.key_averages()
    kernels = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                      for e in ev if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3 / n, e.count / n, e.key)
                   for e in ev if e.device_type == DeviceType.CPU),
                  reverse=True)
    total = sum(k[0] for k in kernels)
    print(f"{tag}: {sum(k[1] for k in kernels):.0f} kernels, {total:.3f} ms "
          f"of kernel time a step over {step_ms:.3f} ms a step: device busy "
          f"{total / step_ms:.1%}" if total else
          f"{tag}: no device time recorded (not measured)")
    for ms, count, key in kernels[:8]:
        print(f"{tag}:   {ms:8.4f} ms/step {count:5.1f} calls/step  "
              f"{key[:80]}")
    print(f"{tag}: host {sum(h[1] for h in host):.0f} profiled ops a step, "
          f"{sum(h[0] for h in host):.3f} ms of their own host time a step")
    for ms, count, key in host[:10]:
        print(f"{tag}:   host {ms:8.4f} ms/step {count:6.1f} calls/step  "
              f"{key[:70]}")


def window_summary(prof, n, step_ms, window_ms):
    """a window of `n` steps in numbers: kernels, kernel ms and host ops a
    step, the busy share against `step_ms` and against the window's own ms
    a step (events around the profiled steps), and the update kernels'
    device µs a launch, launches and ms a step (None where none ran)"""
    from torch.autograd import DeviceType
    host, kernels, kernel_ms = window_counts(prof, n)
    upd = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and "langevin_update" in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in upd) / n
    upd_ms = sum(e.self_device_time_total for e in upd) / 1e3 / n
    return {"kernels": kernels, "kernel_ms": kernel_ms, "host_ops": host,
            "step_ms": step_ms, "busy": kernel_ms / step_ms,
            "window_ms": window_ms, "busy_window": kernel_ms / window_ms,
            "update_us": upd_ms * 1e3 / count if count else None,
            "update_launches": count, "update_ms": upd_ms,
            "update_share": upd_ms / step_ms}


def phase_profile(runner, step_ms, label="cuda", n=PROFILE_STEPS):
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
        window_ms = events_ms(run) / n
    # kernels only: an aten op's device time is its kernels' time again
    kernels = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    print_window(prof, n, step_ms, f"profile ({label} update)")
    for ms, count, key in kernels:
        if "langevin_update" in key:
            print(f"profile ({label} update): update kernel "
                  f"{ms / count * 1e3:.2f} us a launch on the device, "
                  f"{count:.0f} a step")
    return window_summary(prof, n, step_ms, window_ms)


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
def chain_step_ms(runner, n=25):
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


def phase_chain_profile(runner, step_ms, label="cuda", n=PROFILE_STEPS):
    "device busy share of K=8 chain steps, and the kernels that take it"
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    idxs = runner._epoch_idxs(0, 0)
    temps = runner._temps_for(runner.epochs_per_cycle - 1)
    run = lambda: [runner._chain_step(idxs[:, i % runner.n_full], i, temps)
                   for i in range(n)]
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window_ms = events_ms(run) / n
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
          f"{step_ms:.3f} ms per step: device busy {total / step_ms:.1%} "
          f"({total / window_ms:.1%} of the window's own {window_ms:.3f} ms "
          f"a step); host {window_counts(prof, n)[0]:.0f} profiled ops a "
          "step")
    for ms, count, key in kernels[:12]:
        print(f"{tag}:   {ms:8.4f} ms/step {count:5.1f} calls/step  "
              f"{key[:80]}")
    for ms, count, key in kernels:
        if "langevin_update" in key:
            print(f"{tag}: update kernel {ms / count * 1e3:.2f} us a launch "
                  f"on the device, {count:.0f} a step")
    return window_summary(prof, n, step_ms, window_ms)


# ------------------------------------------------------- phases 9-12: CLIs --
class MemMetrics:
    """stand-in for `HDF5Metrics` where h5py is absent: the same calls,
    rows kept in memory, written on close as an .npz at the same path (the
    file format itself is held by the CPU tests)"""

    def __init__(self, path, mode="w", chunk_size=8 * 1024):
        self.path, self.rows = path, {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_scalar(self, name, value, step):
        self.rows.setdefault(name, {})[int(step)] = value
        return self

    def add_rows(self, columns, steps):
        for name, vals in columns.items():
            for s, v in zip(np.asarray(steps), np.asarray(vals)):
                self.add_scalar(name, v, s)
        return self

    def flush(self, every_s=0, keep_last_row=False):
        pass

    def close(self):
        steps = sorted({s for col in self.rows.values() for s in col})
        out = {"steps": np.asarray(steps, dtype=np.int64)}
        for name, col in self.rows.items():
            out[name] = np.asarray([col.get(s, math.nan) for s in steps],
                                   dtype=np.float64)
        with open(self.path, "wb") as f:
            np.savez(f, **out)


class MemModelSaver:
    "stand-in for `HDF5ModelSaver` where h5py is absent (see MemMetrics)"

    def __init__(self, path, mode="w"):
        self.path, self.bank, self.steps = path, {}, []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_state_dict(self, state_dict, step):
        for k, v in state_dict.items():
            self.bank.setdefault(k, []).append(np.array(v))
        self.steps.append(int(step))

    def flush(self):
        pass

    def load_samples(self, keep_steps=True):
        out = {k: np.stack(v) for k, v in self.bank.items()}
        if keep_steps:
            out["steps"] = np.asarray(self.steps, dtype=np.int64)
        return out

    def close(self):
        with open(self.path, "wb") as f:
            np.savez(f, **self.load_samples())


def mem_load_samples(path, keep_steps=False):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if keep_steps or k != "steps"}


def mem_load_metrics(path, keys):
    with np.load(path) as f:
        return {k: f[k] for k in keys if k in f.files}


def mem_plot_metrics(path):
    "`plot.load_metrics` of a MemMetrics file: 'group/name' series nested"
    out = {}
    with np.load(path) as f:
        for k in f.files:
            group, _, name = k.partition("/")
            if name:
                out.setdefault(group, {})[name] = f[k]
            else:
                out[k] = f[k]
    return out


def hdf5_or_stand_in():
    """the CLIs' run files: HDF5 where h5py imports; else the in-memory
    stand-ins above take the place of the port's io names, which the CLIs
    look up at call time (the CLIs themselves raise without h5py)"""
    from bnn_priors_tpu_torch import io, plot
    if io.HAVE_H5PY:
        print("h5py: present")
        return
    print("h5py: absent (the CLI phases write their run files through "
          "in-memory stand-ins; the HDF5 format is held by the CPU tests)")
    io.HDF5Metrics, io.HDF5ModelSaver = MemMetrics, MemModelSaver
    io.load_samples, io.load_metrics = mem_load_samples, mem_load_metrics
    plot.load_metrics = mem_plot_metrics


@contextlib.contextmanager
def timed(owner, name, seconds):
    """`owner.name` wrapped: each call between two device synchronisations,
    its host seconds appended to `seconds`"""
    orig, own = getattr(owner, name), name in vars(owner)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    setattr(owner, name, wrapper)
    try:
        yield seconds
    finally:
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


@contextlib.contextmanager
def profiled_calls(owner, name, first, n, out):
    """`owner.name` wrapped: its calls `first` .. `first + n - 1` (counted
    from 0) run in one torch.profiler window between two device
    synchronisations; `out` gets the profile and the window's seconds"""
    from torch.profiler import ProfilerActivity, profile
    orig, own = getattr(owner, name), name in vars(owner)
    calls = [0]

    def wrapper(*args, **kwargs):
        i = calls[0]
        calls[0] += 1
        if i == first:
            torch.cuda.synchronize()
            out["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            out["prof"].__enter__()
            out["t0"] = time.perf_counter()
        result = orig(*args, **kwargs)
        if i == first + n - 1:
            torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - out["t0"]
            out["prof"].__exit__(None, None, None)
        return result
    setattr(owner, name, wrapper)
    try:
        yield out
    finally:
        if "t0" in out and "seconds" not in out:
            out["prof"].__exit__(None, None, None)
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


def cli_config(module, **kw):
    "a CLI's defaults with `kw`, without the per-epoch progress lines"
    cfg = dict(module.DEFAULTS)
    cfg.update(progressbar=False, **kw)
    return cfg


def phase_cli_single(fu, card):
    """the paper's command on the card: train_bnn with data=fake_cifar10
    model=googleresnet inference=VerletSGLDReject at the CLI's own data size
    (50,000 / 10,000), augmentation on, one cycle of 2 epochs"""
    from bnn_priors_tpu_torch import evaluate, io
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.experiments import train_bnn
    from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject as R
    cfg = cli_config(train_bnn, data="fake_cifar10", model="googleresnet",
                     inference="VerletSGLDReject", reject_samples=True,
                     cycles=1, warmup=1, burnin=0, n_samples=1, skip_first=0,
                     log_dir=os.path.join(RUNS_DIR, "single"))
    n_train, n_test, B = CLI_N_TRAIN, CLI_N_TEST, cfg["batch_size"]
    steps_per_epoch = -(-n_train // B)
    epochs = cfg["warmup"] + cfg["burnin"] + cfg["n_samples"] // cfg["cycles"]
    boundaries = cfg["n_samples"]
    expected = 1 + steps_per_epoch * epochs + 2 * boundaries
    print(f"cli single chain: train_bnn with data=fake_cifar10 (n_train "
          f"{n_train}, n_test {n_test}, augmented) model=googleresnet "
          f"inference=VerletSGLDReject reject_samples=True cycles=1 warmup=1 "
          f"n_samples=1 batch_size={B} metrics_skip={cfg['metrics_skip']}")
    t = {k: [] for k in ("exact", "final", "eval", "initial", "evaluate",
                         "augment")}
    with contextlib.ExitStack() as stack:
        for owner, name, key in ((R, "_exact_vg", "exact"),
                                 (R, "_boundary_final", "final"),
                                 (R, "_evaluate_and_log", "eval"),
                                 (R, "_boundary_initial", "initial"),
                                 (evaluate, "evaluate_model", "evaluate")):
            stack.enter_context(timed(owner, name, t[key]))
        # a window of minibatch steps in the middle of epoch 1 (epoch 0's
        # time is the one reported; the boundary comes after the window)
        window = stack.enter_context(profiled_calls(
            R, "_plain_step",
            steps_per_epoch + (steps_per_epoch - PROFILE_STEPS) // 2,
            PROFILE_STEPS, {}))
        reset_counts(fu)
        t0 = time.perf_counter()
        result = train_bnn.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, chain = fu.launches, fu.chain_launches
        triton = fu.triton_launches + fu.triton_chain_launches
        from bnn_priors_tpu_torch.ops import split_operand as so
        splits = so.launches
    run_dir = os.path.join(cfg["log_dir"], "1")
    with open(os.path.join(run_dir, "run.json")) as f:
        run = json.load(f)
    check(run["status"] == "COMPLETED" and run["result"] == result,
          f"run.json {run['status']}")
    check(sorted(os.listdir(run_dir)) == ["config.json", "metrics.h5",
                                          "run.json", "samples.pt"],
          f"run dir {os.listdir(run_dir)}")
    m = io.load_metrics(os.path.join(run_dir, "metrics.h5"),
                        ["potential", "timings/epoch_s", "timings/steps_per_s",
                         "acceptance/rejected", "delta_energy", "test/acc"])
    pots = m["potential"][~np.isnan(m["potential"])]
    check(len(pots) > 2 * steps_per_epoch // cfg["metrics_skip"]
          and np.all(np.isfinite(pots)), "CLI potentials")
    check(all(np.isfinite(v) for v in result.values()), f"result {result}")
    check(launches == expected and chain == 0 and triton == 0,
          f"CLI launches {launches} ((K, T) {chain}, Triton {triton}), the "
          f"schedule implies {expected}")
    split_expected = resnet20_splits(
        1, steps_per_epoch * epochs, 1 + boundaries,
        (1 + boundaries) * steps_per_epoch, epochs,
        epochs * -(-n_test // B))
    check(splits == split_expected, f"CLI split launches {splits} at the "
          f"default matmul_precision {cfg['matmul_precision']}, the schedule "
          f"implies {split_expected}")
    bank = io.load_samples(os.path.join(run_dir, "samples.pt"),
                           keep_steps=True)
    check(len(bank["steps"]) == boundaries, f"bank steps {bank['steps']}")

    # augmentation: CUDA events around the CLI's own augment_fn on a batch
    data = FakeCIFAR10(n_train=B, n_test=1)
    gen = torch.Generator(device=data.norm.train[0].device).manual_seed(0)
    aug_ms = time_ms(lambda: FakeCIFAR10.augment_fn(data.norm.train[0], gen),
                     100)
    epoch_s = m["timings/epoch_s"][~np.isnan(m["timings/epoch_s"])]
    # epoch 0 has no boundary: its minibatch steps, then the test pass
    steps_s = epoch_s[0] - t["eval"][0]
    boundary_s = t["final"][0] + t["eval"][1] + t["initial"][0]
    out = {"wall_s": wall, "epoch_ms": 1e3 * epoch_s[0],
           "steps_ms": 1e3 * steps_s, "steps_per_s": steps_per_epoch / steps_s,
           "aug_ms": aug_ms,
           "aug_share": aug_ms * steps_per_epoch / (1e3 * steps_s),
           "exact_ms": 1e3 * t["exact"][0], "final_ms": 1e3 * t["final"][0],
           "eval_ms": 1e3 * t["eval"][1], "initial_ms": 1e3 * t["initial"][0],
           "boundary_ms": 1e3 * boundary_s,
           "evaluate_model_ms": 1e3 * t["evaluate"][0],
           "launches": launches, "expected": expected, "result": result,
           "run_dir": run_dir, "split_launches": splits}
    print(f"cli single chain ok in {wall:.1f} s: run.json COMPLETED, result "
          f"{json.dumps(result)}, CUDA launches {launches} == {expected} = 1 "
          f"+ {steps_per_epoch} x {epochs} + 2 x {boundaries}, (K, T) 0, "
          f"Triton 0, split launches {splits} == {split_expected}")
    print(f"cli single chain on {card}: epoch 0 {out['epoch_ms']:.1f} ms "
          f"(CLI timings/epoch_s; logged steps/s "
          f"{m['timings/steps_per_s'][~np.isnan(m['timings/steps_per_s'])][0]:.1f}"
          f"), of which {steps_per_epoch} minibatch steps {out['steps_ms']:.1f}"
          f" ms = {out['steps_per_s']:.1f} steps/s and the test pass "
          f"{1e3 * t['eval'][0]:.1f} ms; augmentation {aug_ms:.4f} ms a batch "
          f"of {B} (CUDA events) = {out['aug_share']:.2%} of the steps")
    out["window_ms"] = 1e3 * window["seconds"] / PROFILE_STEPS
    print_window(window["prof"], PROFILE_STEPS, out["window_ms"],
                 "cli single chain profile (epoch 1, ms a step under the "
                 "profiler)")
    print(f"cli single chain on {card}: M-H boundary {out['boundary_ms']:.1f}"
          f" ms = exact gradient + final step + dE + decision "
          f"{out['final_ms']:.1f} ms (of which the exact pass "
          f"{1e3 * t['exact'][1]:.1f} ms) + test pass of {n_test} points "
          f"{out['eval_ms']:.1f} ms + initial step {out['initial_ms']:.3f} ms;"
          f" the run's first exact pass {out['exact_ms']:.1f} ms; "
          f"evaluate_model over the bank {out['evaluate_model_ms']:.1f} ms")
    return out


def phase_cli_chains(fu, card):
    """train_bnn with n_chains=8 compute_dtype=bfloat16 on the card, data
    cut to n_train 5,000 (as phases 6-8) through the CLI's data registry"""
    from bnn_priors_tpu_torch import exp_utils, io
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.experiments import train_bnn
    K = K_CHAINS
    cfg = cli_config(train_bnn, data="fake_cifar10", model="googleresnet",
                     inference="VerletSGLDReject", reject_samples=True,
                     n_chains=K, compute_dtype="bfloat16", temperature=1.0,
                     cycles=1, warmup=1, burnin=0, n_samples=1, skip_first=0,
                     log_dir=os.path.join(RUNS_DIR, "chains"))
    n_full = N_TRAIN // cfg["batch_size"]
    expected = 1 + n_full * 2 + 2
    print(f"cli chains: train_bnn with n_chains={K} compute_dtype=bfloat16 "
          f"temperature=1.0 inference=VerletSGLDReject reject_samples=True, "
          f"fake_cifar10 cut to n_train {N_TRAIN}, n_test {N_TEST}")
    real = exp_utils.get_data_seeded
    exp_utils.get_data_seeded = lambda name, seed, device="cuda": FakeCIFAR10(
        n_train=N_TRAIN, n_test=N_TEST, seed=int(seed), device=device)
    try:
        reset_counts(fu)
        t0 = time.perf_counter()
        summary = train_bnn.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, single = fu.chain_launches, fu.launches
        triton = fu.triton_launches + fu.triton_chain_launches
    finally:
        exp_utils.get_data_seeded = real
    check(summary["n_diverged"] == 0 and len(summary["chain_dirs"]) == K,
          f"chains {summary['n_diverged']} diverged")
    banks = []
    for c, d in enumerate(summary["chain_dirs"]):
        with open(os.path.join(d, "run.json")) as f:
            run = json.load(f)
        res = run["result"]
        check(run["status"] == "COMPLETED" and res["chain_index"] == c
              and 0.0 <= res["acceptance"] <= 1.0
              and math.isfinite(res["lp_ensemble"]), f"chain {c}: {run}")
        m = io.load_metrics(os.path.join(d, "metrics.h5"),
                            ["potential", "exact/potential",
                             "acceptance/rejected"])
        check(all(np.all(np.isfinite(v[~np.isnan(v)])) and
                  (~np.isnan(v)).any() for v in m.values()),
              f"chain {c} metrics")
        banks.append(io.load_samples(os.path.join(d, "samples.pt")))
    check(all(math.isfinite(v) for v in summary["pooled"].values()),
          f"pooled {summary['pooled']}")
    check(launches == expected and single == 0 and triton == 0,
          f"CLI (K, T) launches {launches} ((T,) {single}, Triton {triton}),"
          f" the schedule implies {expected}")
    print(f"cli chains ok in {wall:.1f} s on {card}: {K} run dirs COMPLETED, "
          f"acceptance {[r['acceptance'] for r in summary['chains']]}, pooled "
          f"{json.dumps(summary['pooled'])}, (K, T) CUDA launches {launches} "
          f"== {expected} = 1 + {n_full} x 2 + 2, (T,) 0, Triton 0")
    bank = {k: np.concatenate([b[k] for b in banks]) for k in banks[0]}
    return {"launches": launches, "expected": expected, "wall_s": wall,
            "bank": bank}


def phase_cli_eval(single):
    "eval_bnn on the single-chain run dir, on the card, with calibration"
    from bnn_priors_tpu_torch.experiments import eval_bnn
    cfg = cli_config(eval_bnn, run_dir=single["run_dir"], skip_first=0,
                     calibration_eval=True,
                     log_dir=os.path.join(RUNS_DIR, "eval"))
    t0 = time.perf_counter()
    out = eval_bnn.main(cfg)
    wall = time.perf_counter() - t0
    for k, v in single["result"].items():
        check(math.isclose(out[k], v, rel_tol=1e-5, abs_tol=0),
              f"eval_bnn {k} {out[k]} vs the CLI's {v}")
    check(0.0 <= out["ece"] <= 1.0 and {"ace", "rmsce"} <= set(out),
          f"calibration {out}")
    print(f"cli eval_bnn ok in {wall:.1f} s: {json.dumps(out)} (the CLI's "
          f"result within rtol 1e-5)")


def phase_eval_card_vs_cpu(bank, n=128):
    """`evaluate_model` over the K-chain CLI's pooled bank on the first `n`
    test points: on the card in float32 and on the CPU in float64"""
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.evaluate import metrics
    from bnn_priors_tpu_torch.exp_utils import get_model
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        data = FakeCIFAR10(dtype="float64" if device == "cpu" else "float32",
                           n_train=N_TRAIN, n_test=N_TEST, device=device)
        x, y = (t[:n] for t in data.norm.test)
        model = get_model("googleresnet", dtype=dtype, device=device)
        lps, preds = metrics._predict_all(model, x, y, bank, batch_size=128)
        res = metrics.evaluate_model(model, (x, y), bank, batch_size=128,
                                     calibration_eval=True)
        out[device] = lps, preds, res
    (lc, pc, rc), (lr, pr, rr) = out["cuda"], out["cpu"]
    err = max(float(np.abs(lc - lr).max()), float(np.abs(pc - pr).max()))
    check(err < 1e-4, f"evaluation card f32 vs CPU f64: log-probs off by {err}")
    for k in ("lp_ensemble", "lp_last"):
        check(abs(rc[k] - rr[k]) < 1e-4, f"{k} {rc[k]} vs {rr[k]}")
    for k in ("acc_ensemble", "acc_last"):  # a near tie may flip one point
        check(abs(rc[k] - rr[k]) <= 1.0 / n, f"{k} {rc[k]} vs {rr[k]}")
    print(f"evaluation card f32 vs CPU f64 ok: {lc.shape[0]} samples x {n} "
          f"points, log-probs max |d| {err:.2e}; card {json.dumps(rc)}; "
          f"CPU {json.dumps(rr)}")


# ------------------------------------------------------- phase 13: resume --
RESUME_VECTORS = ("position", "momentum", "square_avg", "precond")
RESUME_TAG = "resume-deterministic:"  # the subprocess's result line


def fresh_model():
    "full-width ResNet-20, gaussian priors, one He init (seed 0)"
    from bnn_priors_tpu_torch.exp_utils import get_model, he_initialize
    model = get_model("googleresnet", weight_prior="gaussian",
                      weight_scale=2 ** 0.5)
    return he_initialize(model, torch.Generator().manual_seed(0))


def resume_runs(fu, kind, data, path, packing="flat"):
    """phase 13's four runs of one configuration (`kind` "single": one
    chain in f32; "chains": K=8 in bf16), two cycles of 2 epochs (1 warmup,
    1 sampling): (a) uninterrupted, (b) the same again, (c) stopped after
    epoch 2 with its checkpoint (cycles lowered on the runner), (d) a fresh
    runner of another seed resumed from (c)'s file. Returns the runs, the
    checkpoint's write and read seconds and (d)'s launches."""
    from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
    from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject
    single = kind == "single"
    cls = VerletSGLDRunnerReject if single else MultiChainRunnerReject

    def make(seed=0, **kw):
        if single:
            return make_runner(data, fresh_model(), "cuda", cycles=2,
                               seed=seed, packing=packing, **kw)
        return make_chain_runner(data, fresh_model(), "cuda", K_CHAINS,
                                 cycles=2, seed=seed, packing=packing)
    runs = {}
    for name in ("a", "b"):
        runs[name] = make()
        runs[name].run()
    writes, reads = [], []
    with timed(cls, "save_checkpoint", writes), \
            timed(cls, "restore_checkpoint", reads):
        if single:
            runs["c"] = make(checkpoint_path=path, checkpoint_every=1)
            runs["c"].cycles = 1
            runs["c"].run()
        else:
            runs["c"] = make()
            runs["c"].cycles = 1
            runs["c"].run(checkpoint_path=path, checkpoint_every=1)
        runs["d"] = make(seed=1)
        reset_counts(fu)
        runs["d"].run(resume_from=path)
        torch.cuda.synchronize()
        launches = (fu.launches, fu.chain_launches,
                    fu.triton_launches + fu.triton_chain_launches,
                    fu.segments_launches, fu.segments_chain_launches)
    return runs, writes, reads, launches


def resume_gaps(kind, runs):
    """max |x − y| between (a) and (b) and between (a) and (d): the four
    state vectors, the last sample, ΔE and the count of differing M-H
    decisions"""
    single = kind == "single"
    state = (lambda r: r.chain) if single else (lambda r: r.chains)

    def last_sample(r):
        if single:
            return {k: v[-1] for k, v in r.get_samples().items()}
        position, bufs, _ = r._samples[-1]
        return {"position": buffer_of(position), **bufs}

    def decisions(r):
        if single:
            return (np.asarray([b["rejected"] for b in r.boundaries]),
                    np.asarray([b["delta_energy"] for b in r.boundaries]))
        return np.stack(r.rejections), np.stack(r.delta_energies)

    out = {}
    for x, y in (("a", "b"), ("a", "d")):
        rx, ry = runs[x], runs[y]
        gap = {v: float((buffer_of(getattr(state(rx), v)).double()
                         - buffer_of(getattr(state(ry), v)).double()
                         ).abs().max()) for v in RESUME_VECTORS}
        sx, sy = last_sample(rx), last_sample(ry)
        gap["sample"] = max(float(np.abs(np.asarray(sx[k], np.float64)
                                         - np.asarray(sy[k], np.float64)
                                         ).max()) for k in sx)
        (dx, ex), (dy, ey) = decisions(rx), decisions(ry)
        n = len(dy)  # a resumed single chain decides only after the resume
        gap["decisions"] = int((dx[-n:] != dy).sum())
        gap["delta_energy"] = float(np.abs(ex[-n:] - ey).max())
        out[x + y] = gap
    return out


def buffer_of(v):
    """a state vector as one tensor: itself, or a SegVec's segments end to
    end (the buffer's gaps between them are never read)"""
    if torch.is_tensor(v):
        return v
    return torch.cat([t.reshape(-1) for t in v.leaves])


def resume_phase_runs(fu, data, tag, packing="flat"):
    """both configurations' runs and gaps; prints them under `tag`"""
    out = {}
    os.makedirs(RUNS_DIR, exist_ok=True)
    for kind in ("single", "chains"):
        path = os.path.join(RUNS_DIR, f"{kind}.{tag}.ckpt.npz")
        t0 = time.perf_counter()
        runs, writes, reads, launches = resume_runs(fu, kind, data, path,
                                                    packing)
        gaps = resume_gaps(kind, runs)
        out[kind] = {"gaps": gaps, "bytes": os.path.getsize(path),
                     "write_s": writes, "read_s": reads,
                     "launches": launches,
                     "wall_s": time.perf_counter() - t0}
        for pair, gap in gaps.items():
            print(f"resume {tag} {kind}: max |({pair[0]}) - ({pair[1]})| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in gap.items()))
    return out


def resume_deterministic_main(packing="flat"):
    """phase 13's deterministic half (phase 16 (e)'s with `packing`
    "hybrid"), in its own process: cuBLAS's workspace is set before CUDA
    starts (by the caller's environment), cuDNN's deterministic algorithms
    on and autotuning off, and every op that has no deterministic CUDA
    implementation warns (recorded)"""
    import warnings
    from bnn_priors_tpu_torch.exp_utils import get_data
    from bnn_priors_tpu_torch.ops import fused_update as fu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    data = get_data("fake_cifar10", n_train=RESUME_N, n_test=N_TEST)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = resume_phase_runs(fu, data, f"deterministic-{packing}",
                                packing)
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    print(RESUME_TAG, json.dumps({"runs": out, "nondeterministic_ops": ops}))
    return 0


def phase_resume(fu, card):
    """resume on the card: one chain (f32) and K=8 chains (bf16), each as
    (a)-(d) of `resume_runs`, once with deterministic algorithms (in a
    subprocess) and once at the default settings (here)"""
    print(f"resume: fake_cifar10 n_train={RESUME_N}, n_test={N_TEST}; "
          f"googleresnet depth 20; VerletSGLDRunnerReject f32 and "
          f"MultiChainRunnerReject K={K_CHAINS} bf16, cycles=2 warmup=1 "
          "n_samples=2, checkpoint_every=1")
    from bnn_priors_tpu_torch.exp_utils import get_data
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    # the deterministic half in its own process while the default half
    # runs here: neither's checks read a time
    with alongside("resume-deterministic", env=env) as sub:
        data = get_data("fake_cifar10", n_train=RESUME_N, n_test=N_TEST)
        default = resume_phase_runs(fu, data, "default")
    proc = sub["proc"]
    for ln in proc.stdout.splitlines():
        if not ln.startswith(RESUME_TAG):
            print(ln)
    check(proc.returncode == 0, f"deterministic resume subprocess failed "
          f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    det = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith(RESUME_TAG)][-1][len(RESUME_TAG):])
    print(f"resume deterministic: subprocess and default half "
          f"{time.perf_counter() - t0:.1f} s, ops without a deterministic "
          f"CUDA implementation: {det['nondeterministic_ops'] or 'none'}")
    for kind, res in det["runs"].items():
        ab, ad = res["gaps"]["ab"], res["gaps"]["ad"]
        if det["nondeterministic_ops"]:
            # held to the run-to-run spread instead of bit equality
            check(all(ad[k] <= ab[k] for k in ad),
                  f"deterministic resume {kind}: (a)-(d) {ad} beyond the "
                  f"(a)-(b) spread {ab}")
        else:
            check(all(v == 0 for v in ad.values()),
                  f"deterministic resume {kind}: (a)-(d) {ad} not bitwise")
    out = {}
    for kind, res in default.items():
        # (d) runs epochs 2 and 3, and the boundary after epoch 3
        single, chain, triton, *segments = res["launches"]
        ours, other = (single, chain) if kind == "single" else (chain, single)
        steps = -(-RESUME_N // 128) if kind == "single" else RESUME_N // 128
        expected = steps * 2 + 2
        check(ours == expected and other == 0 and triton == 0
              and sum(segments) == 0,
              f"resumed {kind}: launches {ours} (the other form {other}, "
              f"Triton {triton}), the schedule implies {expected}")
        launches = ours
        det_res = det["runs"][kind]
        print(f"resume {kind} on {card}: checkpoint {res['bytes']:,} bytes; "
              f"write {', '.join(f'{1e3 * s:.1f}' for s in res['write_s'])}"
              f" ms, read {1e3 * res['read_s'][0]:.1f} ms (default); write "
              f"{', '.join(f'{1e3 * s:.1f}' for s in det_res['write_s'])} "
              f"ms, read {1e3 * det_res['read_s'][0]:.1f} ms "
              f"(deterministic; the two halves at once); resumed run's CUDA launches {launches} == "
              f"{expected} = {steps} x 2 + 2")
        out[kind] = {"launches": launches, "expected": expected,
                     "bytes": res["bytes"], "write_ms": 1e3 * min(
                         res["write_s"]), "read_ms": 1e3 * res["read_s"][0],
                     "deterministic": det_res["gaps"],
                     "default": res["gaps"]}
    return out


# ---------------------------------------------------------- phase 14: HMC --
HMC_BATCH = {"HMCReject": 128, "OurHMC": 128, "HMC": N_TRAIN}


def hmc_expected_launches(inference, epochs=3, sampling=(1, 2)):
    """(T,) launches of the HMC CLI runs: the reject runners one initial
    step, one a minibatch step and two a boundary (after each sampling
    epoch); OurHMC one a step, one more at each `sample` boundary (the
    first minibatch after a sampling epoch), and the final boundary step
    after the last epoch (two)"""
    steps = -(-N_TRAIN // HMC_BATCH[inference])
    if inference != "OurHMC":
        return 1 + steps * epochs + 2 * len(sampling)
    in_loop = sum(1 for e in range(1, epochs) if e - 1 in sampling)
    return steps * epochs + in_loop + (2 if epochs - 1 in sampling else 1)


def phase_hmc(fu, card):
    """train_bnn with inference=HMCReject (batch 128, reject_samples=True),
    OurHMC (batch 128) and HMC (classical: one batch of all N points and
    the M-H test) on fake_cifar10 cut to 5,000 / 1,000, cycles=1 warmup=1
    n_samples=2 burnin=0 temperature=1 momentum=1"""
    from bnn_priors_tpu_torch import exp_utils, io
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.experiments import train_bnn
    from bnn_priors_tpu_torch.inference import HMCRunner, HMCRunnerReject
    real = exp_utils.get_data_seeded
    exp_utils.get_data_seeded = lambda name, seed, device="cuda": FakeCIFAR10(
        n_train=N_TRAIN, n_test=N_TEST, seed=int(seed), device=device)
    out = {}
    try:
        for inference, B in HMC_BATCH.items():
            cls = HMCRunner if inference == "OurHMC" else HMCRunnerReject
            cfg = cli_config(train_bnn, data="fake_cifar10",
                             model="googleresnet", inference=inference,
                             reject_samples=inference != "OurHMC",
                             batch_size=B, cycles=1, warmup=1, n_samples=2,
                             burnin=0, temperature=1.0, momentum=1.0,
                             skip_first=0,
                             log_dir=os.path.join(RUNS_DIR, "hmc_" +
                                                  inference))
            expected = hmc_expected_launches(inference)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps_s, exact_s = [], []
            with timed(cls, "_plain_step", steps_s), \
                    timed(cls, "_exact_vg", exact_s) if cls is \
                    HMCRunnerReject else contextlib.nullcontext():
                reset_counts(fu)
                t0 = time.perf_counter()
                result = train_bnn.main(cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches, chain = fu.launches, fu.chain_launches
            triton = fu.triton_launches + fu.triton_chain_launches
            mem = torch.cuda.max_memory_allocated()
            m = io.load_metrics(
                os.path.join(cfg["log_dir"], "1", "metrics.h5"),
                ["steps", "delta_energy", "acceptance/is_sample",
                 "acceptance/rejected", "potential"])
            rows = (m["acceptance/is_sample"] == 1) & (m["steps"] > 0)
            de = m["delta_energy"][rows]
            check(all(math.isfinite(v) for v in result.values()),
                  f"{inference}: result {result}")
            pots = m["potential"][~np.isnan(m["potential"])]
            check(pots.size and np.all(np.isfinite(pots)),
                  f"{inference}: potentials")
            check(launches == expected and chain == 0 and triton == 0,
                  f"{inference}: (T,) launches {launches} ((K, T) {chain}, "
                  f"Triton {triton}), the schedule implies {expected}")
            if inference == "OurHMC":
                rate = float(np.mean(np.minimum(1.0, np.exp(-de))))
                acc = (f"no M-H test; mean min(1, exp(-dE)) {rate:.4f} over"
                       f" {de.size} boundaries")
            else:
                rej = m["acceptance/rejected"][rows]
                rate = 1.0 - float(np.mean(rej))
                acc = (f"acceptance {rate:.4f} ({int(rej.sum())} of "
                       f"{rej.size} rejected)")
            step_ms = 1e3 * float(np.median(steps_s))
            exact = (f", exact pass {1e3 * float(np.median(exact_s)):.1f} ms"
                     f" (median of {len(exact_s)})" if exact_s else "")
            print(f"hmc {inference} (batch {B}) ok in {wall:.1f} s on {card}: "
                  f"(T,) CUDA launches {launches} == {expected}, (K, T) 0, "
                  f"Triton 0; {acc}; dE at the boundaries "
                  f"{np.round(de, 4).tolist()}; max_memory_allocated "
                  f"{mem / 2 ** 30:.2f} GiB; minibatch step {step_ms:.1f} ms "
                  f"(median of {len(steps_s)}, synchronised){exact}; result "
                  f"{json.dumps(result)}")
            out[inference] = {"launches": launches, "expected": expected,
                              "acceptance": rate, "delta_energy": de.tolist(),
                              "max_memory_bytes": mem, "wall_s": wall,
                              "step_ms": step_ms}
    finally:
        exp_utils.get_data_seeded = real
    return out


def phase_hmc_reference(n=80):
    """one classical-HMC run (HMCRunnerReject, batch = N = 80, three
    one-step epochs, two M-H tests) at T=1 with the momentum injected: the
    card in f32 against the CPU in f64"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    from bnn_priors_tpu_torch.inference import HMCRunnerReject
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        data = get_data("fake_cifar10", n_train=n, n_test=16,
                        dtype="float64" if dtype == torch.float64
                        else "float32", device=device)
        model = get_model("googleresnet", dtype=dtype, device=device)
        he_initialize(model, torch.Generator().manual_seed(3))
        r = HMCRunnerReject(model, data.norm.train, data.norm.test,
                            epochs_per_cycle=3, warmup_epochs=1,
                            sample_epochs=2, learning_rate=1e-4,
                            momentum=1.0, temperature=1.0, batch_size=n,
                            reject_samples=True, precond_update=1, seed=0,
                            matmul_precision="float32", device=device)
        pk = r.kernel.packer
        draws = np.random.RandomState(5).standard_normal((3, pk.total_padded))
        draws[:, pk.total:] = 0.0  # the packed form's zero tail
        draws = iter(draws)

        def inject(state, temperature, keep=0.0, _d=draws):
            m = state.momentum
            state.momentum = temperature ** 0.5 * torch.as_tensor(
                next(_d), dtype=m.dtype, device=m.device)
            return state
        r.kernel.sample_momentum = inject
        r.run()
        out[device] = (r.kernel.params_of(r.chain), r.boundaries,
                       r.potentials, r.chain.momentum)
    (pc, bc, potc, mc), (pr, br, potr, mr) = out["cuda"], out["cpu"]
    check([b["rejected"] for b in bc] == [b["rejected"] for b in br],
          f"HMC decisions card {bc} vs CPU {br}")
    err = max(float((pc[k].double().cpu() - pr[k]).abs().max()) for k in pr)
    merr = float((mc.double().cpu() - mr).abs().max())
    # ΔE cancels ½‖m‖² (T terms) and N·U: bounded at 1e-5 of their size
    scale = 0.5 * float((mr ** 2).sum()) + n * float(np.abs(potr).max())
    derr = max(abs(a["delta_energy"] - b["delta_energy"])
               for a, b in zip(bc, br))
    check(err < 1e-3 and merr < 1e-3, f"HMC card vs CPU: params {err}, "
          f"momentum {merr}")
    check(derr <= 1e-5 * scale, f"HMC dE card vs CPU off by {derr} "
          f"(bound {1e-5 * scale:.3g})")
    de = lambda bs: [round(b["delta_energy"], 4) for b in bs]
    print(f"hmc reference check ok: params max |card f32 - CPU f64| "
          f"{err:.2e}, momentum {merr:.2e}; dE {de(bc)} vs {de(br)} (max "
          f"|d| {derr:.3g} <= 1e-5 x {scale:.4g}); decisions "
          f"{[b['rejected'] for b in bc]} on both")


# ------------------------------------- phase 15: priors and CIFAR-10 files --
# the 29 registry priors that build on the ResNet-20 models with empty
# parameters (datadrivencorrdoublegamma and fixedcov_gennorm need one)
ON_RESNET20 = (
    "gaussian", "convcorrnormal", "convcorrnormal_fitted_ls",
    "convcorrnormal_empirical", "convcorrnormal_gamma",
    "datadrivencorrnormal", "fixedcov_normal", "lognormal", "laplace",
    "cauchy", "student-t", "uniform", "improper", "gaussian_gamma",
    "gaussian_uniform", "horseshoe", "laplace_gamma", "laplace_uniform",
    "student-t_gamma", "student-t_uniform", "gennorm", "gennorm_uniform",
    "gaussian_empirical", "laplace_empirical", "student-t_empirical",
    "gennorm_empirical", "scale_mixture", "mixture",
    "scale_mixture_empirical")
# the paper's grid rows (experiments/run_experiment.sh), gaussian first:
# each row's step time is read against it
GRID = (("googleresnet", "gaussian"), ("googleresnet", "improper"),
        ("googleresnet", "laplace"), ("googleresnet", "student-t"),
        ("correlatedgoogleresnet", "convcorrnormal"),
        ("googleresnet", "gaussian_gamma"))
SMALL_N = 5000  # cifar10_small's training points


def phase_seeds(fu, key2, resume):
    """(a) the first 100 (T,) launches of phase 2's runner (rebuilt with
    phase 2's seed, run, then minibatch steps) draw with seeds key + n,
    all different; phase 13's deterministic resume was bitwise"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    data = get_data("fake_cifar10", n_train=N_TRAIN, n_test=N_TEST)
    model = get_model("googleresnet", weight_prior="gaussian",
                      weight_scale=2 ** 0.5)
    he_initialize(model, torch.Generator().manual_seed(0))
    runner = make_runner(data, model, "cuda")
    seeds, real = [], fu.fused_langevin_update

    def spy(theta, momentum, square_avg, grads, precond, seed, *a, **kw):
        seeds.append(int(seed))
        return real(theta, momentum, square_avg, grads, precond, seed, *a,
                    **kw)
    fu.fused_langevin_update = spy
    try:
        reset_counts(fu)
        runner.run()
        perm = runner._perm_on_device(0, 0)
        while len(seeds) < 100:
            runner._plain_step(perm[:128], len(seeds), 1.0)
        torch.cuda.synchronize()
    finally:
        fu.fused_langevin_update = real
    key = runner.chain.key
    check(key == key2, f"the rebuilt runner's key {key}, phase 2's {key2}")
    check(fu.launches == len(seeds) == runner.chain.n_updates,
          f"{fu.launches} launches, {len(seeds)} seeds, "
          f"{runner.chain.n_updates} updates")
    check(seeds[:100] == [key + n for n in range(100)]
          and len(set(seeds[:100])) == 100,
          f"seeds {seeds[:5]}... are not key + n for key {key}")
    for kind in ("single", "chains"):
        gaps = resume[kind]["deterministic"]["ad"]
        check(all(v == 0 for v in gaps.values()),
              f"phase 13's deterministic resume, {kind}: {gaps}")
    print(f"priors (a) seeds ok: the first 100 (T,) launches of phase 2's "
          f"runner draw with key + n, key {key} (< 2**62), 100 different "
          f"seeds, {fu.launches} CUDA launches; phase 13's deterministic "
          f"resume bitwise for one chain and K={K_CHAINS}")


def phase_cifar_files(card):
    """(b) synthetic CIFAR-10 python batches from seed 0 (50,000 / 10,000
    uint8 images, FakeCIFAR10's class rows) in a directory of the
    checkout's build/, BNN_PRIORS_DATA pointed at it, `cifar10` loaded"""
    import tempfile

    from bnn_priors_tpu_torch.data import write_cifar10_batches
    from bnn_priors_tpu_torch.exp_utils import get_data
    build = os.path.dirname(RUNS_DIR)
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="cifar_files_", dir=build)
    n = CLI_N_TRAIN + CLI_N_TEST
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n)
    x = rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    for c in range(10):
        x[y == c, :, 2 + c, :] = 255
    t0 = time.perf_counter()
    d = write_cifar10_batches(os.path.join(root, "CIFAR"), x[:CLI_N_TRAIN],
                              y[:CLI_N_TRAIN], x[CLI_N_TRAIN:],
                              y[CLI_N_TRAIN:])
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    os.environ["BNN_PRIORS_DATA"] = root
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = get_data("cifar10")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    xtr = data.norm.train_X
    check(tuple(xtr.shape) == (CLI_N_TRAIN, 3, 32, 32)
          and tuple(data.norm.test_X.shape) == (CLI_N_TEST, 3, 32, 32),
          f"cifar10 shapes {xtr.shape}")
    xd = xtr.double()
    mean, std = xd.mean((0, 2, 3)).cpu(), xd.std((0, 2, 3)).cpu()
    check(float(mean.abs().max()) < 1e-4 and
          float((std - 1).abs().max()) < 1e-4,
          f"normalised train set: mean {mean.tolist()} std {std.tolist()}")
    del data, xtr, xd
    print(f"priors (b) files ok on {card}: {size:,} bytes of CIFAR-10 "
          f"batches written in {write_s:.2f} s; get_data('cifar10') loaded "
          f"{CLI_N_TRAIN:,} / {CLI_N_TEST:,} images to the card in "
          f"{load_s:.2f} s; train channels mean {np.round(mean.numpy(), 7)}"
          f", std {np.round(std.numpy(), 7)}")
    return root


def _log_prior_and_grad(model):
    "(log prior, its gradient as one float64 CPU vector) at the params"
    params = {k: v.detach().clone().requires_grad_()
              for k, v in model.params().items()}
    lp = model.log_prior(params)
    gs = torch.autograd.grad(lp, list(params.values()), allow_unused=True)
    g = torch.cat([(torch.zeros_like(t) if x is None else x).reshape(-1)
                   .double().cpu() for t, x in zip(params.values(), gs)])
    return float(lp.detach()), g


def phase_prior_densities(card):
    """(c) every registry prior that builds on googleresnet, and
    convcorrnormal on correlatedgoogleresnet: log prior and its gradient
    in f32 on the card against CPU f64 at the same parameters"""
    from bnn_priors_tpu_torch.exp_utils import get_model
    rows = [("googleresnet", n) for n in ON_RESNET20]
    rows.append(("correlatedgoogleresnet", "convcorrnormal"))
    worst = {"value": 0.0, "norm": 0.0, "vector": 0.0}
    t0 = time.perf_counter()
    for model_name, name in rows:
        card_m = get_model(model_name, weight_prior=name, seed=1)
        cpu_m = get_model(model_name, weight_prior=name, device="cpu",
                          dtype=torch.float64, seed=1)
        cpu_m.load_state_dict({k: v.detach().cpu().to(
            cpu_m.state_dict()[k].dtype) for k, v in
            card_m.state_dict().items()})
        a, ga = _log_prior_and_grad(card_m)
        b, gb = _log_prior_and_grad(cpu_m)
        rel = abs(a - b) / abs(b)
        nb = float(gb.norm())
        norm_rel = abs(float(ga.norm()) - nb) / nb
        vec_rel = float((ga - gb).norm()) / nb
        check(math.isfinite(a) and rel <= 1e-5 and norm_rel <= 1e-5,
              f"{model_name} {name}: log prior {a} vs {b} (rel {rel:.2e}), "
              f"gradient norm rel {norm_rel:.2e}")
        for k, v in (("value", rel), ("norm", norm_rel), ("vector", vec_rel)):
            worst[k] = max(worst[k], v)
        print(f"priors (c) {model_name} {name}: {len(card_m.params())} "
              f"leaves, log prior {a:.6f} (card f32) vs {b:.6f} (CPU f64),"
              f" rel {rel:.2e}; gradient norm rel {norm_rel:.2e}, "
              f"|g32 - g64| / |g64| {vec_rel:.2e}")
    print(f"priors (c) ok on {card}: {len(rows)} models, worst rel "
          f"{worst['value']:.2e} (value), {worst['norm']:.2e} (gradient "
          f"norm), {worst['vector']:.2e} (gradient vector) <= 1e-5, in "
          f"{time.perf_counter() - t0:.1f} s")
    return worst


def phase_prior_grid(fu, card):
    """(d) the paper's grid rows through the single-chain CLI on
    cifar10_small from (b)'s files: train_bnn with model=... weight_prior=
    ... inference=VerletSGLDReject reject_samples=True cycles=1 warmup=1
    n_samples=1: launches against the schedule, finite ΔE, the median
    synchronised minibatch step"""
    from bnn_priors_tpu_torch import io
    from bnn_priors_tpu_torch.experiments import train_bnn
    from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject as R
    steps_per_epoch = -(-SMALL_N // 128)
    expected = 1 + steps_per_epoch * 2 + 2
    out = []
    for i, (model_name, name) in enumerate(GRID):
        cfg = cli_config(train_bnn, data="cifar10_small", model=model_name,
                         weight_prior=name, inference="VerletSGLDReject",
                         reject_samples=True, cycles=1, warmup=1, burnin=0,
                         n_samples=1, skip_first=0,
                         log_dir=os.path.join(RUNS_DIR, f"grid_{i}_{name}"))
        shutil.rmtree(cfg["log_dir"], ignore_errors=True)  # run dir "1"
        steps_s, window = [], {}
        with timed(R, "_plain_step", steps_s), profiled_calls(
                R, "_plain_step", steps_per_epoch + steps_per_epoch // 4,
                PROFILE_STEPS, window):
            reset_counts(fu)
            t0 = time.perf_counter()
            result = train_bnn.main(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ops, kernels, kernel_ms = window_counts(window["prof"],
                                                PROFILE_STEPS)
        launches, chain = fu.launches, fu.chain_launches
        triton = fu.triton_launches + fu.triton_chain_launches
        m = io.load_metrics(os.path.join(cfg["log_dir"], "1", "metrics.h5"),
                            ["steps", "delta_energy", "acceptance/is_sample",
                             "potential"])
        # the M-H boundary's ΔE (the sampling epoch's sample)
        de = m["delta_energy"][(m["acceptance/is_sample"] == 1)
                               & (m["steps"] > 0)]
        pots = m["potential"][~np.isnan(m["potential"])]
        check(launches == expected and chain == 0 and triton == 0,
              f"grid {model_name} {name}: (T,) launches {launches} ((K, T) "
              f"{chain}, Triton {triton}), the schedule implies {expected}")
        check(de.size == 1 and np.all(np.isfinite(de)) and pots.size
              and np.all(np.isfinite(pots))
              and all(math.isfinite(v) for v in result.values()),
              f"grid {model_name} {name}: dE {de}, result {result}")
        step_ms = 1e3 * float(np.median(steps_s))
        out.append({"model": model_name, "prior": name, "launches": launches,
                    "expected": expected, "delta_energy": float(de[0]),
                    "step_ms": step_ms, "wall_s": wall, "result": result,
                    "host_ops": ops, "kernels": kernels,
                    "kernel_ms": kernel_ms})
        print(f"priors (d) {model_name} {name}: (T,) CUDA launches "
              f"{launches} == {expected} = 1 + {steps_per_epoch} x 2 + 2, "
              f"dE {de[0]:.4f}, minibatch step {step_ms:.3f} ms (median of "
              f"{len(steps_s)}, synchronised), {wall:.1f} s; profiler window"
              f" of 5 epoch-1 steps: {ops:.0f} host ops, {kernels:.0f} "
              f"kernels, {kernel_ms:.3f} ms of kernel time a step; result "
              f"{json.dumps(result)}")
    base = out[0]["step_ms"]  # gaussian's
    label = lambda r: r["prior"] + (" (correlated)" if "correlated" in
                                    r["model"] else "")
    print(f"priors (d) ok on {card}: median minibatch step against the "
          f"gaussian run ({base:.3f} ms): " + ", ".join(
              f"{label(r)} {r['step_ms']:.3f} ms "
              f"({r['step_ms'] / base:.3f}x)" for r in out))
    return out


def phase_prior_chains(fu, card):
    """(e) n_chains=8 compute_dtype=bfloat16 init_method=prior on
    cifar10_small, weight_prior=gaussian_gamma after a gaussian run:
    (K, T) launches against the schedule, chain-steps/s, no chain NaN"""
    from bnn_priors_tpu_torch.experiments import train_bnn
    from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject as M
    K = K_CHAINS
    expected = 1 + (SMALL_N // 128) * 2 + 2
    out = []
    for i, name in enumerate(("gaussian", "gaussian_gamma")):
        cfg = cli_config(train_bnn, data="cifar10_small",
                         model="googleresnet", weight_prior=name,
                         inference="VerletSGLDReject", reject_samples=True,
                         n_chains=K, compute_dtype="bfloat16",
                         init_method="prior", temperature=1.0, cycles=1,
                         warmup=1, burnin=0, n_samples=1, skip_first=0,
                         log_dir=os.path.join(RUNS_DIR, f"chains_{i}_{name}"))
        shutil.rmtree(cfg["log_dir"], ignore_errors=True)
        steps_s = []
        with timed(M, "_chain_step", steps_s):
            reset_counts(fu)
            t0 = time.perf_counter()
            summary = train_bnn.main(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, single = fu.chain_launches, fu.launches
        triton = fu.triton_launches + fu.triton_chain_launches
        check(summary["n_diverged"] == 0 and len(summary["chains"]) == K
              and all(math.isfinite(r["lp_ensemble"])
                      for r in summary["chains"]),
              f"chains {name}: {summary['n_diverged']} diverged")
        check(launches == expected and single == 0 and triton == 0,
              f"chains {name}: (K, T) launches {launches} ((T,) {single}, "
              f"Triton {triton}), the schedule implies {expected}")
        rate = K / float(np.median(steps_s))
        out.append({"prior": name, "launches": launches,
                    "expected": expected, "chain_steps_per_s": rate,
                    "wall_s": wall})
        print(f"priors (e) K={K} {name}: (K, T) CUDA launches {launches} "
              f"== {expected}, no chain NaN, {rate:.1f} chain-steps/s "
              f"(K / median synchronised step of {len(steps_s)}), "
              f"{wall:.1f} s")
    base = out[0]["chain_steps_per_s"]  # gaussian's
    print(f"priors (e) ok on {card}: gaussian_gamma "
          f"{out[1]['chain_steps_per_s']:.1f} chain-steps/s against "
          f"gaussian {base:.1f} ({out[1]['chain_steps_per_s'] / base:.3f}x)")
    return out


def phase_priors(fu, card, key2, resume):
    "phase 15: (a)-(e); returns the launch counts for the kernels line"
    t0 = time.perf_counter()
    phase_seeds(fu, key2, resume)
    root = phase_cifar_files(card)
    try:
        phase_prior_densities(card)
        grid = phase_prior_grid(fu, card)
        chains = phase_prior_chains(fu, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("BNN_PRIORS_DATA", None)
    print(f"phase 15 (priors and CIFAR-10 files) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"single": {f"{r['model']}/{r['prior']}": r["launches"]
                       for r in grid},
            "single_expected": grid[0]["expected"],
            "chains": {r["prior"]: r["launches"] for r in chains},
            "chains_expected": chains[0]["expected"]}


# ------------------------------- phase 16: segmented and hybrid states --
SEG_PACKINGS = ("hybrid", "segmented")
SEG_N = 5000  # (b)-(d)'s points, the main path's: 83 and 81 launches
SEG_SOURCE = "bnn_priors_tpu_torch/csrc/fused_update_segments.cu"
SEG_REPLACES = "bnn_priors_tpu/mcmc/verlet_sgld.py:126"
SLOTS_K = 64  # (a)'s chains where every block takes its 16 groups
NHWC = ("nchwToNhwc", "nhwcToNchw")  # cuDNN's layout conversion kernels
# (d)'s profiler windows: steps each (the profiler's processing of a K=8
# window takes seconds a step; PERF.md §5)
PACKING_PROFILE_STEPS = 3


def model_packers(model_name="googleresnet"):
    "the flat packer and the two segment packers of a model, on the card"
    from bnn_priors_tpu_torch.exp_utils import get_model
    from bnn_priors_tpu_torch.mcmc.packing import Packer
    from bnn_priors_tpu_torch.mcmc.segmented import make_packer
    params = {k: v.detach() for k, v in get_model(model_name).params(
    ).items()}
    return Packer(params), {p: make_packer(p, params) for p in SEG_PACKINGS}


def segment_inputs(pk, fp, lead, gen):
    """random θ, m, v > 0, g and a per-leaf M on the card, as SegVecs of
    `pk` and as the flat packing's vectors"""
    mk = lambda f: {k: f(torch.randn(*lead, *s, generator=gen)).cuda()
                    for k, s in zip(fp.names, fp.shapes)}
    trees = [mk(lambda x: x), mk(lambda x: x), mk(lambda x: x.abs() + 0.1),
             mk(lambda x: 0.05 * x)]
    scalars = (0.5 + torch.rand(*lead, fp.n_leaves, generator=gen)).cuda()
    segs = [pk.pack(t) for t in trees] + [pk.expand(scalars)]
    flats = [fp.pack(t) for t in trees] + [fp.expand(scalars)]
    return segs, flats


def segment_call(fu, lead, table, seed, coeffs, sigmas=None, plain=False):
    """a callable of the segments kernel (or its plain version) on buffers:
    one chain with (seed, 5 coefficients), or K chains with ((K,) seeds,
    sigmas and 4 coefficients, offset 5)"""
    if not lead:
        fn = (fu.fused_langevin_update_segments_reference if plain
              else fu.fused_langevin_update_segments)
        return lambda *b: fn(*b, seed, coeffs, table=table)[3]
    fn = (fu.fused_langevin_update_segments_chains_reference if plain
          else fu.fused_langevin_update_segments_chains)
    c4 = coeffs[:2] + coeffs[3:]
    return lambda *b: fn(*b, seed, sigmas, c4, table=table,
                         seed_offset=5)[3]


def check_segments_plain(fu, pk, lead, segs, seeds8, tag):
    """the kernel against its plain version on `segs`, the coefficient
    sets at noise_std 0 (atol 1e-6) and 1 (atol 1e-5), partials within
    rtol 1e-4, then the partials bit for bit over 10 launches; returns the
    largest |d|"""
    table = pk.kernel_table(lead, "cuda", fu.SEGMENT_CHUNK)
    sets = coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)
    worst = 0.0
    for name, coeffs in sets.items():
        for sigma, atol in ((0.0, 1e-6), (1.0, 1e-5)):
            c = with_sigma(coeffs, sigma)
            sig = sigma * torch.linspace(0.5, 1.5, K_CHAINS, device="cuda")
            seed = 1234 if not lead else seeds8
            ker = [s.base.clone() for s in segs]
            ref = [s.base.clone() for s in segs]
            pk_ = segment_call(fu, lead, table, seed, c, sig)(*ker)
            pr = segment_call(fu, lead, table, seed, c, sig,
                              plain=True)(*ref)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max())
                      for a, b in zip(ker[:3], ref[:3]))
            check(err <= atol, f"segments {tag} {name} sigma={sigma}: off "
                  f"by {err} (atol {atol})")
            rel = float(((pk_ - pr).abs()
                         / pr.abs().clamp_min(1e-30)).max())
            check(rel <= 1e-4, f"segments {tag} partials {pk_} vs {pr}")
            worst = max(worst, err)
            print(f"segments == plain: {tag} {name:13s} sigma={sigma}: max "
                  f"|d| {err:.2e}, partials rel err {rel:.2e}")
    # the partials are the same, bit for bit, launch after launch
    c = with_sigma(sets["ggmc_mid"], 1.0)
    sig = torch.linspace(0.5, 1.5, K_CHAINS, device="cuda")
    call = segment_call(fu, lead, table, 99 if not lead else seeds8, c, sig)
    parts = [call(*[s.base.clone() for s in segs]) for _ in range(10)]
    check(all(torch.equal(parts[0], p) for p in parts),
          f"segments {tag}: partials differ between repeats")
    return worst


def phase_segments_kernel(fu):
    """(a) the segments kernel against its plain version (σ 0 and 1) on
    ResNet-20's states, one chain and K=8, and on resnet18's, one chain;
    its ξ against the flat kernel's bit for bit, row k of a K=8 launch
    against a one-chain launch bit for bit; then its time"""
    fp, pks = model_packers()
    gen = torch.Generator().manual_seed(16)
    seeds8 = chain_seeds(K_CHAINS)
    out = {"max_abs_err": 0.0}
    for packing, pk in pks.items():
        for lead in ((), (K_CHAINS,)):
            segs, _ = segment_inputs(pk, fp, lead, gen)
            err = check_segments_plain(
                fu, pk, lead, segs, seeds8,
                f"{packing:9s} K={math.prod(lead)}")
            if packing == "hybrid" and not lead:
                out["max_abs_err"] = err
        out[packing] = segment_noise_and_rows(fu, pk, fp, gen, seeds8)
    # every block at its SEGMENT_SLOTS groups: K=64 on the segmented state
    n_groups, nb = fu.segment_grid(
        pks["segmented"].kernel_table((SLOTS_K,), "cuda", fu.SEGMENT_CHUNK),
        torch.device("cuda", 0), SLOTS_K)
    check(-(-n_groups // nb) == fu.SEGMENT_SLOTS,
          f"K={SLOTS_K}: {n_groups} groups over {nb} blocks")
    out["slots_bitwise"] = rows_are_one_chain_launches(
        fu, pks["segmented"], fp, gen, SLOTS_K,
        with_sigma(coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"],
                   1.0))
    fp18, pks18 = model_packers("resnet18")
    for packing, pk in pks18.items():
        segs, _ = segment_inputs(pk, fp18, (), gen)
        out[f"resnet18/{packing}"] = check_segments_plain(
            fu, pk, (), segs, seeds8, f"resnet18 {packing:9s} K=1")
        del segs
    del fp18, pks18
    out["timing"] = segment_timing(fu, gen, seeds8)
    return out


def segment_noise_and_rows(fu, pk, fp, gen, seeds8):
    """ξ of every element bit for bit the flat kernel's at its flat index
    (m' = ξ at mom_decay = grad_lr = 0, σ = 1), one chain and K=8; the whole
    update with the noise on against the flat kernel; row k of a K=8
    launch against a one-chain launch with chain k's seed and σ"""
    T, total = fp.total_padded, fp.total
    xi_coeffs = (0.0, 0.0, 1.0, 0.0, 1.0)
    zeros = lambda lead: {k: torch.zeros(*lead, *s, device="cuda")
                          for k, s in zip(fp.names, fp.shapes)}
    for lead in ((), (K_CHAINS,)):
        table = pk.kernel_table(lead, "cuda", fu.SEGMENT_CHUNK)
        for seed in ((123, 2 ** 40 + 7) if not lead else (seeds8,)):
            m = pk.pack(zeros(lead))
            ones = pk.expand(torch.ones(*lead, fp.n_leaves, device="cuda"))
            v = vapply_ones(m)
            bufs = [pk.pack(zeros(lead)).base, m.base, v.base,
                    pk.pack(zeros(lead)).base, ones.base]
            sig = torch.ones(K_CHAINS, device="cuda")
            segment_call(fu, lead, table, seed, xi_coeffs, sig)(*bufs)
            fm = torch.zeros(*lead, T, device="cuda")
            if not lead:
                fu.fused_langevin_update(torch.zeros(T, device="cuda"), fm,
                                         torch.ones(T, device="cuda"),
                                         torch.zeros(T, device="cuda"),
                                         torch.ones(T, device="cuda"), seed,
                                         xi_coeffs, total=total)
            else:
                z = lambda: torch.zeros(*lead, T, device="cuda")
                o = lambda: torch.ones(*lead, T, device="cuda")
                fu.fused_langevin_update_chains(
                    z(), fm, o(), z(), o(), seed, sig,
                    xi_coeffs[:2] + xi_coeffs[3:], total=total,
                    seed_offset=5)
            got = pk.to_flat(m)[..., :total]
            check(torch.equal(got, fm[..., :total]),
                  f"{pk.tag} K={table.n_chains}: xi differs from the flat "
                  f"kernel's at {int((got != fm[..., :total]).sum())} "
                  "elements")
    print(f"segments {pk.tag}: xi of all {total} elements bit for bit the "
          f"flat kernel's (one chain, seeds 123 and 2**40+7; K={K_CHAINS})")

    # the whole update with the noise on, against the flat kernel
    c = with_sigma(coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"],
                   1.0)
    segs, flats = segment_inputs(pk, fp, (), gen)
    table1 = pk.kernel_table((), "cuda", fu.SEGMENT_CHUNK)
    ps = segment_call(fu, (), table1, 77, c)(*(s.base for s in segs))
    *_, pf = fu.fused_langevin_update(*flats, 77, c, total=total)
    torch.cuda.synchronize()
    d = max(float((pk.to_flat(s) - f).abs().max())
            for s, f in zip(segs[:3], flats[:3]))
    bitwise = all(torch.equal(pk.to_flat(s), f)
                  for s, f in zip(segs[:3], flats[:3]))
    rel = float(((ps - pf).abs() / pf.abs().clamp_min(1e-30)).max())
    print(f"segments {pk.tag} vs the flat kernel, noise on: theta, m, v max "
          f"|d| {d:.2e} (bit for bit: {bitwise}), partials rel {rel:.2e}")
    check(bitwise and rel <= 1e-4, f"{pk.tag} vs the flat kernel, noise "
          f"on: theta, m, v max |d| {d}, partials rel {rel}")

    rows_equal = rows_are_one_chain_launches(fu, pk, fp, gen, K_CHAINS, c)
    return {"xi_bitwise": True, "update_bitwise": bitwise,
            "rows_bitwise": rows_equal}


def rows_are_one_chain_launches(fu, pk, fp, gen, K, c):
    """row k of a K-chain launch (θ, m, v and partials) bit for bit a
    one-chain launch with chain k's seed and σ; checks and returns True.
    Prints the most groups a block of the K launch takes"""
    lead = (K,)
    tableK = pk.kernel_table(lead, "cuda", fu.SEGMENT_CHUNK)
    table1 = pk.kernel_table((), "cuda", fu.SEGMENT_CHUNK)
    n_groups, nb = fu.segment_grid(tableK, torch.device("cuda", 0), K)
    slots = -(-n_groups // nb)
    segsK, _ = segment_inputs(pk, fp, lead, gen)
    seeds = chain_seeds(K)
    sig = torch.linspace(0.25, 2.0, K, device="cuda")
    M1 = pk.leaf_firsts(segsK[4])
    singles = [[pk.pack({n: t[k].clone() for n, t in pk.unpack(s).items()})
                for s in segsK[:4]] + [pk.expand(M1[k])]
               for k in range(K)]  # copies, before the K launch
    pK = segment_call(fu, lead, tableK, seeds, c, sig)(
        *(s.base for s in segsK))
    rows_equal = parts_equal = True
    for k, one in enumerate(singles):
        c1 = c[:2] + (float(sig[k]),) + c[3:]
        p1 = segment_call(fu, (), table1, int(seeds[k]) + 5, c1)(
            *(s.base for s in one))
        parts_equal &= torch.equal(p1, pK[k])
        rows_equal &= all(torch.equal(pk.to_flat(a), pk.to_flat(b)[k])
                          for a, b in zip(one[:3], segsK[:3]))
    check(rows_equal, f"{pk.tag}: a K={K} launch's theta, m, v rows differ "
          "from one-chain launches")
    check(parts_equal, f"{pk.tag}: a K={K} launch's partials differ from "
          "one-chain launches'")
    print(f"segments {pk.tag}: every row of a K={K} launch (theta, m, v, "
          f"partials; {n_groups} groups over {nb} blocks a chain, up to "
          f"{slots} a block) bit for bit a one-chain launch")
    return True


def vapply_ones(vec):
    from bnn_priors_tpu_torch.mcmc.segmented import vapply
    return vapply(torch.ones_like, vec)


def segment_bound_ms(pk, lead):
    """the least time for one call: θ, m, v, g read and θ', m', v' written
    (f32), M read once a leaf (a native segment) or an element (the hybrid
    small segment); or ~14 f32 operations an element"""
    K = math.prod(lead)
    n = pk.total * K
    n_m = sum(pk.pre_arena(()).sizes) * K
    return 1e3 * max(4 * (7 * n + n_m) / H100_BYTES_PER_S,
                     14 * n / H100_F32_OPS_PER_S), 4 * (7 * n + n_m)


# (a)'s timing: (label, model, chains) of each form, both packings each
SEG_TIMING_FORMS = (("ResNet-20", "googleresnet", 1),
                    ("ResNet-20", "googleresnet", K_CHAINS),
                    ("resnet18", "resnet18", 1))


def ring_and_hot_us(fn, bufs):
    """device µs a launch of fn(*bufs) in a CUDA graph of SPLIT_CALLS
    launches: over a ring of copies larger than L2, and over `bufs` alone"""
    rg = ring(*bufs)
    ring_us = graph_us(lambda i: fn(*rg[i % len(rg)]))
    del rg
    return ring_us, graph_us(lambda i: fn(*bufs))


def launch_times(fn, bufs, match):
    """a call (events, median of 100), back to back, device µs of a hot
    launch (profiler) and enqueue µs a call of fn(*bufs), and its device µs
    a launch over the ring and hot"""
    call = lambda: fn(*bufs)
    dev, _ = device_us(call, match, n=50)
    ring_us, hot_us = ring_and_hot_us(fn, bufs)
    return {"call_ms": time_ms(call, 100), "b2b_ms": back_to_back_ms(call),
            "device_us": dev, "enqueue_us": enqueue_us(call),
            "ring_us": ring_us, "hot_us": hot_us}


def segment_timing(fu, gen, seeds8):
    """the segments kernel, hybrid and segmented, at each form of
    SEG_TIMING_FORMS: `launch_times` (device µs a launch over the ring and
    hot among them), beside the flat kernel's, the plain version's and the
    byte bound"""
    c = with_sigma(coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)["ggmc_mid"],
                   0.5)
    c4 = c[:2] + c[3:]
    sig = torch.full((K_CHAINS,), 0.5, device="cuda")
    fmt = lambda x, f: "not measured" if x is None else format(x, f)
    res = {}
    for label, model_name, K in SEG_TIMING_FORMS:
        fp, pks = model_packers(model_name)
        lead = () if K == 1 else (K,)
        seed = 7 if not lead else seeds8
        _, flats = segment_inputs(pks["hybrid"], fp, lead, gen)
        if not lead:
            flat = lambda *b: fu.fused_langevin_update(*b, 7, c,
                                                       total=fp.total)
        else:
            flat = lambda *b: fu.fused_langevin_update_chains(
                *b, seeds8, sig, c4, total=fp.total)
        f = res[f"{label}/flat/{K}"] = launch_times(flat, flats,
                                                    "langevin_update")
        del flats
        print(f"segments timing {label} flat      K={K}: ring "
              f"{f['ring_us']:.2f} us, hot {f['hot_us']:.2f} us a launch "
              f"(graph); a call {f['call_ms']:.4f} ms, back to back "
              f"{f['b2b_ms']:.4f} ms, device {fmt(f['device_us'], '.2f')} "
              f"us a hot launch (profiler)")
        for packing, pk in pks.items():
            table = pk.kernel_table(lead, "cuda", fu.SEGMENT_CHUNK)
            segs, _ = segment_inputs(pk, fp, lead, gen)
            bufs = [s.base for s in segs]
            del segs
            now = segment_call(fu, lead, table, seed, c, sig)
            m = launch_times(now, bufs, "segments")
            plain = segment_call(fu, lead, table, seed, c, sig, plain=True)
            m["plain_ms"] = time_ms(lambda: plain(*bufs), 10)
            m["bound_ms"], m["bytes"] = segment_bound_ms(pk, lead)
            m["n_pieces"] = table.n_pieces
            res[f"{label}/{packing}/{K}"] = m
            bound_us = m["bound_ms"] * 1e3
            share = lambda us: f"{us:.2f} us ({bound_us / us:.0%})"
            print(f"segments timing {label} {packing:9s} K={K} "
                  f"({table.n_pieces} pieces; bound {bound_us:.2f} us, "
                  f"{m['bytes']:,} B): ring {share(m['ring_us'])}, hot "
                  f"{share(m['hot_us'])}; the flat kernel ring "
                  f"{f['ring_us']:.2f}, hot {f['hot_us']:.2f} us (this "
                  f"kernel {m['ring_us'] / f['ring_us']:.2f}x, "
                  f"{m['hot_us'] / f['hot_us']:.2f}x); a call "
                  f"{m['call_ms']:.4f} ms, back to back {m['b2b_ms']:.4f} "
                  f"ms, device {fmt(m['device_us'], '.2f')} us a hot launch "
                  f"(profiler), enqueue {m['enqueue_us']:.2f} us, plain "
                  f"{m['plain_ms']:.4f} ms")
            del bufs
    return res


def phase_segments_path(fu, data):
    """(b) the single-chain main path with a hybrid and a segmented state:
    launches of the segments kernel only (83), and card f32 vs CPU f64 at
    T=0; (c) K=8 bf16 hybrid and segmented chains (81 launches each)"""
    out = {}
    for packing in SEG_PACKINGS:
        runner = make_runner(data, fresh_model(), "cuda", packing=packing)
        check(runner.kernel.packer.n_segments == {"hybrid": 22,
                                                  "segmented": 65}[packing],
              f"{packing}: {runner.kernel.packer.n_segments} segments")
        n_boundaries = sum(runner._is_sampling_epoch(e)
                           for e in range(runner.epochs_per_cycle))
        expected = (1 + runner.steps_per_epoch * runner.epochs_per_cycle
                    * runner.cycles + 2 * n_boundaries * runner.cycles)
        reset_counts(fu)
        t0 = time.perf_counter()
        runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seg, flat = fu.segments_launches, fu.launches
        other = (fu.chain_launches + fu.segments_chain_launches
                 + fu.triton_launches + fu.triton_chain_launches)
        pots = np.asarray(runner.potentials)
        check(np.all(np.isfinite(pots)), f"{packing} potentials")
        b = runner.boundaries[0]
        check(math.isfinite(b["delta_energy"]), f"{packing} boundary {b}")
        samples = runner.get_samples()
        check(all(np.all(np.isfinite(v)) and v.shape[0] == 1
                  for v in samples.values()), f"{packing} samples")
        check(seg == expected and flat == 0 and other == 0,
              f"{packing}: segments launches {seg}, flat {flat}, others "
              f"{other}; the protocol implies {expected}")
        print(f"segments path ({packing}) ok in {wall:.1f} s: potentials "
              f"{pots[0]:.4f} -> {pots[-1]:.4f}, boundary dE "
              f"{b['delta_energy']:.4f} rejected {b['rejected']}, segments "
              f"launches {seg} == {expected}, flat launches 0")
        err = phase_reference(packing)
        out[packing] = {"launches": seg, "expected": expected,
                        "card_vs_cpu": err}
        del runner
    out["chains"] = {}
    for packing in SEG_PACKINGS:
        runner = make_chain_runner(data, fresh_model(), "cuda", K_CHAINS,
                                   packing=packing)
        n_boundaries = sum(runner._is_sampling_epoch(e)
                           for e in range(runner.epochs_per_cycle))
        expected = (1 + runner.n_full * runner.epochs_per_cycle
                    * runner.cycles + 2 * n_boundaries * runner.cycles)
        reset_counts(fu)
        runner.run()
        torch.cuda.synchronize()
        seg = fu.segments_chain_launches
        other = (fu.launches + fu.chain_launches + fu.segments_launches
                 + fu.triton_launches + fu.triton_chain_launches)
        pots = np.concatenate(runner.potentials)
        check(np.all(np.isfinite(pots)) and not runner.nan_chains,
              f"{packing} chain potentials")
        check(seg == expected and other == 0,
              f"{packing} K={K_CHAINS}: segments launches {seg}, others "
              f"{other}; the protocol implies {expected}")
        print(f"segments chains ({packing}, K={K_CHAINS}, bf16) ok: boundary "
              f"dE {runner.delta_energies[0].round(4)} rejected "
              f"{runner.rejections[0].astype(int)}, segments launches {seg} "
              f"== {expected}, other kernels 0")
        out["chains"][packing] = {"launches": seg, "expected": expected}
        del runner
    return out


def nhwc_count(prof, n):
    "cuDNN layout conversions a step of an `n`-step window"
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(s in e.key for s in NHWC)) / n


def packing_window(step, n=PACKING_PROFILE_STEPS):
    """(host ops, kernels, kernel ms, layout conversions) a step over a
    profiler window of `n` calls of `step(i)`"""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    return window_counts(prof, n) + (nhwc_count(prof, n),)


def phase_packing_steps(data, card):
    """(d) the minibatch step with flat, hybrid and segmented states, in
    turns (flat, hybrid, segmented, segmented, hybrid, flat): one chain in
    f32 and K=8 in bf16; then a profiler window of
    PACKING_PROFILE_STEPS steps each"""
    order = ("flat",) + SEG_PACKINGS + SEG_PACKINGS[::-1] + ("flat",)
    out = {}
    for K in (1, K_CHAINS):
        if K == 1:
            runners = {p: make_runner(data, fresh_model(), "cuda",
                                      packing=p) for p in SEG_PACKINGS
                       + ("flat",)}
            timer = phase_step_time
            perm = torch.randperm(SEG_N, device="cuda")

            def stepper(r):
                return lambda i: r._plain_step(perm[i * 128:(i + 1) * 128],
                                               i, 1.0)
        else:
            runners = {p: make_chain_runner(data, fresh_model(), "cuda", K,
                                            packing=p)
                       for p in SEG_PACKINGS + ("flat",)}
            timer = chain_step_ms

            def stepper(r):
                idxs = r._epoch_idxs(0, 0)
                temps = r._temps_for(r.epochs_per_cycle - 1)
                return lambda i: r._chain_step(idxs[:, i], i, temps)
        times = {p: [] for p in runners}
        for p in order:
            ms = timer(runners[p])
            times[p].append(ms)
            print(f"packing steps K={K} {p:9s}: {ms:.3f} ms a step "
                  f"({'f32' if K == 1 else 'bf16'}, batch 128 a chain, "
                  f"ResNet-20) on {card}")
        for p, r in runners.items():
            host, kernels, kernel_ms, nhwc = packing_window(stepper(r))
            out[f"{p}/{K}"] = {"ms": times[p], "host_ops": host,
                               "kernels": kernels, "kernel_ms": kernel_ms,
                               "nhwc": nhwc}
            print(f"packing window K={K} {p:9s}: {kernels:.0f} kernels, "
                  f"{kernel_ms:.3f} ms of kernel time, {host:.0f} host ops, "
                  f"{nhwc:.0f} layout conversions a step; step "
                  f"{np.mean(times[p]):.3f} ms, busy "
                  f"{kernel_ms / np.mean(times[p]):.1%}")
        del runners
    return out


def phase_hybrid_resume(proc, seconds):
    """(e) phase 13's deterministic resume with hybrid states (one chain
    f32, K=8 bf16), in its own process (`proc`, done): (a) = (d) bit for
    bit"""
    for ln in proc.stdout.splitlines():
        if not ln.startswith(RESUME_TAG):
            print(ln)
    check(proc.returncode == 0, f"hybrid deterministic resume failed "
          f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    det = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith(RESUME_TAG)][-1][len(RESUME_TAG):])
    out = {}
    for kind, res in det["runs"].items():
        ad = res["gaps"]["ad"]
        check(not det["nondeterministic_ops"]
              and all(v == 0 for v in ad.values()),
              f"hybrid deterministic resume {kind}: (a)-(d) {ad}, "
              f"nondeterministic ops {det['nondeterministic_ops']}")
        single, chain, triton, seg, seg_chain = res["launches"]
        expected = (-(-RESUME_N // 128) if kind == "single"
                    else RESUME_N // 128) * 2 + 2
        ours = seg if kind == "single" else seg_chain
        check(ours == expected and single + chain + triton == 0
              and seg + seg_chain == ours,
              f"resumed hybrid {kind}: launches {res['launches']}, the "
              f"schedule implies {expected} segments launches")
        out[kind] = {"launches": ours, "expected": expected, "gaps": ad,
                     "bytes": res["bytes"]}
        print(f"resume hybrid {kind}: (a) = (d) bit for bit, checkpoint "
              f"{res['bytes']:,} bytes, resumed launches {ours} == "
              f"{expected}")
    print(f"resume hybrid: subprocess, (b) and (c) {seconds:.1f} s")
    return out


def phase_segments(fu, card):
    "phase 16: (a)-(e); returns the kernels line's segments entries' parts"
    from bnn_priors_tpu_torch.exp_utils import get_data
    t0 = time.perf_counter()
    kern = phase_segments_kernel(fu)
    data = get_data("fake_cifar10", n_train=SEG_N, n_test=N_TEST)
    steps = phase_packing_steps(data, card)
    # (e) in its own process while (b) and (c), which read no time, run
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t1 = time.perf_counter()
    with alongside("resume-deterministic", "hybrid", env=env) as sub:
        paths = phase_segments_path(fu, data)
    resume = phase_hybrid_resume(sub["proc"], time.perf_counter() - t1)
    print(f"phase 16 (segmented and hybrid states) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"kernel": kern, "paths": paths, "steps": steps,
            "resume": resume}


# ----------------------------------- phase 17: every inference on chains --
CHAIN_K = 4                   # phase 17's bank (b, d, e)
CHAIN_N = 1280  # 17 (b), (c)'s points (cut from 5,000, then 2,560)
CHAIN_INFERENCES = ("SGLD", "VerletSGLD", "OurHMC", "SGLDReject",
                    "HMCReject")
CLASSICAL_K = 2               # classical HMC: every chain at batch N
GROUP_SIZES = (8, 4, 2, 1)    # (f): chains a dispatch group at K=8
# (f)'s profiler windows: the trace of a step at one chain a group holds
# ~50,000 host ops, whose processing took most of the phase at 10 steps
GROUP_PROFILE_STEPS = 2
GROUP_STEPS = 3               # (f): minibatch steps a turn (cut from 10,
                              # then 5)
CLI_RESUME_TAG = "resume-cli-chains:"  # (e)'s subprocess result line


def chain_expected_launches(inference, n_full, epochs, boundaries):
    """(K, T) launches of a chain CLI run, from the runners' code: the
    plain loop (SGLD, VerletSGLD, OurHMC) one a minibatch step and none at
    a boundary (a momentum refresh launches nothing); the reject loop one
    initial step, one a minibatch step and at each boundary its final and
    initial steps, where the SGLD kernel's final step updates nothing"""
    steps = n_full * epochs
    if inference in ("SGLD", "VerletSGLD", "OurHMC"):
        return steps
    return 1 + steps + (1 if inference == "SGLDReject" else 2) * boundaries


def phase_chain_kernel_sets(fu):
    """(a) the (K, T) kernel against its plain version at ResNet-20's T,
    K=4: SGLD's coefficient set with σ_k = sqrt(2(1−a)·T_k) of a tempering
    grid with one chain at T=0 (the chain form's own σ), and HMC's (momentum
    decay 1, σ = 0)"""
    from bnn_priors_tpu_torch import mcmc
    K, T, total = CHAIN_K, 273408, 272474
    gen = torch.Generator().manual_seed(17)
    base = chain_kernel_inputs(K, T, total, gen)
    seeds = chain_seeds(K)
    temps = torch.tensor([0.0, 0.01, 0.1, 1.0], device="cuda")
    sets = coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)
    out = {}
    for name, a in (("sgld_mid", 0.994), ("sgld_a0_mid", 0.0),
                    ("hmc_mid", 1.0)):
        kernel = mcmc.SGLDChains(num_data=N_TRAIN, momentum=a)
        sigma = (kernel._noise_std(2.0 * (1.0 - a), temps)
                 if name.startswith("sgld") else torch.zeros(K, device="cuda"))
        check((sigma[0] == 0).item() and (name == "hmc_mid"
                                          or bool((sigma[1:] > 0).all())),
              f"{name}: sigma {sigma}")
        mom_decay, grad_lr, _, pos_c, alpha = sets[name]
        c4 = (mom_decay, grad_lr, pos_c, alpha)
        ker = [t.clone() for t in base]
        ref = [t.clone() for t in base]
        *_, pk = fu.fused_langevin_update_chains(*ker, seeds, sigma, c4,
                                                 total=total, seed_offset=5)
        *_, pr = fu.fused_langevin_update_chains_reference(
            *ref, seeds, sigma, c4, total=total, seed_offset=5)
        err, rel = compare_to_plain(f"chains {name}", ker, ref, pk, pr, total,
                                    1e-5, lambda t: t[:, total:])
        out[name] = err
        print(f"chains (a) kernel == plain: {name:11s} K={K} T={T} sigma "
              f"{[round(float(v), 5) for v in sigma]}: max |d| {err:.2e}, "
              f"partials rel err {rel:.2e}")
    return out


def chain_cli(fu, inference, K, n_train=N_TRAIN, **kw):
    """one chain CLI run on fake_cifar10 cut to `n_train`: its summary, the
    (K, T) launches and the other kernels' launches, and its wall time"""
    from bnn_priors_tpu_torch import exp_utils
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.experiments import train_bnn
    hmc = "HMC" in inference
    cfg = cli_config(train_bnn, data="fake_cifar10", model="googleresnet",
                     inference=inference, n_chains=K,
                     compute_dtype="bfloat16", temperature=1.0, cycles=1,
                     warmup=1, burnin=0, n_samples=1, skip_first=0,
                     momentum=1.0 if hmc else 0.994,
                     reject_samples=inference in ("SGLDReject",
                                                  "VerletSGLDReject"),
                     log_dir=os.path.join(RUNS_DIR, f"chains17_{inference}"))
    cfg.update(kw)
    real = exp_utils.get_data_seeded
    exp_utils.get_data_seeded = lambda name, seed, device="cuda": FakeCIFAR10(
        n_train=n_train, n_test=N_TEST, seed=int(seed), device=device)
    try:
        reset_counts(fu)
        t0 = time.perf_counter()
        summary = train_bnn.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        exp_utils.get_data_seeded = real
    others = (fu.launches + fu.triton_launches + fu.triton_chain_launches
              + fu.segments_launches + fu.segments_chain_launches)
    return cfg, summary, fu.chain_launches, others, wall


def check_chain_summary(tag, summary, K, reject):
    "K COMPLETED chain dirs, finite per-chain and pooled results"
    from bnn_priors_tpu_torch import io
    check(summary["n_diverged"] == 0 and len(summary["chain_dirs"]) == K,
          f"{tag}: {summary['n_diverged']} chains diverged")
    for c, d in enumerate(summary["chain_dirs"]):
        with open(os.path.join(d, "run.json")) as f:
            run = json.load(f)
        res = run["result"]
        check(run["status"] == "COMPLETED" and res["chain_index"] == c
              and all(math.isfinite(v) for v in res.values())
              and ("acceptance" in res) == reject, f"{tag} chain {c}: {run}")
        m = io.load_metrics(os.path.join(d, "metrics.h5"), ["potential"])
        pots = m["potential"][~np.isnan(m["potential"])]
        check(pots.size and np.all(np.isfinite(pots)), f"{tag} chain {c}")
    check(summary["pooled"] and all(math.isfinite(v) for v in
                                    summary["pooled"].values()),
          f"{tag}: pooled {summary['pooled']}")


def phase_chain_inferences(fu, card):
    """(b) the five chain inferences through the CLI at K=4 (SGLD with
    eval_skip=2 over three epochs: (d)), (c) classical HMC at K=2"""
    from bnn_priors_tpu_torch.parallel import MultiChainRunner
    K = CHAIN_K
    n_full = CHAIN_N // 128
    out, evals = {}, []
    for inference in CHAIN_INFERENCES:
        extra = dict(eval_skip=2, n_samples=2) if inference == "SGLD" else {}
        epochs = 3 if extra else 2
        expected = chain_expected_launches(inference, n_full, epochs,
                                           epochs - 1)
        with timed(MultiChainRunner, "_evaluate", evals) if extra else \
                contextlib.nullcontext():
            cfg, summary, launches, others, wall = chain_cli(
                fu, inference, K, n_train=CHAIN_N, **extra)
        reject = inference == "SGLDReject"  # the CLI's reject_samples
        check_chain_summary(f"chains (b) {inference}", summary, K, reject)
        check(launches == expected and others == 0,
              f"chains (b) {inference}: (K, T) launches {launches} (other "
              f"kernels {others}), the schedule implies {expected}")
        out[inference] = {"launches": launches, "expected": expected,
                          "wall_s": wall}
        print(f"chains (b) {inference} K={K} bf16 ok in {wall:.1f} s on "
              f"{card}: (K, T) CUDA launches {launches} == {expected}, no "
              f"other kernel; pooled {json.dumps(summary['pooled'])}")
        if extra:
            from bnn_priors_tpu_torch import io
            m = io.load_metrics(os.path.join(summary["chain_dirs"][0],
                                             "metrics.h5"), ["test/acc"])
            rows = int((~np.isnan(m["test/acc"])).sum())
            check(len(evals) == 2 and rows == 2,
                  f"chains (d) eval_skip=2: {len(evals)} test passes, "
                  f"{rows} test rows, 2 expected of 3 epochs")
            print(f"chains (d) eval_skip=2: {len(evals)} test passes over 3 "
                  f"epochs (after epochs 2 and 3), {rows} test/acc rows a "
                  f"chain, {1e3 * float(np.median(evals)):.1f} ms a pass")
    # (c) classical HMC: the exact pass at batch N for every chain
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expected = chain_expected_launches("HMC", 1, 2, 1)
    cfg, summary, launches, others, wall = chain_cli(fu, "HMC", CLASSICAL_K,
                                                     n_train=CHAIN_N)
    mem = torch.cuda.max_memory_allocated()
    check_chain_summary("chains (c) HMC", summary, CLASSICAL_K, True)
    check(launches == expected and others == 0,
          f"chains (c) HMC: (K, T) launches {launches} (other kernels "
          f"{others}), the schedule implies {expected}")
    check(mem < 40 * 2 ** 30, f"chains (c) HMC: peak {mem / 2 ** 30:.2f} GiB")
    acc = [r["acceptance"] for r in summary["chains"]]
    print(f"chains (c) classical HMC K={CLASSICAL_K} at batch N={CHAIN_N} ok "
          f"in {wall:.1f} s on {card}: (K, T) CUDA launches {launches} == "
          f"{expected}, acceptance {acc}, max_memory_allocated "
          f"{mem / 2 ** 30:.2f} GiB")
    out["HMC"] = {"launches": launches, "expected": expected, "wall_s": wall,
                  "max_memory_bytes": mem}
    return out


def cli_resume_main():
    """(e) in its own process, with deterministic algorithms as phase 13's:
    the K=4 chain CLI of VerletSGLDReject and of SGLD run (a) two cycles
    uninterrupted, (c) one cycle with checkpoint_every=1 and (d) two cycles
    resumed from (c)'s file; (a)'s and (d)'s final checkpoints must hold
    the same arrays bit for bit"""
    import warnings
    from bnn_priors_tpu_torch.ops import fused_update as fu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    hdf5_or_stand_in()
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for inference in ("VerletSGLDReject", "SGLD"):
            two = dict(cycles=2, n_samples=2, checkpoint_every=1)
            files = {}
            for run, kw in (("a", two), ("c", dict(checkpoint_every=1)),
                            ("d", two)):
                if run == "d":
                    kw = dict(kw, resume_from=files["c"])
                log_dir = os.path.join(RUNS_DIR, f"resume17_{inference}_{run}")
                _, summary, launches, _, _ = chain_cli(
                    fu, inference, CHAIN_K, n_train=RESUME_N,
                    log_dir=log_dir, **kw)
                parent = os.path.dirname(summary["chain_dirs"][0])
                runs = [os.path.join(parent, d) for d in os.listdir(parent)]
                files[run] = [os.path.join(d, "chains.ckpt.npz") for d in runs
                              if os.path.exists(os.path.join(
                                  d, "chains.ckpt.npz"))][0]
            with np.load(files["a"]) as a, np.load(files["d"]) as d:
                check(set(a.files) == set(d.files), "checkpoint entries")
                diff = [k for k in a.files if not np.array_equal(
                    a[k], d[k], equal_nan=True)]
                n = len(a.files)
            out[inference] = {"entries": n, "differ": diff,
                              "resumed_launches": launches,
                              "bytes": os.path.getsize(files["a"])}
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    print(CLI_RESUME_TAG, json.dumps({"runs": out,
                                      "nondeterministic_ops": ops}))
    return 0


def phase_chain_resume(card, proc, seconds):
    "(e): `cli_resume_main` in a subprocess (`proc`, done); bitwise or it fails"
    check(proc.returncode == 0, f"chain CLI resume subprocess failed "
          f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    res = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith(CLI_RESUME_TAG)][-1][
                          len(CLI_RESUME_TAG):])
    n_full = RESUME_N // 128
    for inference, r in res["runs"].items():
        # (d) runs epochs 3 and 4 and, rejecting, the boundary after epoch 4
        expected = chain_expected_launches(inference, n_full, 2, 1) - (
            1 if inference.endswith("Reject") else 0)
        check(not r["differ"], f"chains (e) {inference}: resumed run's "
              f"checkpoint differs from the uninterrupted one in "
              f"{r['differ']} (ops without a deterministic CUDA "
              f"implementation: {res['nondeterministic_ops']})")
        check(r["resumed_launches"] == expected,
              f"chains (e) {inference}: resumed launches "
              f"{r['resumed_launches']}, the schedule implies {expected}")
        r["expected"] = expected
        print(f"chains (e) {inference} K={CHAIN_K} CLI resume on {card}: "
              f"all {r['entries']} checkpoint entries of the resumed run "
              f"equal the uninterrupted run's bit for bit ({r['bytes']:,} "
              f"bytes); resumed (K, T) launches {r['resumed_launches']} == "
              f"{expected}; ops without a deterministic implementation: "
              f"{res['nondeterministic_ops'] or 'none'}")
    print(f"chains (e): subprocess, (a)-(c) {seconds:.1f} s")
    return res["runs"]


def phase_group_curve(data, card):
    """(f) the K=8 bf16 minibatch step with chain_group_size 8, 4, 2, 1 in
    turns (8, 4, 2, 1, 1, 2, 4, 8): ms a step (CUDA events, GROUP_STEPS),
    chain-steps/s, and a profiler window of `GROUP_PROFILE_STEPS` steps
    each (kernels, kernel time and host ops a step)"""
    from torch.profiler import ProfilerActivity, profile
    from bnn_priors_tpu_torch.exp_utils import get_model
    model = get_model("googleresnet", weight_prior="gaussian",
                      weight_scale=2 ** 0.5)
    runner = make_chain_runner(data, model, "cuda", K_CHAINS)
    idxs = runner._epoch_idxs(0, 0)
    temps = runner._temps_for(runner.epochs_per_cycle - 1)
    ms = {g: [] for g in GROUP_SIZES}
    for g in GROUP_SIZES + GROUP_SIZES[::-1]:
        runner.chain_group_size = g
        ms[g].append(chain_step_ms(runner, GROUP_STEPS))
    out = {}
    for g in GROUP_SIZES:
        runner.chain_group_size = g
        n = GROUP_PROFILE_STEPS
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                runner._chain_step(idxs[:, i], i, temps)
            torch.cuda.synchronize()
        host_ops, kernels, kernel_ms = window_counts(prof, n)
        step = float(np.mean(ms[g]))
        out[g] = {"ms": ms[g], "chain_steps_per_s": K_CHAINS * 1e3 / step,
                  "kernels": kernels, "kernel_ms": kernel_ms,
                  "host_ops": host_ops}
        turns = ", ".join(f"{v:.3f}" for v in ms[g])
        print(f"chains (f) K={K_CHAINS} group size {g} "
              f"({K_CHAINS // g} groups): {turns}"
              f" ms a step (turns), {K_CHAINS * 1e3 / step:.1f} chain-steps/s;"
              f" a step: {kernels:.0f} kernels, {kernel_ms:.3f} ms of kernel "
              f"time, {host_ops:.0f} host ops, on {card}")
    return out


def phase_chains(fu, card):
    "phase 17: (a)-(f); returns the kernels line's chain-path entries"
    from bnn_priors_tpu_torch.exp_utils import get_data
    t0 = time.perf_counter()
    # (e) in its own process while (a)-(c), which read no time, run
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t1 = time.perf_counter()
    with alongside("resume-cli-chains", env=env) as sub:
        sets = phase_chain_kernel_sets(fu)
        paths = phase_chain_inferences(fu, card)
    resume = phase_chain_resume(card, sub["proc"], time.perf_counter() - t1)
    data = get_data("fake_cifar10", n_train=N_TRAIN, n_test=N_TEST)
    curve = phase_group_curve(data, card)
    print(f"phase 17 (every inference on the chain axis) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = {k: v["launches"] for k, v in paths.items()}
    expected = {k: v["expected"] for k, v in paths.items()}
    for k, v in resume.items():
        launches["resume_" + k] = v["resumed_launches"]
        expected["resume_" + k] = v["expected"]
    return {"sets": sets, "launches": launches, "expected": expected,
            "curve": curve}


# ------------------- phase 18: the CLI's defaults, MNIST and UCI paths --
MNIST_N, MNIST_N_TEST = 60000, 10000   # MNIST's own sizes, uncut
# this slice's packed lengths before padding: the CNN and the FCNN at width
# 50 and depth 3, densenet on UCI_boston (13 features) with noise_std.p
MNIST_TOTALS = (("classificationconvnet", 47560),
                ("classificationdensenet", 42310),
                ("densenet/UCI_boston", 3302))
UCI_DATA, UCI_K = "UCI_boston", 4
# (c): the other models on 5,000 / 1,000 images, one cycle each
MNIST_OTHERS = (
    ("classificationdensenet", "mnist", {}),
    ("correlatedclassificationconvnet", "mnist",
     dict(weight_prior="convcorrnormal",
          weight_prior_params={"lengthscale_1": 0.7, "lengthscale_2": 2.5})),
    ("classificationconvnet", "fashion_mnist", {}))
# (d): (model, data, inference, K, compute dtype) through both chain loops
MNIST_CHAINS = (
    ("classificationconvnet", "mnist", "VerletSGLDReject", K_CHAINS,
     "bfloat16"),
    ("classificationdensenet", "mnist", "SGLD", UCI_K, None),
    ("densenet", UCI_DATA, "VerletSGLDReject", UCI_K, None),
    ("densenet", UCI_DATA, "SGLD", UCI_K, "bfloat16"))


def other_launches(fu, *keep):
    "launches of every kernel counter but the ones named in `keep`"
    names = ("launches", "chain_launches", "triton_launches",
             "triton_chain_launches", "segments_launches",
             "segments_chain_launches")
    return sum(getattr(fu, n) for n in names if n not in keep)


def phase_mnist_kernel(fu):
    """(a) the (T,) kernel against its plain version at this slice's
    lengths and the (K, T) kernel at K=8 of the CNN's, noise on, with phase
    1's tolerances; each length's call time beside the plain version's and
    the byte bound"""
    from bnn_priors_tpu_torch.mcmc.packing import PACK_ALIGN
    gen = torch.Generator().manual_seed(18)
    sets = coefficient_sets(0.01, MNIST_N, 0.994, 0.99)
    names = ("sgld_mid", "ggmc_initial", "ggmc_mid", "ggmc_final")
    out = {"max_abs_err": 0.0, "chains_max_abs_err": 0.0, "timing": {}}
    for model, total in MNIST_TOTALS:
        T = -(-total // PACK_ALIGN) * PACK_ALIGN
        base = kernel_inputs(T, total, gen)
        for name in names:
            for sigma, atol in ((0.0, 1e-6), (1.0, 1e-5)):
                c = with_sigma(sets[name], sigma)
                ker = [t.clone() for t in base]
                ref = [t.clone() for t in base]
                *_, pk = fu.fused_langevin_update(*ker, 1818, c, total=total)
                *_, pr = fu.fused_langevin_update_reference(*ref, 1818, c,
                                                            total=total)
                err, rel = compare_to_plain(
                    f"mnist (a) {name} T={T} sigma={sigma}", ker, ref, pk,
                    pr, total, atol, lambda t: t[total:])
                out["max_abs_err"] = max(out["max_abs_err"], err)
        c = with_sigma(sets["ggmc_mid"], 0.5)
        call = lambda: fu.fused_langevin_update(*base, 7, c, total=total)
        t = {"T": T, "total": total, "ms": time_ms(call, 100),
             "plain_ms": time_ms(lambda: fu.fused_langevin_update_reference(
                 *base, 7, c, total=total), 100),
             "bound_ms": 1e3 * max(32 * T / H100_BYTES_PER_S,
                                   14 * T / H100_F32_OPS_PER_S)}
        out["timing"][model] = t
        print(f"mnist (a) (T,) kernel == plain for {model}: T={T} "
              f"total={total}, 4 coefficient sets at noise_std 0 and 1, max "
              f"|d| {out['max_abs_err']:.2e}; a call {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"(32 B x {T})")
    K, total = K_CHAINS, MNIST_TOTALS[0][1]
    T = -(-total // PACK_ALIGN) * PACK_ALIGN
    base = chain_kernel_inputs(K, T, total, gen)
    seeds = chain_seeds(K)
    sigma = torch.linspace(0.1, 1.0, K, device="cuda")
    for name in names:
        mom_decay, grad_lr, _, pos_c, alpha = sets[name]
        c4 = (mom_decay, grad_lr, pos_c, alpha)
        ker = [t.clone() for t in base]
        ref = [t.clone() for t in base]
        *_, pk = fu.fused_langevin_update_chains(*ker, seeds, sigma, c4,
                                                 total=total, seed_offset=2)
        *_, pr = fu.fused_langevin_update_chains_reference(
            *ref, seeds, sigma, c4, total=total, seed_offset=2)
        err, _ = compare_to_plain(f"mnist (a) chains {name}", ker, ref, pk,
                                  pr, total, 1e-5, lambda t: t[:, total:])
        out["chains_max_abs_err"] = max(out["chains_max_abs_err"], err)
    mom_decay, grad_lr, _, pos_c, alpha = sets["ggmc_mid"]
    c4 = (mom_decay, grad_lr, pos_c, alpha)
    t = {"K": K, "T": T, "total": total,
         "ms": time_ms(lambda: fu.fused_langevin_update_chains(
             *base, seeds, sigma, c4, total=total), 100),
         "plain_ms": time_ms(lambda: fu.fused_langevin_update_chains_reference(
             *base, seeds, sigma, c4, total=total), 100),
         "bound_ms": 1e3 * max(32 * K * T / H100_BYTES_PER_S,
                               14 * K * T / H100_F32_OPS_PER_S)}
    out["chains_timing"] = t
    print(f"mnist (a) (K, T) kernel == plain: K={K} T={T} total={total}, 4 "
          f"coefficient sets, per-chain noise_std: max |d| "
          f"{out['chains_max_abs_err']:.2e}; a call {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
          f"(32 B x {K} x {T})")
    return out


def write_mnist_roots():
    """synthetic IDX files in MNIST's format from seed 0 (class rows as
    FakeMNIST's): MNIST's 60,000 / 10,000 under <root>/full/MNIST, and
    5,000 / 1,000 of them gzipped under <root>/small/MNIST and
    <root>/small/FashionMNIST, <root> a directory of the checkout's
    build/"""
    import tempfile

    from bnn_priors_tpu_torch.data import write_idx_files
    build = os.path.dirname(RUNS_DIR)
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="mnist_files_", dir=build)
    n = MNIST_N + MNIST_N_TEST
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n)
    x = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    for c in range(10):
        x[y == c, 2 + c, :] = 255
    t0 = time.perf_counter()
    train, test = slice(0, MNIST_N), slice(MNIST_N, n)
    write_idx_files(os.path.join(root, "full", "MNIST"), x[train], y[train],
                    x[test], y[test])
    small = (x[:N_TRAIN], y[:N_TRAIN], x[MNIST_N:MNIST_N + N_TEST],
             y[MNIST_N:MNIST_N + N_TEST])
    for sub in ("MNIST", "FashionMNIST"):
        write_idx_files(os.path.join(root, "small", sub), *small, gz=True)
    print(f"mnist files: {n:,} images as IDX files and {N_TRAIN:,} / "
          f"{N_TEST:,} of them gzipped, written in "
          f"{time.perf_counter() - t0:.2f} s")
    return root


@contextlib.contextmanager
def data_root(path):
    "BNN_PRIORS_DATA set to `path` for the block"
    before = os.environ.get("BNN_PRIORS_DATA")
    os.environ["BNN_PRIORS_DATA"] = path
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("BNN_PRIORS_DATA", None)
        else:
            os.environ["BNN_PRIORS_DATA"] = before


def single_expected(n_train, batch, epochs, boundaries):
    """(T,) launches of a single-chain reject run: one initial step, one a
    minibatch step (the tail batch too) and two at each boundary"""
    return 1 + -(-n_train // batch) * epochs + 2 * boundaries


def mnist_cli(fu, tag, **kw):
    """one single-chain CLI run: its result, run dir, launches and wall
    time; every kernel but the (T,) one must stay idle"""
    from bnn_priors_tpu_torch.experiments import train_bnn
    cfg = cli_config(train_bnn, cycles=1, warmup=1, burnin=0, n_samples=1,
                     skip_first=0, log_dir=os.path.join(RUNS_DIR, tag))
    cfg.update(kw)
    reset_counts(fu)
    t0 = time.perf_counter()
    result = train_bnn.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_dir = os.path.join(cfg["log_dir"], "1")
    with open(os.path.join(run_dir, "run.json")) as f:
        run = json.load(f)
    check(run["status"] == "COMPLETED" and run["result"] == result
          and all(math.isfinite(v) for v in result.values()),
          f"mnist {tag}: run.json {run['status']}, result {result}")
    check(other_launches(fu, "launches") == 0,
          f"mnist {tag}: {other_launches(fu, 'launches')} launches of other "
          "kernels")
    return result, run_dir, fu.launches, wall


def phase_mnist_defaults(fu, card, roots):
    """(b) train_bnn with its own data, model, width, depth and inference
    on MNIST-sized IDX files, one cycle of 2 epochs: launches, the epoch
    and the M-H boundary by part; then eval_bnn with calibration and on
    rotated_mnist"""
    from bnn_priors_tpu_torch import evaluate, io
    from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
    from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject as R
    d = train_bnn.DEFAULTS
    B = d["batch_size"]
    steps = -(-MNIST_N // B)
    expected = single_expected(MNIST_N, B, 2, 1)
    print(f"mnist (b): train_bnn with its defaults data={d['data']} "
          f"model={d['model']} width={d['width']} depth={d['depth']} "
          f"inference={d['inference']}, {MNIST_N:,} / {MNIST_N_TEST:,} "
          f"images, cycles=1 warmup=1 n_samples=1 batch_size={B}")
    t = {k: [] for k in ("exact", "final", "eval", "initial", "evaluate")}
    with data_root(os.path.join(roots, "full")), contextlib.ExitStack() as st:
        for owner, name, key in ((R, "_exact_vg", "exact"),
                                 (R, "_boundary_final", "final"),
                                 (R, "_evaluate_and_log", "eval"),
                                 (R, "_boundary_initial", "initial"),
                                 (evaluate, "evaluate_model", "evaluate")):
            st.enter_context(timed(owner, name, t[key]))
        result, run_dir, launches, wall = mnist_cli(fu, "mnist18")
    check(launches == expected, f"mnist (b): (T,) launches {launches}, the "
          f"schedule implies {expected} = 1 + {steps} x 2 + 2")
    m = io.load_metrics(os.path.join(run_dir, "metrics.h5"),
                        ["potential", "timings/epoch_s"])
    pots = m["potential"][~np.isnan(m["potential"])]
    check(pots.size > 2 * steps // d["metrics_skip"]
          and np.all(np.isfinite(pots)), "mnist (b) potentials")
    epoch_s = m["timings/epoch_s"][~np.isnan(m["timings/epoch_s"])]
    steps_s = epoch_s[0] - t["eval"][0]
    out = {"wall_s": wall, "epoch_ms": 1e3 * epoch_s[0],
           "steps_ms": 1e3 * steps_s, "steps_per_s": steps / steps_s,
           "test_pass_ms": 1e3 * t["eval"][0],
           "boundary_ms": 1e3 * (t["final"][0] + t["eval"][1]
                                 + t["initial"][0]),
           "exact_ms": 1e3 * t["exact"][1], "first_exact_ms":
           1e3 * t["exact"][0], "evaluate_model_ms": 1e3 * t["evaluate"][0],
           "launches": launches, "expected": expected, "result": result}
    print(f"mnist (b) ok in {wall:.1f} s: result {json.dumps(result)}, "
          f"(T,) CUDA launches {launches} == {expected} = 1 + {steps} x 2 + "
          f"2, no other kernel")
    print(f"mnist (b) on {card}: epoch 0 {out['epoch_ms']:.1f} ms, of which "
          f"{steps} minibatch steps {out['steps_ms']:.1f} ms = "
          f"{out['steps_per_s']:.1f} steps/s and the test pass of "
          f"{MNIST_N_TEST:,} points {out['test_pass_ms']:.1f} ms; M-H "
          f"boundary {out['boundary_ms']:.1f} ms (exact pass over "
          f"{MNIST_N:,} points {out['exact_ms']:.1f} ms); the run's first "
          f"exact pass {out['first_exact_ms']:.1f} ms; evaluate_model "
          f"{out['evaluate_model_ms']:.1f} ms")
    with data_root(os.path.join(roots, "full")):
        for extra in (dict(calibration_eval=True),
                      dict(eval_data="rotated_mnist")):
            cfg = cli_config(eval_bnn, run_dir=run_dir, skip_first=0,
                             log_dir=os.path.join(RUNS_DIR, "mnist18_eval"),
                             **extra)
            t0 = time.perf_counter()
            ev = eval_bnn.main(cfg)
            wall = time.perf_counter() - t0
            check(all(math.isfinite(v) for v in ev.values()),
                  f"mnist (b) eval_bnn {extra}: {ev}")
            if "calibration_eval" in extra:
                for k, v in result.items():
                    check(math.isclose(ev[k], v, rel_tol=1e-5),
                          f"mnist (b) eval_bnn {k} {ev[k]} vs {v}")
                check(0.0 <= ev["ece"] <= 1.0, f"ece {ev['ece']}")
            print(f"mnist (b) eval_bnn {extra} ok in {wall:.1f} s: "
                  f"{json.dumps(ev)}")
    return out


def phase_mnist_others(fu, card, roots):
    """(c) the FCNN, the correlated CNN with both lengthscales and the CNN
    on fashion_mnist, 5,000 / 1,000 images, one cycle of 2 epochs each"""
    expected = single_expected(N_TRAIN, 128, 2, 1)
    out = {}
    with data_root(os.path.join(roots, "small")):
        for model, data, kw in MNIST_OTHERS:
            tag = f"{model}/{data}"
            result, _, launches, wall = mnist_cli(
                fu, "mnist18_" + model + "_" + data, model=model, data=data,
                **kw)
            check(launches == expected, f"mnist (c) {tag}: (T,) launches "
                  f"{launches}, the schedule implies {expected}")
            out[tag] = {"launches": launches, "expected": expected,
                        "wall_s": wall}
            print(f"mnist (c) {tag} {kw or ''} ok in {wall:.1f} s on {card}:"
                  f" (T,) CUDA launches {launches} == {expected}, no other "
                  f"kernel; result {json.dumps(result)}")
    return out


def phase_mnist_chains(fu, card, roots):
    """(d) the chain CLI: the CNN with K=8 in bf16 through
    MultiChainRunnerReject, the FCNN with K=4 through the plain loop, and
    densenet on UCI_boston with K=4 through both; (K, T) launches against
    the runners' count and no other kernel"""
    from bnn_priors_tpu_torch.experiments import train_bnn
    out = {}
    with data_root(os.path.join(roots, "small")):
        for model, data, inference, K, dtype in MNIST_CHAINS:
            reject = inference.endswith("Reject")
            cfg = cli_config(train_bnn, model=model, data=data,
                             inference=inference, n_chains=K,
                             compute_dtype=dtype, temperature=1.0, cycles=1,
                             warmup=1, burnin=0, n_samples=1, skip_first=0,
                             reject_samples=reject,
                             log_dir=os.path.join(RUNS_DIR, "mnist18_chains_"
                                                  f"{model}_{inference}"))
            n_train = N_TRAIN if data == "mnist" else uci_n_train()
            expected = chain_expected_launches(inference, n_train // 128, 2,
                                               1)
            reset_counts(fu)
            t0 = time.perf_counter()
            summary = train_bnn.main(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tag = f"{model}/{data} {inference} K={K} {dtype or 'float32'}"
            check_chain_summary(f"mnist (d) {tag}", summary, K, reject)
            others = other_launches(fu, "chain_launches")
            check(fu.chain_launches == expected and others == 0,
                  f"mnist (d) {tag}: (K, T) launches {fu.chain_launches} "
                  f"(other kernels {others}), the runners' count {expected}")
            out[f"{model}/{data}/{inference}/K{K}"] = {
                "launches": fu.chain_launches, "expected": expected,
                "wall_s": wall}
            print(f"mnist (d) {tag} ok in {wall:.1f} s on {card}: (K, T) "
                  f"CUDA launches {fu.chain_launches} == {expected}, no "
                  f"other kernel; pooled {json.dumps(summary['pooled'])}")
    return out


def uci_n_train():
    "the training points of UCI_DATA's split 0"
    from bnn_priors_tpu_torch.exp_utils import get_data
    return int(get_data(UCI_DATA).norm.train_X.shape[0])


def phase_uci(fu, card):
    """(e) densenet on UCI_boston, one chain (VerletSGLDReject, two
    sampling epochs), eval_bnn on its dir, and evaluate_model over its bank
    on the card in f32 against the CPU in f64"""
    from bnn_priors_tpu_torch import io
    from bnn_priors_tpu_torch.evaluate import evaluate_model
    from bnn_priors_tpu_torch.exp_utils import get_data
    from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
    n_train = uci_n_train()
    expected = single_expected(n_train, 128, 3, 2)
    result, run_dir, launches, wall = mnist_cli(
        fu, "uci18", data=UCI_DATA, model="densenet", n_samples=2,
        reject_samples=True)
    check(launches == expected, f"uci (e): (T,) launches {launches}, the "
          f"schedule implies {expected}")
    bank = io.load_samples(os.path.join(run_dir, "samples.pt"))
    noise = bank["noise_std.p"]
    check(noise.shape == (2,) and np.all(np.isfinite(noise))
          and np.all(np.exp(noise) > 0), f"uci (e) noise_std.p {noise}")
    print(f"uci (e) densenet on {UCI_DATA} ({n_train} training points) ok "
          f"in {wall:.1f} s on {card}: (T,) CUDA launches {launches} == "
          f"{expected}, noise_std {np.exp(noise)}, result "
          f"{json.dumps(result)}")
    ev = eval_bnn.main(cli_config(eval_bnn, run_dir=run_dir, skip_first=0,
                                  log_dir=os.path.join(RUNS_DIR, "uci18_eval")))
    for k, v in result.items():
        check(math.isclose(ev[k], v, rel_tol=1e-5),
              f"uci (e) eval_bnn {k} {ev[k]} vs {v}")
    res = {}
    for where, device, dtype in (("card", "cuda", torch.float32),
                                 ("cpu", "cpu", torch.float64)):
        data = get_data(UCI_DATA, device=device)
        cfg = dict(train_bnn.DEFAULTS, data=UCI_DATA, model="densenet")
        model = train_bnn.model_of(cfg, device, train=data.norm.train).to(
            dtype)
        test = tuple(t.to(dtype) for t in data.norm.test)
        res[where] = evaluate_model(model, test, bank)
    for k in res["cpu"]:
        check(math.isclose(res["card"][k], res["cpu"][k], rel_tol=1e-4,
                           abs_tol=1e-5),
              f"uci (e) evaluate_model {k}: card {res['card'][k]} vs CPU "
              f"{res['cpu'][k]}")
    print(f"uci (e) eval_bnn reproduces the run (rtol 1e-5); evaluate_model "
          f"card f32 {json.dumps(res['card'])} vs CPU f64 "
          f"{json.dumps(res['cpu'])} (rel 1e-4)")
    return {"launches": launches, "expected": expected, "wall_s": wall,
            "evaluate": res}


def phase_mnist_card_vs_cpu(card, roots):
    """(f) each new model's forward pass and log-likelihood on 256 points,
    card f32 against CPU f64 at the same parameters; the K=8 chain fold
    against 8 single forwards on the card"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model
    with data_root(os.path.join(roots, "small")):
        mnist = get_data("mnist")
    uci = get_data(UCI_DATA)
    names = ("classificationconvnet", "correlatedclassificationconvnet",
             "classificationdensenet", "logistic", "densenet", "linear")
    for name in names:
        data = uci if name in ("densenet", "linear") else mnist
        x, y = data.norm.train
        card_m = get_model(name, x_train=x, y_train=y, seed=3)
        cpu_m = get_model(name, x_train=x, y_train=y, seed=3, device="cpu",
                          dtype=torch.float64)
        with torch.no_grad():
            for k, v in card_m.params().items():
                cpu_m.params()[k].copy_(v.double().cpu())
            xs, ys = (t[:256] for t in data.norm.test)
            ll_c, f_c = card_m.log_likelihood(card_m.params(), xs, ys, 1.0)
            ll_r, f_r = cpu_m.log_likelihood(cpu_m.params(),
                                             xs.double().cpu(), ys.cpu(), 1.0)
        f_err = float((f_c.double().cpu() - f_r).abs().max())
        scale = float(f_r.abs().max())
        rel = abs(float(ll_c) - float(ll_r)) / abs(float(ll_r))
        check(f_err <= 1e-4 * max(scale, 1.0) and rel <= 1e-4,
              f"card vs CPU {name}: f off by {f_err} (scale {scale}), "
              f"log-likelihood rel {rel}")
        print(f"mnist (f) {name}: card f32 vs CPU f64 on 256 points: f max "
              f"|d| {f_err:.2e} (max |f| {scale:.2f}), log-likelihood rel "
              f"{rel:.2e}")
    K = K_CHAINS
    for name in ("classificationconvnet", "classificationdensenet",
                 "densenet"):
        data = uci if name == "densenet" else mnist
        x, y = data.norm.train
        m = get_model(name, x_train=x, y_train=y, seed=4)
        per = []
        for c in range(K):
            m.init(torch.Generator().manual_seed(40 + c))
            per.append({k: v.detach().clone() for k, v in m.params().items()})
        bank = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        B = 32
        xk = x[:K * B].reshape(K, B, -1)
        yk = y[:K * B].reshape(K, B, *y.shape[1:])
        with torch.no_grad():
            ll, f = m.log_likelihood(bank, xk, yk, 1.0, buffers={})
            err, scale = 0.0, float(f.abs().max())
            for c in range(K):
                llc, fc = m.log_likelihood(per[c], xk[c], yk[c], 1.0)
                err = max(err, float((f[c] - fc).abs().max()))
                check(math.isclose(float(ll[c]), float(llc), rel_tol=1e-4),
                      f"chain fold {name} chain {c}: {ll[c]} vs {llc}")
        check(err <= 1e-4 * max(scale, 1.0),
              f"chain fold {name}: f off by {err} (max |f| {scale})")
        print(f"mnist (f) {name}: the K={K} chain fold equals {K} single "
              f"forwards on the card (f32): f max |d| {err:.2e}")


def phase_mnist_steps(card, roots):
    """(g) ms a minibatch step (CUDA events): the CNN and the FCNN, one
    chain in f32 (25 steps, in turns), the CNN with K=8 in bf16 (25
    steps); a 10-step profiler window each"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    with data_root(os.path.join(roots, "full")):
        data = get_data("mnist")
    x, y = data.norm.train
    runners = {}
    for name in ("classificationconvnet", "classificationdensenet"):
        model = get_model(name, x_train=x, y_train=y)
        he_initialize(model, torch.Generator().manual_seed(0))
        runners[name] = make_runner(data, model, "cuda")
    ms = {name: [] for name in runners}
    for name in ("classificationconvnet", "classificationdensenet",
                 "classificationdensenet", "classificationconvnet"):
        ms[name].append(phase_step_time(runners[name]))
    for name, r in runners.items():
        print(f"mnist (g) {name} one chain f32: "
              f"{', '.join(f'{v:.3f}' for v in ms[name])} ms a step (turns), "
              f"batch 128, on {card}")
        phase_profile(r, float(np.mean(ms[name])), f"mnist {name}")
    model = get_model("classificationconvnet", x_train=x, y_train=y)
    chains = make_chain_runner(data, model, "cuda", K_CHAINS)
    step = chain_step_ms(chains, 50)
    print(f"mnist (g) classificationconvnet K={K_CHAINS} bf16: {step:.3f} ms "
          f"a step of {K_CHAINS} chains, {K_CHAINS * 1e3 / step:.1f} "
          f"chain-steps/s, batch 128 a chain, on {card}")
    phase_chain_profile(chains, step, "mnist cnn")


def phase_mnist(fu, card):
    "phase 18: (a)-(g); returns the kernels line's MNIST and UCI entries"
    t0 = time.perf_counter()
    kernel = phase_mnist_kernel(fu)
    roots = write_mnist_roots()
    try:
        defaults = phase_mnist_defaults(fu, card, roots)
        others = phase_mnist_others(fu, card, roots)
        chains = phase_mnist_chains(fu, card, roots)
        uci = phase_uci(fu, card)
        phase_mnist_card_vs_cpu(card, roots)
        phase_mnist_steps(card, roots)
    finally:
        shutil.rmtree(roots, ignore_errors=True)
    print(f"phase 18 (the CLI's defaults, MNIST and UCI) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    single = {"defaults": defaults["launches"],
              **{k: v["launches"] for k, v in others.items()}}
    single_expected = {"defaults": defaults["expected"],
                       **{k: v["expected"] for k, v in others.items()}}
    is_uci = lambda k: UCI_DATA in k
    return {"single": {"mnist_launches": single,
                       "mnist_expected": single_expected,
                       "uci_launches": {UCI_DATA: uci["launches"]},
                       "uci_expected": {UCI_DATA: uci["expected"]},
                       "mnist_lengths": kernel["timing"]},
            "chains": {"mnist_launches": {k: v["launches"] for k, v in
                                          chains.items() if not is_uci(k)},
                       "mnist_expected": {k: v["expected"] for k, v in
                                          chains.items() if not is_uci(k)},
                       "uci_launches": {k: v["launches"] for k, v in
                                        chains.items() if is_uci(k)},
                       "uci_expected": {k: v["expected"] for k, v in
                                        chains.items() if is_uci(k)},
                       "mnist_lengths": {"K8/classificationconvnet":
                                         kernel["chains_timing"]}}}


# ------ phase 19: the PreAct ResNets and the data-driven models, full width --
R18_TOTAL, R18_T = 11171146, 11171840  # resnet18's parameters, padded length
SHORT_N, SHORT_N_TEST = 640, 256       # (c), (e)'s files: 5 steps an epoch
DE_N, DE_N_TEST = 16, 16               # (d)'s boundary: training, test points


def preact_short_runs():
    """(e)'s runs: (tag, data, train_bnn keys); the fitted files are the
    port's bundled copies"""
    from bnn_priors_tpu_torch.models import default_fits_root
    fit = lambda name: os.path.join(default_fits_root(), name)
    return (
        ("thin_resnet18", "cifar10", dict(model="thin_resnet18")),
        ("resnet34", "cifar10", dict(model="resnet34")),
        ("vwidth_resnet18/32", "cifar10", dict(model="vwidth_resnet18",
                                              width=32)),
        ("datadriven_resnet18/mean_covs", "cifar10", dict(
            model="datadriven_resnet18", weight_prior="fixedcov_normal",
            weight_prior_params={"mean_covs_file":
                                 fit("cifar10_mean_covs.pkl.gz")})),
        ("datadriven_resnet18/weight_fits", "cifar10", dict(
            model="datadriven_resnet18", weight_prior="fixedcov_gennorm",
            weight_prior_params={"fits_dict_file":
                                 fit("cifar10_weight_fits.pkl.gz"),
                                 "beta": 2.0})),
        ("resnet18/lengthscales", "cifar10", dict(
            model="resnet18", weight_prior="convcorrnormal",
            weight_prior_params={"lengthscale_dict_file": fit(
                "cifar10_fitted_lengthscales.pkl.gz")})),
        ("datadrivengaussconv", "mnist", dict(model="datadrivengaussconv")),
        ("datadrivendoublegammaconv", "mnist",
         dict(model="datadrivendoublegammaconv")),
        ("datadriven_mvt_googleresnet", "cifar10",
         dict(model="datadriven_mvt_googleresnet")),
        ("decreasing_mvt_googleresnet", "cifar10",
         dict(model="decreasing_mvt_googleresnet",
              weight_prior="convcorrnormal")))


def update_timing(fu, call, plain, T, K=1, plain_n=5):
    """a call (events), back to back, device µs a launch (profiler, hot),
    the plain version's call and the bound of one update over K × T, and
    the share of the bound a launch reaches by the profiler and by the
    back-to-back events (at these lengths a launch outlasts the host's
    enqueue, so back to back is device time too)"""
    dev, _ = device_us(call, "langevin_update", n=20)
    b2b = back_to_back_ms(call, 50)
    bound = 1e3 * max(32 * K * T / H100_BYTES_PER_S,
                      14 * K * T / H100_F32_OPS_PER_S)
    return {"K": K, "T": T, "ms": time_ms(call, 50), "b2b_ms": b2b,
            "device_us": dev, "plain_ms": time_ms(plain, plain_n),
            "bound_ms": bound,
            "share": None if dev is None else bound * 1e3 / dev,
            "share_b2b": bound / b2b}


def phase_preact_kernel(fu):
    """(a) the (T,) kernel and the (K, T) kernel at K=8 against their plain
    versions at resnet18's length, noise on, phase 1's tolerances (θ, m, v
    atol 1e-5, partials rtol 1e-4, tails 0; a partial that cancels also
    within 1e-7 of its summed magnitudes); their times against the byte
    bounds"""
    from bnn_priors_tpu_torch.mcmc.packing import PACK_ALIGN
    T, total, K = R18_T, R18_TOTAL, K_CHAINS
    check(-(-total // PACK_ALIGN) * PACK_ALIGN == T, "resnet18's padded T")
    gen = torch.Generator().manual_seed(19)
    sets = coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)
    names = ("sgld_mid", "ggmc_initial", "ggmc_mid", "ggmc_final")
    out = {"max_abs_err": 0.0, "chains_max_abs_err": 0.0}
    base = kernel_inputs(T, total, gen)
    for name in names:
        c = with_sigma(sets[name], 1.0)
        ker = [t.clone() for t in base]
        ref = [t.clone() for t in base]
        *_, pk = fu.fused_langevin_update(*ker, 1919, c, total=total)
        *_, pr = fu.fused_langevin_update_reference(*ref, 1919, c,
                                                    total=total)
        err, rel = compare_to_plain(f"preact (a) {name} T={T}", ker, ref, pk,
                                    pr, total, 1e-5, lambda t: t[total:],
                                    partials_allowance(base, ref))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        print(f"preact (a) (T,) kernel == plain: {name:13s} T={T} noise_std "
              f"1: max |d| {err:.2e}, partials rel err {rel:.2e}")
        del ker, ref
    c = with_sigma(sets["ggmc_mid"], 0.5)
    out["timing"] = t = update_timing(
        fu, lambda: fu.fused_langevin_update(*base, 7, c, total=total),
        lambda: fu.fused_langevin_update_reference(*base, 7, c, total=total),
        T)
    del base
    seeds = chain_seeds(K)
    sigma = torch.linspace(0.1, 1.0, K, device="cuda")
    base = chain_kernel_inputs(K, T, total, gen)
    for name in names:
        mom_decay, grad_lr, _, pos_c, alpha = sets[name]
        c4 = (mom_decay, grad_lr, pos_c, alpha)
        ker = [t.clone() for t in base]
        ref = [t.clone() for t in base]
        *_, pk = fu.fused_langevin_update_chains(*ker, seeds, sigma, c4,
                                                 total=total, seed_offset=3)
        *_, pr = fu.fused_langevin_update_chains_reference(
            *ref, seeds, sigma, c4, total=total, seed_offset=3)
        err, rel = compare_to_plain(f"preact (a) chains {name}", ker, ref, pk,
                                    pr, total, 1e-5, lambda t: t[:, total:],
                                    partials_allowance(base, ref))
        out["chains_max_abs_err"] = max(out["chains_max_abs_err"], err)
        print(f"preact (a) (K, T) kernel == plain: {name:13s} K={K} T={T} "
              f"per-chain noise_std: max |d| {err:.2e}, partials rel err "
              f"{rel:.2e}")
        del ker, ref
    mom_decay, grad_lr, _, pos_c, alpha = sets["ggmc_mid"]
    c4 = (mom_decay, grad_lr, pos_c, alpha)
    out["chains_timing"] = tk = update_timing(
        fu, lambda: fu.fused_langevin_update_chains(*base, seeds, sigma, c4,
                                                    total=total),
        lambda: fu.fused_langevin_update_chains_reference(
            *base, seeds, sigma, c4, total=total), T, K, plain_n=3)
    del base
    fmt = lambda x, f: "not measured" if x is None else format(x, f)
    for form, r in (("(T,)", t), (f"(K, T) K={K}", tk)):
        print(f"preact (a) {form} at T={T}: a call {r['ms']:.4f} ms, back to "
              f"back {r['b2b_ms']:.4f} ms, device {fmt(r['device_us'], '.2f')}"
              f" us a launch against the byte bound {r['bound_ms'] * 1e3:.2f} "
              f"us (32 B x {r['K']} x {T}): {fmt(r['share'], '.1%')} "
              f"(back to back: {r['share_b2b']:.1%}); plain "
              f"{r['plain_ms']:.3f} ms a call")
    torch.cuda.empty_cache()
    return out


def write_preact_roots():
    """synthetic files from seed 0 under a directory of the checkout's
    build/: CIFAR-10 batches of 5,000 / 1,000 images (main), of 640 / 256
    (short) and MNIST IDX files of 640 / 256 (short/MNIST)"""
    import tempfile

    from bnn_priors_tpu_torch.data import write_cifar10_batches, \
        write_idx_files
    build = os.path.dirname(RUNS_DIR)
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="preact_files_", dir=build)
    rng = np.random.RandomState(0)
    n = N_TRAIN + N_TEST
    y = rng.randint(0, 10, n)
    x = rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    for c in range(10):
        x[y == c, :, 2 + c, :] = 255
    cut = lambda a, m, t: (a[:m], a[N_TRAIN:N_TRAIN + t])
    for sub, m, t in (("main", N_TRAIN, N_TEST),
                      ("short", SHORT_N, SHORT_N_TEST)):
        (xa, xb), (ya, yb) = cut(x, m, t), cut(y, m, t)
        write_cifar10_batches(os.path.join(root, sub, "CIFAR"), xa, ya, xb,
                              yb)
    xm = x[:, 0, 2:30, 2:30]  # 28x28 single-channel images
    (xa, xb), (ya, yb) = cut(xm, SHORT_N, SHORT_N_TEST), cut(y, SHORT_N,
                                                              SHORT_N_TEST)
    write_idx_files(os.path.join(root, "short", "MNIST"), xa, ya, xb, yb)
    return root


def phase_preact_cli(fu, card, root):
    """(b) train_bnn data=cifar10 model=resnet18 inference=VerletSGLDReject
    on 5,000 / 1,000 images, one cycle of 2 epochs: (T,) launches against
    the schedule's and no other kernel, the M-H boundary and its exact pass;
    then ms a step over 25 steps (events) and a profiler window"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject as R
    expected = single_expected(N_TRAIN, 128, 2, 1)
    t = {k: [] for k in ("exact", "final", "eval", "initial")}
    with data_root(os.path.join(root, "main")), contextlib.ExitStack() as st:
        for name, key in (("_exact_vg", "exact"), ("_boundary_final", "final"),
                          ("_evaluate_and_log", "eval"),
                          ("_boundary_initial", "initial")):
            st.enter_context(timed(R, name, t[key]))
        torch.cuda.reset_peak_memory_stats()
        result, run_dir, launches, wall = mnist_cli(
            fu, "preact19", data="cifar10", model="resnet18",
            inference="VerletSGLDReject", reject_samples=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        data = get_data("cifar10")
    check(launches == expected, f"preact (b): (T,) launches {launches}, the "
          f"schedule implies {expected}")
    out = {"launches": launches, "expected": expected, "wall_s": wall,
           "peak_gib": peak, "boundary_ms": 1e3 * (t["final"][0] + t["eval"][1]
                                                   + t["initial"][0]),
           "exact_ms": 1e3 * t["exact"][1], "result": result}
    print(f"preact (b) resnet18 CLI ok in {wall:.1f} s on {card}: (T,) CUDA "
          f"launches {launches} == {expected}, no other kernel; M-H boundary "
          f"{out['boundary_ms']:.1f} ms (exact pass over {N_TRAIN:,} points "
          f"{out['exact_ms']:.1f} ms); peak {peak:.2f} GiB; result "
          f"{json.dumps(result)}")
    model = get_model("resnet18")
    he_initialize(model, torch.Generator().manual_seed(0))
    runner = make_runner(data, model, "cuda")
    check(runner.kernel.packer.total_padded == R18_T, "resnet18's T")
    ms = [phase_step_time(runner) for _ in range(2)]
    print(f"preact (b) resnet18 one chain f32: "
          f"{', '.join(f'{v:.3f}' for v in ms)} ms a step (25 steps each), "
          f"batch 128, on {card}")
    out["step_ms"] = ms
    out["window"] = w = phase_profile(runner, float(np.mean(ms)), "resnet18")
    print(f"preact (b) the update: {w['update_ms']:.4f} ms of a "
          f"{float(np.mean(ms)):.3f} ms step = {w['update_share']:.2%}; the "
          f"window's own step {w['window_ms']:.3f} ms, busy "
          f"{w['busy_window']:.1%}")
    return out


def phase_preact_chains(fu, card, root):
    """(c) the K=8 bf16 reject CLI on resnet18 over 640 / 256 images:
    (K, T) launches against the runners' count and no other kernel, peak
    memory; then chain-steps/s and a profiler window"""
    import gc

    from bnn_priors_tpu_torch.exp_utils import get_data, get_model
    from bnn_priors_tpu_torch.experiments import train_bnn
    K = K_CHAINS
    cfg = cli_config(train_bnn, data="cifar10", model="resnet18",
                     inference="VerletSGLDReject", n_chains=K,
                     compute_dtype="bfloat16", temperature=1.0, cycles=1,
                     warmup=1, burnin=0, n_samples=1, skip_first=0,
                     reject_samples=True,
                     log_dir=os.path.join(RUNS_DIR, "preact19_chains"))
    expected = chain_expected_launches("VerletSGLDReject", SHORT_N // 128, 2,
                                       1)
    with data_root(os.path.join(root, "short")):
        reset_counts(fu)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = train_bnn.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        data = get_data("cifar10")
    check_chain_summary("preact (c)", summary, K, True)
    others = other_launches(fu, "chain_launches")
    check(fu.chain_launches == expected and others == 0,
          f"preact (c): (K, T) launches {fu.chain_launches} (other kernels "
          f"{others}), the runners' count {expected}")
    out = {"launches": fu.chain_launches, "expected": expected,
           "wall_s": wall, "peak_gib": peak}
    print(f"preact (c) resnet18 K={K} bf16 CLI ok in {wall:.1f} s on {card}: "
          f"(K, T) CUDA launches {fu.chain_launches} == {expected}, no other "
          f"kernel; peak {peak:.2f} GiB; pooled "
          f"{json.dumps(summary['pooled'])}")
    del summary
    gc.collect()
    torch.cuda.empty_cache()
    chains = make_chain_runner(data, get_model("resnet18"), "cuda", K)
    step = chain_step_ms(chains, 20)
    out.update(step_ms=step, chain_steps_per_s=K * 1e3 / step)
    print(f"preact (c) resnet18 K={K} bf16: {step:.3f} ms a step of {K} "
          f"chains, {K * 1e3 / step:.1f} chain-steps/s, batch 128 a chain, "
          f"on {card}")
    out["window"] = w = phase_chain_profile(chains, step, "resnet18 K=8")
    if w is not None:
        print(f"preact (c) the update: {w['update_ms']:.4f} ms of a "
              f"{step:.3f} ms step = {w['update_share']:.2%}; the window's "
              f"own step {w['window_ms']:.3f} ms, busy "
              f"{w['busy_window']:.1%}")
    del chains
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_preact_card_vs_cpu(card, root):
    """(d) card f32 against CPU f64 at the same He-initialised parameters:
    the forward pass (train mode), log prior and potential on 64 test
    points of resnet18,
    datadriven_resnet18 with the mean_covs fits and
    datadrivendoublegammaconv; then resnet18's M-H boundary: the runner at
    T=0 on DE_N points, its ΔE on the card against the CPU's"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    from bnn_priors_tpu_torch.models import default_fits_root
    mean_covs = {"mean_covs_file": os.path.join(default_fits_root(),
                                                "cifar10_mean_covs.pkl.gz")}
    with data_root(os.path.join(root, "short")):
        cifar, mnist = get_data("cifar10"), get_data("mnist")
    for name, kw, data in (
            ("resnet18", {}, cifar),
            ("datadriven_resnet18", dict(weight_prior="fixedcov_normal",
                                         weight_prior_params=mean_covs),
             cifar),
            ("datadrivendoublegammaconv", {}, mnist)):
        x, y = data.norm.train
        card_m = get_model(name, x_train=x, y_train=y, seed=3, **kw)
        # the CLI's He init: a prior draw in f32 can sit exactly on a
        # DoubleGamma's loc (concentration < 1), where its density is +inf
        he_initialize(card_m, torch.Generator().manual_seed(3))
        cpu_m = get_model(name, x_train=x.cpu(), y_train=y.cpu(), seed=3,
                          device="cpu", dtype=torch.float64, **kw)
        with torch.no_grad():
            for k, v in card_m.state_dict().items():
                cpu_m.state_dict()[k].copy_(v.cpu())
            xs, ys = (v[:64] for v in data.norm.test)
            f_c = card_m.net_apply(None, xs, train=True)
            f_r = cpu_m.net_apply(None, xs.double().cpu(), train=True)
            lp = [float(m.log_prior()) for m in (card_m, cpu_m)]
            pot = [float(card_m.potential(card_m.params(), xs, ys, 5000.0)),
                   float(cpu_m.potential(cpu_m.params(), xs.double().cpu(),
                                         ys.cpu(), 5000.0))]
        f_err = float((f_c.double().cpu() - f_r).abs().max())
        scale = float(f_r.abs().max())
        rel = lambda a: abs(a[0] - a[1]) / abs(a[1])
        check(f_err <= 1e-4 * max(scale, 1.0) and rel(lp) <= 1e-4
              and rel(pot) <= 1e-4,
              f"preact (d) {name}: f off by {f_err} (scale {scale}), log "
              f"prior {lp}, potential {pot}")
        print(f"preact (d) {name}: card f32 vs CPU f64 on 64 points: f max "
              f"|d| {f_err:.2e} (max |f| {scale:.2f}), log prior {lp[0]:.6e} "
              f"vs {lp[1]:.6e} (rel {rel(lp):.2e}), potential {pot[0]:.6e} "
              f"vs {pot[1]:.6e} (rel {rel(pot):.2e})")
        del card_m, cpu_m
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        data = get_data("fake_cifar10", n_train=DE_N, n_test=DE_N_TEST,
                        dtype="float64" if dtype == torch.float64
                        else "float32", device=device)
        model = get_model("resnet18", dtype=dtype, device=device)
        he_initialize(model, torch.Generator().manual_seed(3))
        r = make_runner(data, model, device, batch_size=16, temperature=0.0,
                        learning_rate=1e-3)
        kinetic = kinetic_part(r)
        r.run()
        out[device] = (r.kernel.params_of(r.chain), np.asarray(r.potentials),
                       r.boundaries[0]["delta_energy"], kinetic[0])
    (pc, potc, dec, kc), (pr, potr, der, kr) = out["cuda"], out["cpu"]
    err = max(float((pc[k].double().cpu() - pr[k]).abs().max()) for k in pr)
    energy = max(DE_N * float(np.abs(potr).max()), 1.0)
    gap, kgap = abs(dec - der), abs(kc - kr)
    # f32 sums of 11.2M terms on the card: ΔE within 1e-6 of N·U (the
    # rounding scale of the f32 energies), and its kinetic part, a sum of
    # the kernel's partials, within 1e-4 of its own size
    check(err < 1e-3 and np.allclose(potc, potr, rtol=1e-4, atol=1e-4)
          and gap <= 1e-6 * energy and kgap <= 1e-4 * abs(kr),
          f"preact (d) boundary: params {err}, potentials {potc} vs {potr}, "
          f"dE {dec} vs {der}, kinetic part {kc} vs {kr} (N·U {energy})")
    print(f"preact (d) resnet18 M-H boundary (T=0, {DE_N} points, T="
          f"{R18_T}): dE card f32 {dec:.6f} vs CPU f64 {der:.6f}, gap "
          f"{gap:.3e} = {gap / energy:.2e} of N·U {energy:.2f}; kinetic "
          f"part (dE - N·dU) card {kc:.6f} vs CPU {kr:.6f}, gap {kgap:.3e} "
          f"= {kgap / max(abs(kr), 1e-30):.2e} of it; params max |d| "
          f"{err:.2e}")
    return {"delta_energy": (dec, der), "gap": gap, "kinetic": (kc, kr),
            "kinetic_gap": kgap, "params_err": err}


def kinetic_part(runner):
    """a list that receives, at each M-H boundary of `runner`, ΔE's kinetic
    part: the kernel's accumulated partials plus the boundary's point
    energy, ΔE without N·(U - U0), as the device computes it"""
    parts, real = [], runner.kernel.delta_energy

    def delta_energy(state, grads, lr, prev_potential, potential):
        parts.append(float(real(state, grads, lr, 0.0, 0.0)))
        return real(state, grads, lr, prev_potential, potential)
    runner.kernel.delta_energy = delta_energy
    return parts


def phase_preact_short(fu, card, root):
    """(e) one-chain CLI runs of the other new models on 640 / 256 images
    (5 steps an epoch), one cycle of 2 epochs: (T,) launches against the
    schedule's, no other kernel; then ms a minibatch step (events, 20
    steps)"""
    from bnn_priors_tpu_torch.exp_utils import get_data, he_initialize
    from bnn_priors_tpu_torch.experiments import train_bnn
    expected = single_expected(SHORT_N, 128, 2, 1)
    out = {}
    with data_root(os.path.join(root, "short")):
        for tag, data_name, kw in preact_short_runs():
            result, _, launches, wall = mnist_cli(
                fu, "preact19_" + tag.replace("/", "_"), data=data_name,
                inference="VerletSGLDReject", reject_samples=True, **kw)
            check(launches == expected, f"preact (e) {tag}: (T,) launches "
                  f"{launches}, the schedule implies {expected}")
            cfg = dict(train_bnn.DEFAULTS, data=data_name, **kw)
            data = get_data(data_name)
            model = train_bnn.model_of(cfg, "cuda", train=data.norm.train)
            he_initialize(model, torch.Generator().manual_seed(0))
            runner = make_runner(data, model, "cuda")
            ms = phase_step_time(runner, 20)
            T = runner.kernel.packer.total_padded
            out[tag] = {"launches": launches, "expected": expected,
                        "wall_s": wall, "step_ms": ms, "T": T}
            print(f"preact (e) {tag} (T={T}) ok in {wall:.1f} s on {card}: "
                  f"(T,) CUDA launches {launches} == {expected}, no other "
                  f"kernel; {ms:.3f} ms a step (20 steps, f32, batch 128); "
                  f"result {json.dumps(result)}")
            del runner, model, data
    return out


def phase_preact(fu, card):
    """phase 19: (a)-(e); returns the kernels line's entries for the PreAct
    ResNets and the data-driven models"""
    t0 = time.perf_counter()
    kernel = phase_preact_kernel(fu)
    root = write_preact_roots()
    try:
        single = phase_preact_cli(fu, card, root)
        chains = phase_preact_chains(fu, card, root)
        boundary = phase_preact_card_vs_cpu(card, root)
        short = phase_preact_short(fu, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 19 (the PreAct ResNets and the data-driven models) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    window = lambda w: None if w is None else {
        k: w[k] for k in ("update_us", "update_share", "busy", "window_ms",
                          "busy_window", "kernels", "kernel_ms", "host_ops")}
    return {"single": {
                "preact_launches": {"resnet18": single["launches"],
                                    **{k: v["launches"]
                                       for k, v in short.items()}},
                "preact_expected": {"resnet18": single["expected"],
                                    **{k: v["expected"]
                                       for k, v in short.items()}},
                "preact_lengths": {"resnet18": kernel["timing"]},
                "preact_step": {"step_ms": single["step_ms"],
                                **window(single["window"])},
                "preact_max_abs_err": kernel["max_abs_err"],
                "preact_delta_energy_gap": boundary["gap"],
                "preact_kinetic_gap": boundary["kinetic_gap"]},
            "chains": {
                "preact_launches": {"resnet18/K8": chains["launches"]},
                "preact_expected": {"resnet18/K8": chains["expected"]},
                "preact_lengths": {"K8/resnet18": kernel["chains_timing"]},
                "preact_step": {"step_ms": chains["step_ms"],
                                "chain_steps_per_s":
                                    chains["chain_steps_per_s"],
                                "peak_gib": chains["peak_gib"],
                                "window": window(chains["window"])},
                "preact_max_abs_err": kernel["chains_max_abs_err"]}}


# ---- phase 20: the paper's grid-and-evaluate pipeline (sweep, eval trio) --
SWEEP_TEMPS = [0.001, 0.01, 0.03, 0.1, 0.3, 1.0]  # run_experiment.sh's grid
SWEEP_REPS = 5
SWEEP_K = len(SWEEP_TEMPS) * SWEEP_REPS            # 30 chains in one bank
SWEEP_N, SWEEP_N_TEST = 1280, 256      # (b)'s CIFAR-10 files: 10 steps an epoch
CORRUPT_N = 5000                       # (c)'s CIFAR-10-C rows (of 50,000)
SVHN_N, SVHN_N_TEST = 2000, 1000       # (c)'s SVHN files (of 73,257 / 26,032)


def phase_sweep_kernel(fu):
    """(a) the (K, T) kernel at K=30 × ResNet-20's T against its plain
    version with every chain's noise on (θ, m, v atol 1e-5; partials rtol
    1e-4 plus 1e-7 of their summed magnitudes, as phase 19 (a)); its time
    against the byte bound"""
    K, T, total = SWEEP_K, 273408, 272474
    gen = torch.Generator().manual_seed(20)
    sets = coefficient_sets(0.01, SWEEP_N, 0.994, 0.99)
    seeds = chain_seeds(K)
    sigma = torch.linspace(0.05, 1.0, K, device="cuda")
    base = chain_kernel_inputs(K, T, total, gen)
    max_err = 0.0
    for name in ("sgld_mid", "ggmc_initial", "ggmc_mid", "ggmc_final"):
        mom_decay, grad_lr, _, pos_c, alpha = sets[name]
        c4 = (mom_decay, grad_lr, pos_c, alpha)
        ker = [t.clone() for t in base]
        ref = [t.clone() for t in base]
        *_, pk = fu.fused_langevin_update_chains(*ker, seeds, sigma, c4,
                                                 total=total, seed_offset=2)
        *_, pr = fu.fused_langevin_update_chains_reference(
            *ref, seeds, sigma, c4, total=total, seed_offset=2)
        err, rel = compare_to_plain(f"sweep (a) {name}", ker, ref, pk, pr,
                                    total, 1e-5, lambda t: t[:, total:],
                                    partials_allowance(base, ref))
        max_err = max(max_err, err)
        print(f"sweep (a) (K, T) kernel == plain: {name:13s} K={K} T={T} "
              f"per-chain noise_std: max |d| {err:.2e}, partials rel err "
              f"{rel:.2e}")
        del ker, ref
    mom_decay, grad_lr, _, pos_c, alpha = sets["ggmc_mid"]
    c4 = (mom_decay, grad_lr, pos_c, alpha)
    t = update_timing(
        fu, lambda: fu.fused_langevin_update_chains(*base, seeds, sigma, c4,
                                                    total=total),
        lambda: fu.fused_langevin_update_chains_reference(
            *base, seeds, sigma, c4, total=total), T, K)
    t["max_abs_err"] = max_err
    fmt = lambda x, f: "not measured" if x is None else format(x, f)
    print(f"sweep (a) (K, T) K={K} at T={T}: a call {t['ms']:.4f} ms, back to "
          f"back {t['b2b_ms']:.4f} ms, device {fmt(t['device_us'], '.2f')} us "
          f"a launch hot against the byte bound {t['bound_ms'] * 1e3:.2f} us "
          f"(32 B x {K} x {T} = {32 * K * T / 1e6:.1f} MB): "
          f"{fmt(t['share'], '.1%')} (back to back: {t['share_b2b']:.1%}); "
          f"plain {t['plain_ms']:.3f} ms a call")
    del base
    torch.cuda.empty_cache()
    return t


def write_sweep_roots():
    """synthetic files from seed 0 under a directory of the checkout's
    build/: CIFAR-10 batches of 1,280 / 256 images with a CIFAR-10-C
    gaussian_blur file of 5,000 rows (NHWC) under CIFAR/, SVHN .mat files
    of 2,000 / 1,000 under SVHN/"""
    import tempfile

    from bnn_priors_tpu_torch.data import (write_cifar10_batches,
                                           write_cifar10_c, write_svhn)
    build = os.path.dirname(RUNS_DIR)
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="sweep_files_", dir=build)
    rng = np.random.RandomState(0)
    n = SWEEP_N + SWEEP_N_TEST
    y = rng.randint(0, 10, n)
    x = rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    for c in range(10):
        x[y == c, :, 2 + c, :] = 255
    cifar = os.path.join(root, "CIFAR")
    write_cifar10_batches(cifar, x[:SWEEP_N], y[:SWEEP_N], x[SWEEP_N:],
                          y[SWEEP_N:])
    idx = rng.randint(0, SWEEP_N_TEST, CORRUPT_N)
    blur = (x[SWEEP_N:][idx].astype(np.float32) * 0.6 + 50).astype(np.uint8)
    write_cifar10_c(cifar, "gaussian_blur", blur.transpose(0, 2, 3, 1),
                    y[SWEEP_N:][idx])
    ys = rng.randint(0, 10, SVHN_N + SVHN_N_TEST)
    xs = rng.randint(0, 200, (SVHN_N + SVHN_N_TEST, 3, 32, 32))
    write_svhn(os.path.join(root, "SVHN"), xs[:SVHN_N], ys[:SVHN_N],
               xs[SVHN_N:], ys[SVHN_N:])
    return root


def phase_sweep_cli(fu, card):
    """(b) sweep_tempering with the paper's 6 × 5 grid (K=30 bf16
    VerletSGLDReject) on the 1,280 / 256 files, 3 epochs of 10 steps:
    (K, T) launches against the runners' count and no other kernel, 30 run
    dirs COMPLETED with each chain's grid position; peak memory and wall
    time"""
    from bnn_priors_tpu_torch.experiments import sweep_tempering
    cfg = cli_config(sweep_tempering, data="cifar10", model="googleresnet",
                     weight_prior="gaussian", inference="VerletSGLDReject",
                     compute_dtype="bfloat16", temperatures=SWEEP_TEMPS,
                     replicates=SWEEP_REPS, cycles=1, warmup=1, burnin=0,
                     n_samples=2, skip=1,
                     log_dir=os.path.join(RUNS_DIR, "sweep20"))
    n_full = SWEEP_N // cfg["batch_size"]
    expected = chain_expected_launches("VerletSGLDReject", n_full, 3, 2)
    print(f"sweep (b): sweep_tempering data=cifar10 model=googleresnet "
          f"inference=VerletSGLDReject compute_dtype=bfloat16 temperatures="
          f"{SWEEP_TEMPS} replicates={SWEEP_REPS} cycles=1 warmup=1 "
          f"n_samples=2 skip=1 on {SWEEP_N:,} / {SWEEP_N_TEST} images (cut "
          "from 50,000 / 10,000 for time)")
    reset_counts(fu)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = sweep_tempering.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, others = fu.chain_launches, other_launches(fu, "chain_launches")
    dirs = sorted((d for d in os.listdir(cfg["log_dir"])
                   if os.path.isdir(os.path.join(cfg["log_dir"], d))), key=int)
    check(len(dirs) == len(results) == SWEEP_K,
          f"sweep (b): {len(dirs)} run dirs, {len(results)} results")
    for c, d in enumerate(dirs):
        d = os.path.join(cfg["log_dir"], d)
        with open(os.path.join(d, "config.json")) as f:
            ccfg = json.load(f)
        with open(os.path.join(d, "run.json")) as f:
            run = json.load(f)
        r, t = divmod(c, len(SWEEP_TEMPS))
        res = run["result"]
        check(run["status"] == "COMPLETED" and ccfg["chain_index"] == c
              and ccfg["replicate"] == r == res["replicate"]
              and ccfg["temperature"] == SWEEP_TEMPS[t] == res["temperature"]
              and 0.0 <= res["acceptance"] <= 1.0
              and all(math.isfinite(v) for v in res.values()),
              f"sweep (b) chain {c}: {ccfg.get('temperature')} "
              f"{ccfg.get('replicate')} {run}")
    check(launches == expected and others == 0,
          f"sweep (b): (K, T) launches {launches} (other kernels {others}), "
          f"the runners' count {expected}")
    acc = [r["acceptance"] for r in results]
    print(f"sweep (b) ok in {wall:.1f} s on {card}: {SWEEP_K} run dirs "
          f"COMPLETED, chain c = r x 6 + t in every config; (K, T) CUDA "
          f"launches {launches} == {expected} = 1 + {n_full} x 3 + 2 x 2, no "
          f"other kernel; peak {peak:.2f} GiB; acceptance {acc}; lp_ensemble "
          f"{[round(r['lp_ensemble'], 4) for r in results]}")
    return {"launches": launches, "expected": expected, "wall_s": wall,
            "peak_gib": peak, "log_dir": cfg["log_dir"], "dirs": dirs,
            "results": results}


def phase_sweep_steps(card):
    """(b) the K=30 bf16 minibatch step beside K=8 in turns (30, 8, 8, 30;
    CUDA events over 20 steps), chain-steps/s, and a profiler window at
    K=30"""
    import gc

    from bnn_priors_tpu_torch.exp_utils import get_data, get_model
    data = get_data("cifar10")
    model = get_model("googleresnet", weight_prior="gaussian",
                      weight_scale=2 ** 0.5)
    runners = {K: make_chain_runner(data, model, "cuda", K,
                                    temperatures=(SWEEP_TEMPS * K)[:K])
               for K in (SWEEP_K, K_CHAINS)}
    ms = {K: [] for K in runners}
    for K in (SWEEP_K, K_CHAINS, K_CHAINS, SWEEP_K):
        ms[K].append(chain_step_ms(runners[K], 20))
    out = {"step_ms": ms[SWEEP_K], "k8_step_ms": ms[K_CHAINS]}
    for K in runners:
        m = float(np.mean(ms[K]))
        out[f"chain_steps_per_s_k{K}"] = K * 1e3 / m
        print(f"sweep (b) K={K} bf16: {', '.join(f'{v:.3f}' for v in ms[K])} "
              f"ms a step (20 steps each, in turns), {K * 1e3 / m:.1f} "
              f"chain-steps/s, batch 128 a chain, on {card}")
    w = phase_chain_profile(runners[SWEEP_K], float(np.mean(ms[SWEEP_K])),
                            "sweep K=30")
    out["window"] = None if w is None else {
        k: w[k] for k in ("busy", "busy_window", "window_ms", "kernels",
                          "kernel_ms", "host_ops", "update_us",
                          "update_share")}
    if w is not None:
        print(f"sweep (b) K=30 window: busy {w['busy']:.1%} of the step "
              f"({w['busy_window']:.1%} of the window's own "
              f"{w['window_ms']:.3f} ms); the update "
              f"{w['update_us'] or float('nan'):.2f} us a launch in the "
              f"step, {w['update_share']:.2%} of it")
    del runners
    gc.collect()
    torch.cuda.empty_cache()
    return out


EVAL_CALLS = (("plain", {}),
              ("cifar10c", dict(eval_data="cifar10c-gaussian_blur",
                                calibration_eval=True)),
              ("svhn", dict(eval_data="svhn", ood_eval=True)))
# the scores each call must return, in [0, 1]
EVAL_SCORES = {"plain": (), "cifar10c": ("ece", "ace", "rmsce"),
               "svhn": ("auroc", "auprc")}


def phase_sweep_evals(sweep, card):
    """(c) run_evaluation.sh's three eval_bnn calls on two chain dirs of the
    sweep (replicate 0 at T=0.001 and at T=1.0), marglik_eval with the
    SVHN call on the first; the scores in range"""
    from bnn_priors_tpu_torch.experiments import eval_bnn
    out = {}
    for c in (0, len(SWEEP_TEMPS) - 1):
        run_dir = os.path.join(sweep["log_dir"], sweep["dirs"][c])
        for name, kw in EVAL_CALLS:
            kw = dict(kw, marglik_eval=(c == 0 and name == "svhn"))
            cfg = cli_config(eval_bnn, run_dir=run_dir, skip_first=0,
                             log_dir=os.path.join(RUNS_DIR, "eval20"), **kw)
            t0 = time.perf_counter()
            res = eval_bnn.main(cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            for k in EVAL_SCORES[name]:
                check(k in res and 0.0 <= res[k] <= 1.0,
                      f"sweep (c) chain {c} {name}: {k} {res.get(k)}")
            check(all(math.isfinite(v) for k, v in res.items()
                      if k != "simple_marglik"),
                  f"sweep (c) chain {c} {name}: {res}")
            out[f"{c}/{name}"] = {"s": secs, **res}
            print(f"sweep (c) chain {c} (T={SWEEP_TEMPS[c % 6]}) eval_bnn "
                  f"{name} ok in {secs:.2f} s on {card}: {json.dumps(res)}")
    return out


def phase_sweep_card_vs_cpu(sweep, evals):
    """(d) on chain 0's dir: the card's f32 evals against the port's CPU
    f64 run of the same functions on the same bank and files: each point's
    max-probability score (CIFAR-10 test and SVHN test) within 1e-5, AUROC
    and AUPRC within 1e-3, every sample's log prior within 1e-6 relative;
    and the card's function values equal the CLI's results"""
    from bnn_priors_tpu_torch import io
    from bnn_priors_tpu_torch.evaluate import (average_precision_score,
                                               evaluate_marglik, ood_scores,
                                               reject_samples_, roc_auc_score)
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model
    run_dir = os.path.join(sweep["log_dir"], sweep["dirs"][0])
    # the bank as eval_bnn reads it: each rejected sample its predecessor
    bank = io.load_samples(os.path.join(run_dir, "samples.pt"),
                           keep_steps=True)
    bank = reject_samples_(bank, io.load_metrics(
        os.path.join(run_dir, "metrics.h5"),
        ("steps", "acceptance/is_sample", "acceptance/rejected")))
    out = {}
    for tag, device, dtype in (("card", "cuda", torch.float32),
                               ("cpu", "cpu", torch.float64)):
        np_dtype = "float32" if dtype == torch.float32 else "float64"
        cifar = get_data("cifar10", dtype=np_dtype, device=device)
        svhn = get_data("svhn", dtype=np_dtype, device=device)
        model = get_model("googleresnet", weight_prior="gaussian",
                          weight_scale=1.41, dtype=dtype, device=device)
        ind = ood_scores(model, cifar.norm.test_X, bank)
        ood = ood_scores(model, svhn.norm.test_X, bank)
        labels = np.r_[np.ones_like(ind), np.zeros_like(ood)]
        joint = np.r_[ind, ood]
        n = min(len(v) for v in bank.values())
        lps = [evaluate_marglik(model, one, one)["mean_loglik"] for one in
               ({k: v[i:i + 1] for k, v in bank.items()} for i in range(n))]
        out[tag] = {"scores": joint, "auroc": roc_auc_score(labels, joint),
                       "auprc": average_precision_score(labels, joint),
                       "log_priors": np.asarray(lps),
                       "marglik": evaluate_marglik(model, bank, bank)}
        del cifar, svhn, model
    card, cpu = out["card"], out["cpu"]
    s_err = float(np.abs(card["scores"] - cpu["scores"]).max())
    a_err = max(abs(card[k] - cpu[k]) for k in ("auroc", "auprc"))
    lp_rel = float(np.max(np.abs(card["log_priors"] - cpu["log_priors"])
                          / np.abs(cpu["log_priors"])))
    cli = evals["0/svhn"]
    check(s_err <= 1e-5, f"sweep (d): scores off by {s_err}")
    check(a_err <= 1e-3, f"sweep (d): AUROC/AUPRC card {card['auroc']}, "
          f"{card['auprc']} vs CPU {cpu['auroc']}, {cpu['auprc']}")
    check(lp_rel <= 1e-6, f"sweep (d): log priors {card['log_priors']} vs "
          f"{cpu['log_priors']}")
    check(all(abs(cli[k] - card[k]) <= 1e-5 for k in ("auroc", "auprc"))
          and math.isclose(cli["mean_loglik"], card["marglik"]["mean_loglik"],
                           rel_tol=1e-7), f"sweep (d): the CLI's {cli} "
          f"against the functions' {card['auroc']}, {card['auprc']}, "
          f"{card['marglik']}")
    print(f"sweep (d) card f32 vs CPU f64 on chain 0 ({len(card['scores'])} "
          f"points, {len(card['log_priors'])} samples): scores max |d| "
          f"{s_err:.2e}; AUROC {card['auroc']:.6f} vs {cpu['auroc']:.6f}, "
          f"AUPRC {card['auprc']:.6f} vs {cpu['auprc']:.6f}; log priors "
          f"{card['log_priors']} vs {cpu['log_priors']} (max rel "
          f"{lp_rel:.2e}); marglik card {json.dumps(card['marglik'])}")
    return {"score_err": s_err, "auc_err": a_err, "log_prior_rel": lp_rel}


def phase_sweep(fu, card):
    """phase 20: (a)-(d); returns the (K, T) record's sweep entries"""
    t0 = time.perf_counter()
    kernel = phase_sweep_kernel(fu)
    root = write_sweep_roots()
    try:
        with data_root(root):
            sweep = phase_sweep_cli(fu, card)
            steps = phase_sweep_steps(card)
            evals = phase_sweep_evals(sweep, card)
            cmp = phase_sweep_card_vs_cpu(sweep, evals)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 20 (the grid-and-evaluate pipeline) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"sweep_launches": sweep["launches"],
            "sweep_expected": sweep["expected"],
            "sweep_kernel": kernel,
            "sweep_step": {"K": SWEEP_K, **steps,
                           "peak_gib": sweep["peak_gib"],
                           "wall_s": sweep["wall_s"]},
            "sweep_card_vs_cpu": cmp,
            "sweep_dirs": {"log_dir": sweep["log_dir"],
                           "dirs": sweep["dirs"],
                           "results": sweep["results"]}}


# ------ phase 21: the remaining models, the synthetic data, train_sgd and
# ------ profile_dir ----------------------------------------------------------
SGD_N, SGD_N_TEST = 5000, 1000  # cut from CIFAR-10's 50,000 / 10,000
SGD_EPOCHS = 3
THIN_T = 701440                 # thin_resnet18's packed length, padded
RAOB_WIDTH = 50
# (d)'s seed. The check is statistical, so its seed is pinned as the CPU
# test's is: over seeds 0-19 the plain f32 version on the CPU (the kernel's
# Philox stream) passed acceptance>0.6 20/20, anderson_normal_p15 17/20 and
# the three p=.3 KS checks 13, 15 and 15/20, the nominal rates; seed 3
# passed all five, its KS p-values 0.74, 0.50 and 0.96
GAUSS_SEED = 3
PROFILE_MAX_STEPS = 50          # the CLI's profile_max_steps


def write_slice12_roots():
    """synthetic files from seed 0 under a directory of the checkout's
    build/: CIFAR-10 python batches of 5,000 / 1,000 images (CIFAR) and
    MNIST IDX files at MNIST's 60,000 / 10,000 (MNIST), class rows as
    phases 18 and 19 write them"""
    import tempfile

    from bnn_priors_tpu_torch.data import write_cifar10_batches, \
        write_idx_files
    build = os.path.dirname(RUNS_DIR)
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="slice12_files_", dir=build)
    rng = np.random.RandomState(0)
    for sub, (n, n_test), shape in (("CIFAR", (SGD_N, SGD_N_TEST),
                                     (3, 32, 32)),
                                    ("MNIST", (MNIST_N, MNIST_N_TEST),
                                     (28, 28))):
        y = rng.randint(0, 10, n + n_test)
        x = rng.randint(0, 256, (n + n_test,) + shape).astype(np.uint8)
        for c in range(10):
            x[y == c, ..., 2 + c, :] = 255
        write = write_cifar10_batches if sub == "CIFAR" else write_idx_files
        write(os.path.join(root, sub), x[:n], y[:n], x[n:], y[n:])
    return root


def phase_sgd(fu, card, root):
    """(a) train_sgd at its own defaults (thin_resnet18, cifar10_augmented,
    batch 128, lr 0.05, momentum 0.9, stairs) on 5,000 / 1,000 images for
    3 epochs: run.json, (T,) launches against the schedule's, an epoch's
    seconds; then ms a step (events) and the kernel at thin_resnet18's T
    against its plain version (noise_std 0) and its byte bound"""
    from bnn_priors_tpu_torch import exp_utils
    from bnn_priors_tpu_torch.experiments import train_sgd
    from bnn_priors_tpu_torch.inference import SGLDRunner
    log_dir = os.path.join(RUNS_DIR, "sgd21")
    steps = -(-SGD_N // 128)
    expected = SGD_EPOCHS * steps + 1  # every step, then the final one
    epoch_s = []
    with data_root(root), timed(SGLDRunner, "_finish_epoch", epoch_s):
        reset_counts(fu)
        t0 = time.perf_counter()
        result = train_sgd.main(["--n_epochs", str(SGD_EPOCHS),
                                 "--epochs_per_sample", "1",
                                 "--skip_first", "1", "--log_dir", log_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fu.launches
        data = exp_utils.get_data("cifar10_augmented")
    with open(os.path.join(log_dir, "run.json")) as f:
        run = json.load(f)
    check(run["status"] == "COMPLETED" and run["result"] == result
          and math.isfinite(result["lp_ensemble"]),
          f"sgd (a): run.json {run}")
    check(launches == expected and other_launches(fu, "launches") == 0,
          f"sgd (a): (T,) launches {launches} (others "
          f"{other_launches(fu, 'launches')}), the schedule implies "
          f"{expected} = {SGD_EPOCHS} x {steps} + 1")
    print(f"sgd (a) train_sgd ok in {wall:.1f} s on {card}: result "
          f"{json.dumps(result)}; (T,) CUDA launches {launches} == "
          f"{expected} = {SGD_EPOCHS} x {steps} + 1 at noise_std 0, no other "
          f"kernel; epochs {', '.join(f'{s:.2f}' for s in epoch_s)} s")
    model = exp_utils.get_model("thin_resnet18", weight_prior="improper",
                                bias_prior="improper")
    exp_utils.he_uniform_initialize(model, torch.Generator().manual_seed(0))
    runner = SGLDRunner(model, data.norm.train, data.norm.test,
                        epochs_per_cycle=SGD_EPOCHS, warmup_epochs=0,
                        sample_epochs=SGD_EPOCHS, learning_rate=0.05,
                        temperature=0.0, momentum=0.9,
                        sampling_decay="stairs",
                        augment_fn=type(data).augment_fn, device="cuda")
    pk = runner.kernel.packer
    check(pk.total_padded == THIN_T, f"thin_resnet18's T {pk.total_padded}")
    step_ms = [phase_step_time(runner, temperature=0.0) for _ in range(2)]
    print(f"sgd (a) thin_resnet18 SGD step: "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} ms (25 steps each, "
          f"batch 128, augmented) on {card}")
    del runner
    gen = torch.Generator().manual_seed(21)
    base = kernel_inputs(THIN_T, pk.total, gen)
    c = with_sigma(coefficient_sets(0.05, SGD_N, 0.9, 0.99)["sgld_mid"], 0.0)
    ker = [t.clone() for t in base]
    ref = [t.clone() for t in base]
    *_, pkp = fu.fused_langevin_update(*ker, 21, c, total=pk.total)
    *_, prp = fu.fused_langevin_update_reference(*ref, 21, c, total=pk.total)
    err, _ = compare_to_plain(f"sgd (a) T={THIN_T}", ker, ref, pkp, prp,
                              pk.total, 1e-6, lambda t: t[pk.total:])
    del ker, ref
    t = update_timing(
        fu, lambda: fu.fused_langevin_update(*base, 7, c, total=pk.total),
        lambda: fu.fused_langevin_update_reference(*base, 7, c,
                                                   total=pk.total), THIN_T)
    fmt = lambda x, f: "not measured" if x is None else format(x, f)
    print(f"sgd (a) (T,) kernel == plain at T={THIN_T} noise_std 0: max |d| "
          f"{err:.2e}; a call {t['ms']:.4f} ms, back to back "
          f"{t['b2b_ms']:.4f} ms, device {fmt(t['device_us'], '.2f')} us a "
          f"launch against the byte bound {t['bound_ms'] * 1e3:.2f} us (32 B "
          f"x {THIN_T}): {fmt(t['share'], '.1%')}; plain {t['plain_ms']:.3f} "
          "ms a call")
    return {"launches": launches, "expected": expected, "wall_s": wall,
            "epoch_s": epoch_s, "step_ms": step_ms, "timing": t,
            "max_abs_err": err, "result": result}


@contextlib.contextmanager
def spied_data():
    "every dataset that exp_utils.get_data_from_config returns, in order"
    from bnn_priors_tpu_torch import exp_utils
    seen, orig = [], exp_utils.get_data_from_config

    def spy(cfg, device="cuda"):
        seen.append(orig(cfg, device=device))
        return seen[-1]
    exp_utils.get_data_from_config = spy
    try:
        yield seen
    finally:
        exp_utils.get_data_from_config = orig


def phase_synthetic(fu, card, root):
    """(b) train_bnn data=synthetic.mnist.gaussian with the CLI's CNN on
    60,000 / 10,000 IDX images, one cycle of 2 epochs; eval_bnn on its run
    dir regenerates the labels bit for bit and reproduces the result"""
    from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
    expected = single_expected(MNIST_N, 128, 2, 1)
    with data_root(root), spied_data() as seen:
        t0 = time.perf_counter()
        result, run_dir, launches, wall = mnist_cli(
            fu, "synthetic21", data="synthetic.mnist.gaussian")
        ev = eval_bnn.main(cli_config(eval_bnn, run_dir=run_dir,
                                      skip_first=0, log_dir=os.path.join(
                                          RUNS_DIR, "synthetic21_eval")))
        eval_s = time.perf_counter() - t0 - wall
    check(launches == expected, f"synthetic (b): (T,) launches {launches}, "
          f"the schedule implies {expected}")
    check(len(seen) == 2, f"synthetic (b): {len(seen)} datasets built")
    same = all(torch.equal(a, b) for a, b in zip(
        (*seen[0].norm.train, *seen[0].norm.test),
        (*seen[1].norm.train, *seen[1].norm.test)))
    check(same, "synthetic (b): eval regenerated other data")
    y = seen[0].norm.y
    counts = torch.bincount(y, minlength=10).tolist()
    rel = max(abs(ev[k] - v) / max(abs(v), 1e-30) for k, v in result.items())
    check(rel <= 1e-5, f"synthetic (b): eval {ev} vs run {result}")
    print(f"synthetic (b) ok in {wall:.1f} s on {card}: "
          f"{train_bnn.DEFAULTS['model']} on synthetic.mnist.gaussian "
          f"({MNIST_N:,} / {MNIST_N_TEST:,}; labels a class {counts}), "
          f"result {json.dumps(result)}, (T,) CUDA launches {launches} == "
          f"{expected}; eval_bnn in {eval_s:.1f} s regenerated the data bit "
          f"for bit, result within {rel:.1e}")
    return {"launches": launches, "expected": expected, "wall_s": wall,
            "eval_rel": rel, "result": result}


def phase_raob(card):
    """(c) raobdensenet of width 50 on UCI_protein's split 0 (41,157
    training rows), card f32 net and f64 Woodbury, against the same
    parameters on the CPU in f64: the marginal log-likelihood and its
    gradient, posterior_w and predictive on the test split; then the time
    of one likelihood-and-gradient call"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model
    out = {}
    params = None
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        data = get_data("UCI_protein", device=device)
        x, y = (t.to(dtype) for t in data.norm.train)
        xt = data.norm.test[0].to(dtype)
        model = get_model("raobdensenet", x_train=x, y_train=y,
                          width=RAOB_WIDTH, device=device, dtype=dtype,
                          seed=21)
        if params is not None:  # the card's f32 values, exactly
            with torch.no_grad():
                for k, v in model.params().items():
                    v.copy_(params[k])
        p = model.params()
        ll, f = model.log_likelihood(p, x[:128], y[:128], x.shape[0])
        grads = torch.autograd.grad(ll, list(p.values()))
        with torch.no_grad():
            mean, root_cov = model.posterior_w()
            pm, ps = model.predictive(None, xt)
        out[device] = {"ll": float(ll.detach()), "grads": {
            k: g.double().cpu() for k, g in zip(p, grads)},
            "mean": mean.double().cpu(), "cov_root": root_cov.double().cpu(),
            "pm": pm.double().cpu(), "ps": ps.double().cpu()}
        if device == "cuda":
            params = {k: v.detach().cpu() for k, v in p.items()}
            check(tuple(f.shape) == (x.shape[0], RAOB_WIDTH)
                  and x.shape[0] == 41157, f"raob (c): features {f.shape}")

            def call():
                q = model.params()
                ll, _ = model.log_likelihood(q, x[:128], y[:128], 0)
                return torch.autograd.grad(ll, list(q.values()))
            out["ms"] = time_ms(call, 20)
    c, r = out["cuda"], out["cpu"]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    errs = {"ll": abs(c["ll"] - r["ll"]) / abs(r["ll"]),
            "grad": max(rel(c["grads"][k], r["grads"][k]) for k in r["grads"]),
            "posterior_mean": rel(c["mean"], r["mean"]),
            "posterior_root": rel(c["cov_root"], r["cov_root"]),
            "predictive_mean": rel(c["pm"], r["pm"]),
            "predictive_std": rel(c["ps"], r["ps"])}
    check("noise_std.p" in c["grads"], "raob (c): no noise_std gradient")
    for k, e in errs.items():
        check(e <= 1e-3, f"raob (c): {k} card f32 vs CPU f64 {e}")
    print(f"raob (c) raobdensenet width {RAOB_WIDTH} on UCI_protein (41,157 "
          f"rows): log-likelihood {c['ll']:.6f} (CPU f64 {r['ll']:.6f}); card "
          f"f32 vs CPU f64 max relative error {json.dumps(errs)} (tolerance "
          f"1e-3); one likelihood-and-gradient call {out['ms']:.3f} ms on "
          f"{card}")
    return {"errs": errs, "ms": out["ms"]}


def gaussian_preservation(fu, seed=GAUSS_SEED, n_vars=50, n_dim=1000,
                          n_samples=200, mh_freq=4):
    """tests/test_torch_verlet_sgld.py::test_distribution_preservation on
    the card: GaussianModel(50, 1000, N(1, 2²)) at temperature 3/4, M-H
    every 4 steps, every update a launch of the (T,) kernel with its own
    Philox noise; returns the checks, their p-values and the launches
    against the transitions made"""
    import scipy.stats

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from _stat_utils import anderson_normal_p15
    from bnn_priors_tpu_torch.mcmc import VerletSGLD
    from bnn_priors_tpu_torch.models import GaussianModel
    mean, std, temperature, lr = 1.0, 2.0, 3 / 4, 1 / 32
    model = GaussianModel(N=n_vars, D=n_dim, mean=mean, std=std)
    gen = torch.Generator().manual_seed(seed)
    params = {f"{i}.p": ((mean + std * torch.randn(
        n_dim, generator=gen, dtype=torch.float64) - mean)
        * temperature ** 0.5 + mean).float().cuda() for i in range(n_vars)}
    kernel = VerletSGLD(num_data=1, momentum=0.9)
    state = kernel.init(params, seed=seed, save_state=True)
    precs = torch.rand(n_vars, generator=gen, dtype=torch.float64)
    state.precond = kernel.packer.expand(kernel.packer.pack_leaf_scalars(
        {f"{i}.p": (float(precs[i]) + 0.2) / math.sqrt(4)
         for i in range(n_vars)}).to(state.position))
    reset_counts(fu)
    state = kernel.sample_momentum(state, temperature)

    def grad_of(state):
        "the potential in float64 (the M-H test reads it), its f32 gradient"
        theta = state.position.detach().requires_grad_()
        pot = -model.log_prior({k: v.double() for k, v in
                                kernel.unpack(theta).items()})
        g, = torch.autograd.grad(pot, theta)
        return float(pot.detach()), g

    transitions, acc, n_acc, prev, metrics = 0, 0.0, 0, None, None
    for step in range(n_samples + 1):
        loss, grads = grad_of(state)
        if step % mh_freq == 0:
            if step != 0:
                state, metrics = kernel.final_step(state, grads, lr,
                                                   temperature)
                transitions += 1
                de = float(kernel.delta_energy(state, grads, lr, prev, loss))
                state, _, _ = kernel.maybe_reject(state, de, temperature)
                n_acc += 1
                acc += min(1.0, math.exp(-de))
                if step == n_samples:
                    break
                loss, grads = grad_of(state)
            prev = loss
            state, _ = kernel.initial_step(state, grads, lr, temperature,
                                           save_state=True)
        else:
            state, _ = kernel.step(state, grads, lr, temperature)
        transitions += 1
    torch.cuda.synchronize()
    out = kernel.params_of(state)
    x = torch.cat([v.reshape(-1) for v in out.values()]).double().cpu()
    x = x.numpy()
    kin = np.asarray([float(metrics["est_temperature"][k]) for k in out])
    conf = np.asarray([float(metrics["est_config_temp"][k]) for k in out])
    chi2 = lambda v: scipy.stats.chi2.cdf(v, df=n_dim, loc=0.0,
                                          scale=temperature / n_dim)
    p = {"ks_normal": scipy.stats.ks_1samp(
        x, lambda v: scipy.stats.norm.cdf(v, loc=mean, scale=std
                                          * temperature ** 0.5),
        mode="asymp").pvalue,
        "ks_config_temp": scipy.stats.ks_1samp(conf, chi2,
                                               mode="exact").pvalue,
        "ks_kinetic_temp": scipy.stats.ks_1samp(kin, chi2,
                                                mode="exact").pvalue}
    checks = {"acceptance>0.6": acc / n_acc > 0.6,
              "anderson_normal_p15": anderson_normal_p15(x),
              **{f"{k}_p30": bool(v >= 0.3) for k, v in p.items()}}
    return checks, p, acc / n_acc, fu.launches, transitions


def phase_gaussian(fu, card):
    """(d) the distribution-preservation check on GaussianModel through the
    (T,) kernel and its Philox noise, then train_bnn data=random
    model=test_gaussian inference=VerletSGLDReject with its launches"""
    checks, p, acc, launches, transitions = gaussian_preservation(fu)
    check(all(checks.values()), f"gaussian (d): checks {checks}, p {p}")
    check(launches == transitions and other_launches(fu, "launches") == 0,
          f"gaussian (d): (T,) launches {launches} for {transitions} "
          "transitions")
    print(f"gaussian (d) distribution preserved on the card (seed "
          f"{GAUSS_SEED}, 50 x 1000 f32, temperature 3/4): {checks}; "
          f"p-values {json.dumps(p)}, acceptance {acc:.3f}; (T,) CUDA "
          f"launches {launches} == {transitions} transitions")
    expected = single_expected(1000, 128, 2, 1)
    result, _, cli_launches, wall = mnist_cli(
        fu, "gaussian21", data="random", model="test_gaussian",
        inference="VerletSGLDReject")
    check(cli_launches == expected and result["lp_ensemble"] == 0.0,
          f"gaussian (d): CLI launches {cli_launches} (schedule {expected}),"
          f" result {result}")
    print(f"gaussian (d) train_bnn model=test_gaussian ok in {wall:.1f} s: "
          f"result {json.dumps(result)}, (T,) CUDA launches {cli_launches} "
          f"== {expected}")
    return {"launches": launches, "expected": transitions,
            "cli_launches": cli_launches, "cli_expected": expected,
            "p": p, "acceptance": acc}


def phase_profile_dir(fu, card):
    """(e) train_bnn profile_dir=<dir> on a short single-chain run (densenet
    width 50 on data=random, batch 16: 62 full batches an epoch, so epoch
    1's window is the CLI's 50 steps): the trace's CUDA kernel events, and
    the run's samples and result bit for bit an unprofiled run's"""
    from bnn_priors_tpu_torch import io
    trace_dir = os.path.join(RUNS_DIR, "profile21_trace")
    kw = dict(data="random", model="densenet", batch_size=16,
              inference="VerletSGLDReject", matmul_precision="float32")
    expected = single_expected(1000, 16, 2, 1)
    runs = {}
    for tag, extra in (("profiled", {"profile_dir": trace_dir}),
                       ("plain", {})):
        runs[tag] = mnist_cli(fu, f"profile21_{tag}", **kw, **extra)
        check(runs[tag][2] == expected, f"profile (e) {tag}: launches "
              f"{runs[tag][2]}, the schedule implies {expected}")
    path = os.path.join(trace_dir, "trace_epoch1.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [e for e in kernels if "fused_langevin_update" in e["name"]]
    check(0 < len(ours) <= PROFILE_MAX_STEPS < len(kernels),
          f"profile (e): {len(ours)} update kernels of {len(kernels)} kernel "
          "events in the trace")
    banks = [io.load_samples(os.path.join(runs[t][1], "samples.pt"))
             for t in ("profiled", "plain")]
    same = (runs["profiled"][0] == runs["plain"][0]
            and set(banks[0]) == set(banks[1])
            and all(np.array_equal(banks[0][k], banks[1][k])
                    for k in banks[0]))
    check(same, "profile (e): the profiled run differs from the plain one")
    print(f"profile (e) ok: {os.path.getsize(path) / 2 ** 20:.1f} MiB trace "
          f"with {len(kernels)} CUDA kernel events, {len(ours)} of them "
          f"fused_langevin_update (window {PROFILE_MAX_STEPS} steps); the "
          f"profiled run in {runs['profiled'][3]:.1f} s, the plain one in "
          f"{runs['plain'][3]:.1f} s, samples and result bit for bit equal; "
          f"(T,) CUDA launches {expected} each on {card}")
    return {"launches": runs["plain"][2], "expected": expected,
            "trace_updates": len(ours), "trace_kernels": len(kernels)}


def phase_slice12(fu, card):
    "phase 21: (a)-(e); returns the (T,) record's entries"
    t0 = time.perf_counter()
    root = write_slice12_roots()
    try:
        sgd = phase_sgd(fu, card, root)
        synthetic = phase_synthetic(fu, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    raob = phase_raob(card)
    gauss = phase_gaussian(fu, card)
    prof = phase_profile_dir(fu, card)
    print(f"phase 21 (the remaining models, synthetic data, train_sgd, "
          f"profile_dir) ok in {time.perf_counter() - t0:.1f} s")
    return {"sgd_launches": sgd["launches"],
            "sgd_expected": sgd["expected"],
            "sgd_kernel": {**sgd["timing"], "max_abs_err":
                           sgd["max_abs_err"]},
            "sgd_step_ms": sgd["step_ms"], "sgd_epoch_s": sgd["epoch_s"],
            "synthetic_launches": synthetic["launches"],
            "synthetic_expected": synthetic["expected"],
            "raob_card_vs_cpu": raob["errs"], "raob_ms": raob["ms"],
            "gaussian_launches": gauss["launches"],
            "gaussian_expected": gauss["expected"],
            "test_gaussian_launches": gauss["cli_launches"],
            "test_gaussian_expected": gauss["cli_expected"],
            "profile_launches": prof["launches"],
            "profile_expected": prof["expected"],
            "profile_trace_updates": prof["trace_updates"]}


# ------ phase 22: the chain axis across processes and devices, and the
# ------ pipelined epoch ---------------------------------------------------
RANKS_TAG = "ranks:"     # a rank's result line
RANKS_TIMEOUT = 420      # s, each rank of phase 22
MESH_N = 2560            # phase 22's training points (cut from 5,000)
MESH_TOL = 1e-2  # (b): a chain's samples, ‖rank run - one process‖ relative
MESH_CM_TOL = 1e-4       # (c): relative, split step against the whole batch
WINDOW_STEPS = 10        # (a): the profiler window around epoch 0's end


@contextlib.contextmanager
def captured_runs(R=None):
    """`R.run` (`MultiChainRunnerReject`'s by default) wrapped: each run's
    (runner, history) appended to the yielded list"""
    if R is None:
        from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject as R
    out, orig, own = [], R.run, "run" in vars(R)

    def run(self, *args, **kwargs):
        hist = orig(self, *args, **kwargs)
        out.append((self, hist))
        return hist
    R.run = run
    try:
        yield out
    finally:
        if own:
            R.run = orig
        else:
            del R.run  # the inherited one again


@contextlib.contextmanager
def boundary_window(out, first, n=WINDOW_STEPS):
    """minibatch steps first .. first+n-1 of a chain run (counted over its
    epochs) in a CUDA-only profiler window between two synchronisations:
    `out` gets the kernels' ms and the window's ms. Around an epoch's end
    the window holds that epoch's drain where it runs inline"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bnn_priors_tpu_torch.parallel import MultiChainRunner as R
    orig, calls = R._chain_step, [0]

    def step(self, *args, **kwargs):
        i = calls[0]
        calls[0] += 1
        if i == first:
            torch.cuda.synchronize()
            out["prof"] = profile(activities=[ProfilerActivity.CUDA])
            out["prof"].__enter__()
            out["t0"] = time.perf_counter()
        result = orig(self, *args, **kwargs)
        if i == first + n - 1:
            torch.cuda.synchronize()
            out["window_ms"] = 1e3 * (time.perf_counter() - out["t0"])
            out["prof"].__exit__(None, None, None)
            out["kernel_ms"] = sum(
                k.self_device_time_total for k in out.pop("prof")
                .key_averages() if k.device_type == DeviceType.CUDA) / 1e3
        return result
    R._chain_step = step
    try:
        yield out
    finally:
        if "prof" in out:
            out.pop("prof").__exit__(None, None, None)
        R._chain_step = orig


def mesh_cli(fu, tag, n_train=MESH_N, **kw):
    """train_bnn n_chains=8 compute_dtype=bfloat16 VerletSGLDReject
    reject_samples=True temperature=1 on fake_cifar10 cut to n_train /
    N_TEST (phase 10's run) with `kw`: (summary, runner, history, (K, T)
    launches, other launches, wall s)"""
    from bnn_priors_tpu_torch import exp_utils
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.experiments import train_bnn
    cfg = cli_config(train_bnn, data="fake_cifar10", model="googleresnet",
                     inference="VerletSGLDReject", reject_samples=True,
                     n_chains=K_CHAINS, compute_dtype="bfloat16",
                     temperature=1.0, cycles=1, warmup=1, burnin=0,
                     n_samples=1, skip_first=0,
                     log_dir=os.path.join(RUNS_DIR, f"mesh22_{tag}"))
    cfg.update(kw)
    real = exp_utils.get_data_seeded
    exp_utils.get_data_seeded = lambda name, seed, device="cuda": FakeCIFAR10(
        n_train=n_train, n_test=N_TEST, seed=int(seed), device=device)
    try:
        reset_counts(fu)
        t0 = time.perf_counter()
        with captured_runs() as runs:
            summary = train_bnn.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        exp_utils.get_data_seeded = real
    runner, hist = runs[-1]
    return (summary, runner, hist, fu.chain_launches,
            other_launches(fu, "chain_launches"), wall)


def chain_banks(chain_dirs):
    "{chain index: its sample bank} of a chain CLI's run dirs"
    from bnn_priors_tpu_torch import io
    out = {}
    for d in chain_dirs:
        with open(os.path.join(d, "config.json")) as f:
            c = json.load(f)["chain_index"]
        out[c] = io.load_samples(os.path.join(d, "samples.pt"))
    return out


def bank_gap(a, b):
    """two {chain: bank}s over a's chains: (max |a - b| over every entry,
    max over the chains of ‖a - b‖ / ‖b‖ over all their entries)"""
    d = lambda c, k: (np.asarray(a[c][k], np.float64)
                      - np.asarray(b[c][k], np.float64))
    top = max(float(np.max(np.abs(d(c, k)))) for c in a for k in a[c])
    rel = max(math.sqrt(sum(float(np.sum(d(c, k) ** 2)) for k in a[c])
                        / sum(float(np.sum(np.asarray(b[c][k], np.float64)
                                           ** 2)) for k in a[c]))
              for c in a)
    return top, rel


def diagnostics(runner):
    "the runner's shared diagnostics, as lists for JSON"
    return {"rejections": np.stack(runner.rejections).astype(int).tolist(),
            "delta_energies": np.stack(runner.delta_energies).tolist(),
            "potentials": np.stack(runner.potentials).tolist()}


def phase_pipeline(fu):
    """(a) phase 10's K=8 CLI with pipeline=True and pipeline=False in turns
    (on, off): equal histories, bit for bit equal sample banks, launches
    against the schedule; epoch_s, wall_s and the device's busy share over
    a window of steps around epoch 0's end"""
    from bnn_priors_tpu_torch import io
    n_full = MESH_N // 128
    expected = chain_expected_launches("VerletSGLDReject", n_full, 2, 1)
    out, runs = {}, {}
    for pipeline in (True, False):
        tag = "on" if pipeline else "off"
        with boundary_window({}, n_full - WINDOW_STEPS // 2) as window:
            summary, runner, hist, launches, others, wall = mesh_cli(
                fu, f"a_{tag}", pipeline=pipeline)
        m = io.load_metrics(os.path.join(summary["chain_dirs"][0],
                                         "metrics.h5"),
                            ["timings/epoch_s", "timings/wall_s"])
        pick = lambda k: [float(v) for v in m.get(k, []) if not np.isnan(v)]
        runs[tag] = (runner, hist, chain_banks(summary["chain_dirs"]))
        out[tag] = {"chain_dirs": summary["chain_dirs"], "launches": launches,
                    "others": others, "expected": expected, "wall_s": wall,
                    "epoch_s": pick("timings/epoch_s"),
                    "epoch_wall_s": pick("timings/wall_s"),
                    "kernel_ms": window.get("kernel_ms"),
                    "window_ms": window.get("window_ms"),
                    **diagnostics(runner)}
    (r_on, h_on, b_on), (r_off, h_off, b_off) = runs["on"], runs["off"]
    out["histories_equal"] = len(h_on) == len(h_off) and all(
        set(a) == set(b) and all(np.array_equal(a[k], b[k], equal_nan=True)
                                 for k in a) for a, b in zip(h_on, h_off))
    out["banks_equal"] = set(b_on) == set(b_off) and all(
        np.array_equal(b_on[c][k], b_off[c][k]) for c in b_on
        for k in b_on[c])
    return out, runs["on"]


def chain_mesh_step(distributed):
    """(c) one GGMC step of 2 ResNet-20 chains (no batchnorm: the data
    ranks' batch statistics would differ from the whole batch's) at T=0 on
    a (1 chain group × 2 data ranks) mesh, both ranks on cuda:0, the
    gradient summed over gloo, against the same step on this rank over the
    whole minibatch of 128: potentials and position changes"""
    from bnn_priors_tpu_torch import mcmc
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.exp_utils import get_model, he_initialize
    from bnn_priors_tpu_torch.parallel import ChainMesh, make_mesh
    K, B = 2, 128
    model = get_model("googleresnet", batchnorm=False, device="cuda")
    data = FakeCIFAR10(n_train=B, n_test=8, seed=0, device="cuda")
    x, y = data.norm.train
    kernel = mcmc.VerletSGLDChains(num_data=50000, momentum=0.9)
    params = [he_initialize(copy.deepcopy(model),
                            torch.Generator().manual_seed(c)).params()
              for c in range(K)]
    state = kernel.init({k: torch.stack([p[k].detach() for p in params])
                         for k in params[0]}, list(range(K)))
    before = state.position.clone()
    out = {}
    me = distributed.rank()
    for tag, mesh in (("split", make_mesh(1, 2, device="cuda")),
                      ("whole", make_mesh(1, 1, positions=[(me, "cuda:0")]))):
        cm = ChainMesh(mesh, kernel, model, eff_num_data=50000)
        step = cm.make_step(lambda i: 1e-3)
        states, _, m = step(cm.place_chains(state), {}, 0,
                            cm.place_batch(x.expand(K, *x.shape)),
                            cm.place_batch(y.expand(K, *y.shape)), 0.0)
        torch.cuda.synchronize()
        out[tag] = ((states[0].position - before).double(),
                    m["potential"][0].double())
    (ds, ps), (dw, pw) = out["split"], out["whole"]
    return {"delta_rel": float((ds - dw).norm() / dw.norm()),
            "potential_rel": float(((ps - pw).abs() / pw.abs()).max()),
            "potential": pw.tolist(), "mean_potential": m["mean_potential"]}


def eval_mesh(runner, banks):
    """(d) evaluate_model over a K=8 run's 8-sample bank with mesh= (two
    positions on the one card) against without"""
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.evaluate import evaluate_model
    from bnn_priors_tpu_torch.parallel.distributed import DeviceMesh
    data = FakeCIFAR10(n_train=128, n_test=N_TEST, seed=0, device="cuda")
    bank = {k: np.concatenate([banks[c][k] for c in sorted(banks)])
            for k in banks[0]}
    mesh = DeviceMesh([(0, "cuda:0")] * 2, ("samples",))
    t0 = time.perf_counter()
    plain = evaluate_model(runner.model, data.norm.test, bank,
                           calibration_eval=True)
    t1 = time.perf_counter()
    split = evaluate_model(runner.model, data.norm.test, bank,
                           calibration_eval=True, mesh=mesh)
    t2 = time.perf_counter()
    return {"equal": split == plain, "plain": plain, "split": split,
            "samples": len(next(iter(bank.values()))),
            "eval_ms": 1e3 * (t1 - t0), "eval_mesh_ms": 1e3 * (t2 - t1)}


def ranks_main(rank, port, out_dir, sweep_root):
    """phase 22 in one of two processes on cuda:0, with cuDNN's and cuBLAS's
    deterministic algorithms (the caller sets `CUBLAS_WORKSPACE_CONFIG`):
    both, one program over gloo, (b) train_bnn n_chains=8 n_devices=2
    num_processes=2 (4 chains a rank; rank 0 keeps its checkpoint after
    epoch 1) and the sweep's K=30 bank (15 a rank), and (c) one ChainMesh
    step over the two data ranks; then, the group closed, rank 0 alone
    resumes its checkpoint in one process (which warms the K=8 shapes up),
    runs (a) and (d). Prints RANKS_TAG and its results as JSON."""
    import warnings

    from bnn_priors_tpu_torch.experiments import sweep_tempering
    from bnn_priors_tpu_torch.ops import fused_update as fu
    from bnn_priors_tpu_torch.parallel import MultiChainRunner, distributed
    rank = int(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    hdf5_or_stand_in()
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    save = MultiChainRunner.save_checkpoint

    def keep(self, path, next_epoch_index, step):  # each epoch's file
        save(self, path, next_epoch_index, step)
        if os.path.exists(path):
            shutil.copy(path, os.path.join(
                ckpt_dir, f"epoch{next_epoch_index}.npz"))
    res = {"rank": rank}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        keys = dict(num_processes=2, process_id=rank,
                    coordinator_address=f"localhost:{port}")
        MultiChainRunner.save_checkpoint = keep
        summary, runner, _, launches, others, wall = mesh_cli(
            fu, "b_train", n_devices=2, checkpoint_every=1,
            log_dir=os.path.join(out_dir, "train"), **keys)
        MultiChainRunner.save_checkpoint = save
        res["train"] = {"chain_dirs": summary["chain_dirs"],
                        "local": runner.local_chains, "launches": launches,
                        "others": others, "wall_s": wall,
                        "banks": [[b.lo, b.hi] for b in runner.banks],
                        **diagnostics(runner)}
        cfg = cli_config(sweep_tempering, data="cifar10",
                         model="googleresnet", weight_prior="gaussian",
                         inference="VerletSGLDReject",
                         compute_dtype="bfloat16", temperatures=SWEEP_TEMPS,
                         replicates=SWEEP_REPS, cycles=1, warmup=1, burnin=0,
                         n_samples=2, skip=1,
                         log_dir=os.path.join(out_dir, "sweep"), **keys)
        reset_counts(fu)
        t0 = time.perf_counter()
        with data_root(sweep_root), captured_runs() as runs:
            results = sweep_tempering.main(cfg)
        torch.cuda.synchronize()
        res["sweep"] = {"results": results, "launches": fu.chain_launches,
                        "others": other_launches(fu, "chain_launches"),
                        "wall_s": time.perf_counter() - t0,
                        "local": runs[-1][0].local_chains,
                        **diagnostics(runs[-1][0])}
        res["chain_mesh"] = chain_mesh_step(distributed)
        torch.distributed.destroy_process_group()
        if rank == 0:
            summary, _, _, launches, others, wall = mesh_cli(
                fu, "b_resumed", resume_from=os.path.join(ckpt_dir,
                                                          "epoch1.npz"))
            res["resumed"] = {"chain_dirs": summary["chain_dirs"],
                              "launches": launches, "others": others,
                              "wall_s": wall}
            res["pipeline"], one = phase_pipeline(fu)
            res["eval"] = eval_mesh(*one[::2])
    res["nondeterministic_ops"] = sorted(
        {str(w.message).split(" does not have")[0] for w in caught
         if "deterministic" in str(w.message)})
    print(RANKS_TAG, json.dumps(res))
    return 0


def run_ranks():
    """phase 22's two `chip_smoke.py ranks` processes on cuda:0 over gloo
    on localhost, with the sweep's files: their JSON results and wall s"""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = os.path.join(RUNS_DIR, "ranks22")
    os.makedirs(os.path.join(out_dir, "checkpoints"), exist_ok=True)
    root = write_sweep_roots()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "ranks", str(r),
             str(port), out_dir, root], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANKS_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = []
    for p, text in zip(procs, outs):
        lines = [ln for ln in text.splitlines() if ln.startswith(RANKS_TAG)]
        check(p.returncode == 0 and lines,
              f"phase 22: a rank failed ({p.returncode}):\n{text[-3000:]}")
        res.append(json.loads(lines[-1][len(RANKS_TAG):]))
    return res, time.perf_counter() - t0


def check_pipeline(a, card):
    "(a)'s checks and lines"
    for tag in ("on", "off"):
        r = a[tag]
        busy = (r["kernel_ms"] / r["window_ms"] if r.get("kernel_ms")
                else None)
        r["busy"] = busy
        check(r["launches"] == r["expected"] and r["others"] == 0,
              f"mesh (a) pipeline {tag}: (K, T) launches {r['launches']} "
              f"(other {r['others']}), the schedule implies {r['expected']}")
        print(f"mesh (a) pipeline={tag == 'on'}: run {r['wall_s']:.1f} s on "
              f"{card}; timings/epoch_s {r['epoch_s']}, timings/wall_s "
              f"{r['epoch_wall_s'] or 'none (no pipeline)'}; the "
              f"{WINDOW_STEPS} steps around epoch 0's end "
              f"{r.get('window_ms') or 0:.1f} ms, device busy "
              f"{'not measured' if busy is None else f'{busy:.1%}'}; (K, T) "
              f"launches {r['launches']} == {r['expected']}")
    check(a["histories_equal"] and a["banks_equal"],
          f"mesh (a): with and without the pipeline, histories equal "
          f"{a['histories_equal']}, sample banks equal {a['banks_equal']}")
    check(a["on"]["epoch_wall_s"] and not a["off"]["epoch_wall_s"],
          "mesh (a): timings/wall_s only with the pipeline")
    check(a["on"]["rejections"] == a["off"]["rejections"]
          and a["on"]["delta_energies"] == a["off"]["delta_energies"],
          "mesh (a): the M-H records differ with and without the pipeline")
    print(f"mesh (a) ok (deterministic algorithms): histories, M-H records "
          f"and {K_CHAINS} sample banks bit for bit equal with and without "
          f"the pipeline")


def phase_mesh_kernel(fu):
    """the (K, T) kernel against its plain version at the sub-banks'
    shapes of (b), ResNet-20's T: K_d = 4 (train_bnn's 8 chains over two
    ranks) and 15 (the sweep's 30), with phase 17 (a)'s inputs and seeds,
    σ_k = sqrt(2(1−a)·T_k) of the sub-bank's temperatures (a tempering grid
    with one chain at T=0; rank 0's 15 of the sweep's grid), θ, m, v
    within 1e-5, partials as phase 20 (a): {"K<d>": max |d|}"""
    from bnn_priors_tpu_torch import mcmc
    T, total = 273408, 272474
    grids = {CHAIN_K: [0.0, 0.01, 0.1, 1.0],
             SWEEP_K // 2: (SWEEP_TEMPS * SWEEP_REPS)[:SWEEP_K // 2]}
    sets = coefficient_sets(0.01, N_TRAIN, 0.994, 0.99)
    out = {}
    for K, temps in grids.items():
        base = chain_kernel_inputs(K, T, total,
                                   torch.Generator().manual_seed(17))
        seeds = chain_seeds(K)
        sigma = mcmc.SGLDChains(num_data=N_TRAIN, momentum=0.994)._noise_std(
            2.0 * (1.0 - 0.994), torch.tensor(temps, device="cuda"))
        check(bool((sigma[1:] > 0).all()), f"K={K}: sigma {sigma}")
        err_max = 0.0
        for name in ("sgld_mid", "ggmc_initial", "ggmc_mid", "ggmc_final"):
            mom_decay, grad_lr, _, pos_c, alpha = sets[name]
            c4 = (mom_decay, grad_lr, pos_c, alpha)
            ker = [t.clone() for t in base]
            ref = [t.clone() for t in base]
            *_, pk = fu.fused_langevin_update_chains(
                *ker, seeds, sigma, c4, total=total, seed_offset=5)
            *_, pr = fu.fused_langevin_update_chains_reference(
                *ref, seeds, sigma, c4, total=total, seed_offset=5)
            err, rel = compare_to_plain(
                f"mesh sub-bank {name} K={K}", ker, ref, pk, pr, total, 1e-5,
                lambda t: t[:, total:], partials_allowance(base, ref))
            err_max = max(err_max, err)
            print(f"mesh sub-bank (K, T) kernel == plain: {name:13s} K={K} "
                  f"T={T}: max |d| {err:.2e}, partials rel err {rel:.2e}")
            del ker, ref
        out[f"K{K}"] = err_max
    torch.cuda.empty_cache()
    return out


def phase_mesh(fu, card, sweep):
    """phase 22: the kernel at the sub-banks' shapes, then (a)-(d) from
    the two ranks' results (`ranks_main`); returns the (K, T) record's
    entries"""
    t_start = time.perf_counter()
    kernel_errs = phase_mesh_kernel(fu)
    (r0, r1), wall = run_ranks()
    a = r0["pipeline"]
    check_pipeline(a, card)
    n_full = MESH_N // 128
    expected = chain_expected_launches("VerletSGLDReject", n_full, 2, 1)
    sweep_expected = chain_expected_launches(
        "VerletSGLDReject", SWEEP_N // 128, 3, 2)
    half, sweep_half = K_CHAINS // 2, SWEEP_K // 2
    for r, rr in enumerate((r0, r1)):
        t, sw = rr["train"], rr["sweep"]
        check(t["local"] == list(range(r * half, (r + 1) * half))
              and t["banks"] == [[r * half, (r + 1) * half]]
              and len(t["chain_dirs"]) == half and t["launches"] == expected
              and t["others"] == 0,
              f"mesh (b) rank {r} train_bnn: chains {t['local']}, banks "
              f"{t['banks']}, {len(t['chain_dirs'])} dirs, (K, T) launches "
              f"{t['launches']} (other {t['others']}), {expected} a rank")
        check(sw["local"] == list(range(r * sweep_half, (r + 1) * sweep_half))
              and len(sw["results"]) == sweep_half
              and sw["launches"] == sweep_expected and sw["others"] == 0,
              f"mesh (b) rank {r} sweep: chains {sw['local']}, "
              f"{len(sw['results'])} results, (K, T) launches "
              f"{sw['launches']} (other {sw['others']}), {sweep_expected} "
              "a rank")
    for part in ("train", "sweep"):
        for k in ("rejections", "delta_energies", "potentials"):
            check(r0[part][k] == r1[part][k],
                  f"mesh (b) {part}: the ranks' {k} differ")
    # each chain against the one-process runs: (a)'s, phase 20's sweep
    one = chain_banks(a["on"]["chain_dirs"])
    train_gap, train_rel = bank_gap(chain_banks(
        r0["train"]["chain_dirs"] + r1["train"]["chain_dirs"]), one)
    de_gap = float(np.max(np.abs(np.asarray(r0["train"]["delta_energies"])
                                 - np.asarray(a["on"]["delta_energies"]))))
    same = r0["train"]["rejections"] == a["on"]["rejections"]
    sweep_dir = os.path.join(RUNS_DIR, "ranks22", "sweep")
    sweep_gap, sweep_rel = bank_gap(
        chain_banks([os.path.join(sweep_dir, d)
                     for d in os.listdir(sweep_dir)]),
        chain_banks([os.path.join(sweep["log_dir"], d)
                     for d in sweep["dirs"]]))
    resumed = r0["resumed"]
    resumed_gap, resumed_rel = bank_gap(chain_banks(resumed["chain_dirs"]),
                                        one)
    print(f"mesh (b) two ranks on {card} ok in {wall:.1f} s (the two "
          f"processes, (a) and (d) included): train_bnn "
          f"{r0['train']['wall_s']:.1f} "
          f"/ {r1['train']['wall_s']:.1f} s, chains 0-3 and 4-7 each in its "
          f"rank's own run dirs, (K, T) launches {r0['train']['launches']} + "
          f"{r1['train']['launches']} == 2 x {expected}; the sweep's K=30 "
          f"bank {r0['sweep']['wall_s']:.1f} / {r1['sweep']['wall_s']:.1f} s,"
          f" 15 + 15 chains, launches {r0['sweep']['launches']} + "
          f"{r1['sweep']['launches']} == 2 x {sweep_expected}; the shared "
          f"diagnostics equal on both ranks; ops without a deterministic "
          f"implementation {r0['nondeterministic_ops']}")
    print(f"mesh (b) against the one-process runs, each chain's samples: "
          f"max |rank run - one process| {train_gap:.3g}, max ‖difference‖ / "
          f"‖one process‖ {train_rel:.3g} (train_bnn, (a)'s run); "
          f"{sweep_gap:.3g}, {sweep_rel:.3g} (the sweep, phase 20's run); "
          f"max |ΔE - one process| {de_gap:.3g}; M-H decisions equal {same}; "
          f"rank 0's checkpoint after epoch 1 resumed in one process in "
          f"{resumed['wall_s']:.1f} s: (K, T) launches {resumed['launches']} "
          f"== {n_full + 2}, against the unbroken run {resumed_gap:.3g}, "
          f"{resumed_rel:.3g} (tolerance {MESH_TOL:g} on the relative gaps)")
    check(max(train_rel, sweep_rel, resumed_rel) <= MESH_TOL and same
          and resumed["launches"] == n_full + 2 and resumed["others"] == 0,
          f"mesh (b): the ranks' chains against the one-process runs "
          f"{train_rel:.3g} / {sweep_rel:.3g}, resumed {resumed_rel:.3g} "
          f"({resumed['launches']} launches)")
    cm = r0["chain_mesh"]
    check(cm["delta_rel"] <= MESH_CM_TOL and cm["potential_rel"] <= MESH_CM_TOL
          and r1["chain_mesh"]["potential"] == cm["potential"],
          f"mesh (c) ChainMesh over two data ranks: {cm}")
    print(f"mesh (c) ChainMesh, 2 ResNet-20 chains, batch 128 split over two "
          f"data ranks (gloo, CUDA tensors): position change against the "
          f"whole batch's {cm['delta_rel']:.3g} relative, potential "
          f"{cm['potential_rel']:.3g} (tolerance {MESH_CM_TOL:g}, f32)")
    ev = r0["eval"]
    check(ev["equal"], f"mesh (d): {ev['split']} against {ev['plain']}")
    print(f"mesh (d) evaluate_model over {ev['samples']} samples x {N_TEST} "
          f"points on {card}: split over 2 mesh positions "
          f"{ev['eval_mesh_ms']:.0f} ms, one device {ev['eval_ms']:.0f} ms, "
          f"results equal: {json.dumps(ev['plain'])}")
    print(f"phase 22 (the chain axis across processes and the pipelined "
          f"epoch) ok in {time.perf_counter() - t_start:.1f} s")
    on, off = a["on"], a["off"]
    return {"pipeline_launches": [on["launches"], off["launches"]],
            "pipeline_epoch_s": {"on": on["epoch_s"], "off": off["epoch_s"]},
            "pipeline_wall_s": on["epoch_wall_s"],
            "pipeline_busy": {"on": on["busy"], "off": off["busy"]},
            "mesh_train_launches": [r0["train"]["launches"],
                                    r1["train"]["launches"]],
            "mesh_train_expected": expected,
            "mesh_sweep_launches": [r0["sweep"]["launches"],
                                    r1["sweep"]["launches"]],
            "mesh_sweep_expected": sweep_expected,
            "mesh_resumed_launches": resumed["launches"],
            "mesh_resumed_expected": n_full + 2,
            "mesh_max_abs_err": kernel_errs,
            "mesh_gaps": {"train": [train_gap, train_rel],
                          "sweep": [sweep_gap, sweep_rel],
                          "resumed": [resumed_gap, resumed_rel],
                          "delta_energy": de_gap},
            "chain_mesh": cm, "eval_ms": ev["eval_ms"],
            "eval_mesh_ms": ev["eval_mesh_ms"]}


# ------ phase 23: the Hessian spectrum of a posterior sample, and the task
# ------ queue ------------------------------------------------------------------
EFF_BATCHES, EFF_BATCH = 2, 128  # (a)'s loss: 2 batches of 128 points
EFF_ITERS = (50, 40)             # (a)'s Lanczos runs: the one checked, and
                                 # the one its top values are held against
EFF_ZS = (1.0, 10.0, 100.0)      # N_eff(z)'s z
EFF_SEED = 23
HVP_TOL = 1e-4                   # (a): card f32 against CPU f64, relative
ROUTE_TOL = 1e-10                # (a): card f64 against CPU f64, relative
SYM_TOL = 1e-4                   # u·(Hv) against v·(Hu), relative
ORTHO_TOL = 1e-4                 # max |QᵀQ - I| over the Ritz basis
RESIDUAL_TOL = 1e-2              # ‖Hq - λq‖ / |λ| of the top Ritz pair
CONVERGED_TOL = 1e-3             # the top 3 Ritz values, 40 against 50
TQ_N, TQ_N_TEST = 1280, 256      # (b)'s fake_cifar10 (cut from 50,000)
TQ_EPOCHS = 2
TQ_GRID = ((0, 0.05), (0, 0.01), (1, 0.05), (1, 0.01))  # (seed, lr)
TQ_TAG = "taskqueue:"            # a worker's result line
TQ_TIMEOUT = 300                 # s, each worker of (b)


def eff_dim_problem(run_dir, device, dtype):
    """phase 9's run's last sample in the CLI's model on `device` in
    `dtype`, and (a)'s loss: the potential at train=False over 2 batches of
    128 fake_cifar10 points (the same f64 points rounded for f32); returns
    (params, loss)"""
    from bnn_priors_tpu_torch import eff_dim, io
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.experiments import train_bnn
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    model = train_bnn.model_of(cfg, device).to(dtype)
    bank = io.load_samples(os.path.join(run_dir, "samples.pt"))
    model.load_state_dict({k: torch.as_tensor(v[-1]) for k, v in
                           bank.items()})
    n = EFF_BATCHES * EFF_BATCH
    x, y = FakeCIFAR10(dtype="float64", n_train=n, n_test=EFF_BATCH,
                       device="cpu").norm.train
    x, y = x.to(device, dtype), y.to(device)
    batches = [(x[i:i + EFF_BATCH], y[i:i + EFF_BATCH])
               for i in range(0, n, EFF_BATCH)]

    def model_loss(params, xb, yb):
        return model.potential(params, xb, yb, n, train=False) / EFF_BATCHES
    params = {k: v.detach() for k, v in model.params().items()}
    return params, eff_dim.dataset_loss(model_loss, batches)


@contextlib.contextmanager
def relu_masks(record=None, replay=None):
    """`torch.nn.functional.relu` (which nn.ReLU calls) for the block:
    appends each call's mask x > 0 (on the CPU) to `record`, or gives x
    times the masks of `replay` in call order; yields the replay count"""
    import torch.nn.functional as F
    relu, calls = F.relu, [0]

    def recording(x, inplace=False):
        record.append((x > 0).cpu())
        return relu(x, inplace=inplace)

    def replaying(x, inplace=False):
        mask = replay[calls[0] % len(replay)]
        calls[0] += 1
        return x * mask.to(x.device, x.dtype)
    F.relu = recording if record is not None else replaying
    try:
        yield calls
    finally:
        F.relu = relu


def packed_hvp(loss, params, v):
    "H·v over the packed vector (`v` packed; the result packed, pad zeroed)"
    from bnn_priors_tpu_torch import eff_dim
    from bnn_priors_tpu_torch.mcmc.packing import Packer
    pk = Packer(params)
    return pk.mask_pad(pk.pack(eff_dim.hess_vec_prod(loss, params,
                                                     pk.unpack(v))))


def direction(pk, gen):
    "a standard normal packed direction on the CPU in f64, its pad zeroed"
    v = torch.randn(pk.total_padded, generator=gen, dtype=torch.float64)
    v[pk.total:] = 0.0
    return v


def timed_spectrum(loss, params, num_iters):
    """`hessian_eigs_positive_lanczos` on the card, its Lanczos recursion
    and every Hessian-vector product in it between CUDA events; returns
    (evals, Ritz vectors, pos, seconds, {ms an HVP, ms a Lanczos iteration,
    of which the rest: reorthogonalisation and the scalar work})"""
    from bnn_priors_tpu_torch import eff_dim
    lanczos, hvps, loops = eff_dim.lanczos_tridiag, [], []

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed(matvec):
        def mv(v):
            a, b = event_pair()
            a.record()
            out = matvec(v)
            b.record()
            hvps.append((a, b))
            return out
        return mv

    def timed_lanczos(matvec, *args, **kw):
        a, b = event_pair()
        a.record()
        out = lanczos(timed(matvec), *args, **kw)
        b.record()
        loops.append((a, b))
        return out
    eff_dim.lanczos_tridiag = timed_lanczos
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evals, vecs, pos = eff_dim.hessian_eigs_positive_lanczos(
            loss, params, generator=torch.Generator(
                device="cuda").manual_seed(EFF_SEED), num_iters=num_iters)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        eff_dim.lanczos_tridiag = lanczos
    m = len(hvps)
    hvp_ms = sum(a.elapsed_time(b) for a, b in hvps) / m
    iter_ms = loops[0][0].elapsed_time(loops[0][1]) / m
    return evals, vecs, pos, seconds, {"hvp_ms": hvp_ms, "iter_ms": iter_ms,
                                       "rest_ms": iter_ms - hvp_ms}


def phase_eff_dim(card, run_dir):
    """(a): phase 9's last sample, full-width ResNet-20: one HVP on the
    card (f32) against the CPU (f64), the symmetry u·(Hv) = v·(Hu), the
    50-iteration Lanczos spectrum (orthonormal Ritz basis, the top pair's
    residual, the top 3 against a 40-iteration run), N_eff(z), and the
    times and peak memory.

    The network is piecewise linear (ReLU), so its Hessian jumps where a
    pre-activation crosses 0, and f32 rounding puts a few of the ~10^8
    pre-activations on the other side of 0 than f64 does. The CPU's f64
    product is therefore taken on the card's piece: every ReLU with the
    mask of the card's f32 pass (`relu_masks`), which is the same product
    the card computed, in f64. The gap the flipped signs make (the card's
    f32 product against its own f64 one) is printed beside the count of
    flipped signs, and the card's f64 product on the card's piece is held
    against the CPU's."""
    from bnn_priors_tpu_torch import eff_dim
    from bnn_priors_tpu_torch.mcmc.packing import Packer
    params, loss = eff_dim_problem(run_dir, "cuda", torch.float32)
    pk = Packer(params)
    gen = torch.Generator().manual_seed(EFF_SEED)
    v64, u64 = (direction(pk, gen) for _ in range(2))
    v, u = v64.to("cuda", torch.float32), u64.to("cuda", torch.float32)
    masks, masks64 = [], []
    with torch.no_grad(), relu_masks(record=masks):
        loss(params)
    hv = packed_hvp(loss, params, v)
    hvp_ms = time_ms(lambda: packed_hvp(loss, params, v), 5)
    t0 = time.perf_counter()
    cpu_params, cpu_loss = eff_dim_problem(run_dir, "cpu", torch.float64)
    with relu_masks(replay=masks) as calls:
        hv64 = packed_hvp(cpu_loss, cpu_params, v64)
    cpu_s = time.perf_counter() - t0
    del cpu_params, cpu_loss
    check(calls[0] == len(masks), f"eff_dim (a): {calls[0]} ReLU calls "
          f"replayed, {len(masks)} recorded")
    gap = lambda a, b: float(torch.linalg.vector_norm(a.cpu().double() - b)
                             / torch.linalg.vector_norm(b))
    hvp_rel = gap(hv, hv64)
    p64, l64 = eff_dim_problem(run_dir, "cuda", torch.float64)
    with torch.no_grad(), relu_masks(record=masks64):
        l64(p64)
    flips = sum(int((a != b).sum()) for a, b in zip(masks, masks64))
    n_relu = sum(a.numel() for a in masks)
    own64 = packed_hvp(l64, p64, v64.cuda()).cpu()
    with relu_masks(replay=masks):
        route_rel = gap(packed_hvp(l64, p64, v64.cuda()), hv64)
    del p64, l64, masks, masks64
    plain_rel = gap(hv, own64)
    hu = packed_hvp(loss, params, u)
    uhv, vhu = float(torch.dot(u, hv)), float(torch.dot(v, hu))
    sym_rel = abs(uhv - vhu) / max(abs(uhv), abs(vhu))
    print(f"eff_dim (a) ResNet-20 (T={pk.total_padded}, {pk.total} "
          f"parameters) at phase 9's last sample, potential at train=False "
          f"over {EFF_BATCHES} x {EFF_BATCH} fake_cifar10 points: one HVP on "
          f"{card} (f32, TF32 off) against the CPU (f64 on the card's ReLU "
          f"masks, {cpu_s:.1f} s): ‖Hv_card - Hv_cpu‖ / ‖Hv_cpu‖ "
          f"{hvp_rel:.3g} (tolerance {HVP_TOL:g}); the card's f64 HVP on "
          f"those masks against the CPU's {route_rel:.3g} (tolerance "
          f"{ROUTE_TOL:g}); ReLU signs f32 against f64 {flips} flipped of "
          f"{n_relu:,}, which put the card's f32 HVP {plain_rel:.3g} from "
          f"its f64 HVP on its own masks; u·(Hv) {uhv:.6g}, v·(Hu) "
          f"{vhu:.6g}, relative {sym_rel:.3g} (tolerance {SYM_TOL:g}); "
          f"{hvp_ms:.3f} ms an HVP (CUDA events, median of 5)")
    check(hvp_rel <= HVP_TOL and route_rel <= ROUTE_TOL
          and sym_rel <= SYM_TOL,
          f"eff_dim (a): HVP card vs CPU {hvp_rel:.3g}, in f64 "
          f"{route_rel:.3g}, symmetry {sym_rel:.3g}")
    torch.cuda.reset_peak_memory_stats()
    evals, vecs, pos, spectrum_s, parts = timed_spectrum(
        loss, params, EFF_ITERS[0])
    peak = torch.cuda.max_memory_allocated()
    m = evals.shape[0]
    gram = vecs.T @ vecs
    ortho = float((gram - torch.eye(m, device="cuda")).abs().max())
    top = int(torch.argmax(evals))
    lam, q = float(evals[top]), vecs[:, top]
    residual = float(torch.linalg.vector_norm(
        packed_hvp(loss, params, q) - lam * q)) / abs(lam)
    short, _, _, short_s, _ = timed_spectrum(loss, params, EFF_ITERS[1])
    top3 = torch.sort(evals).values[-3:].double().cpu()
    top3_short = torch.sort(short).values[-3:].double().cpu()
    converged = float(((top3 - top3_short).abs() / top3.abs()).max())
    n_eff = {z: float(eff_dim.effective_dimension(evals[pos], z))
             for z in EFF_ZS}
    print(f"eff_dim (a) Lanczos, {m} iterations on {card}: max |QᵀQ - I| "
          f"{ortho:.3g} (tolerance {ORTHO_TOL:g}); top Ritz value {lam:.6g}, "
          f"‖Hq - λq‖ / |λ| {residual:.3g} (tolerance {RESIDUAL_TOL:g}); "
          f"top 3 {[round(float(t), 4) for t in top3]} against "
          f"{[round(float(t), 4) for t in top3_short]} from "
          f"{EFF_ITERS[1]} iterations, relative {converged:.3g} (tolerance "
          f"{CONVERGED_TOL:g})")
    print(f"eff_dim (a) on {card}: {int(pos.sum())} of {m} Ritz values "
          f"positive; N_eff(z) " + ", ".join(
              f"{n_eff[z]:.4f} at z={z:g}" for z in EFF_ZS)
          + f"; a Lanczos iteration {parts['iter_ms']:.3f} ms = HVP "
          f"{parts['hvp_ms']:.3f} ms + reorthogonalisation and the rest "
          f"{parts['rest_ms']:.3f} ms (CUDA events); the whole spectrum "
          f"{spectrum_s:.2f} s ({EFF_ITERS[1]} iterations {short_s:.2f} s); "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    check(ortho <= ORTHO_TOL and residual <= RESIDUAL_TOL
          and converged <= CONVERGED_TOL and math.isfinite(lam),
          f"eff_dim (a): orthonormality {ortho:.3g}, residual "
          f"{residual:.3g}, top 3 from 40 vs 50 iterations {converged:.3g}")


def declare_sgd_grid(jugdir, body):
    """(b)'s queue: the four train_sgd tasks of TQ_GRID (googleresnet on
    fake_cifar10, SGD with momentum 0.9, batch 128, stairs), each run by
    `body(replicate, **config)`"""
    from bnn_priors_tpu_torch.exp import TaskQueue
    q = TaskQueue(jugdir)

    def train_sgd(replicate, **config):
        return body(replicate, **config)
    enqueue = q.generator(train_sgd)
    for seed, lr in TQ_GRID:
        enqueue(seed, model="googleresnet", data="fake_cifar10", lr=lr,
                momentum=0.9, batch_size=128, sampling_decay="stairs",
                n_epochs=TQ_EPOCHS, epochs_per_sample=1, skip_first=1,
                seed=seed)
    return q


def taskqueue_main(worker, jugdir, runs_dir):
    """phase 23 (b) in one of two worker processes on the card: declares
    the grid on the shared jugdir and runs the tasks it claims, each
    train_sgd's `main` in this process (the card's machine has no h5py:
    the in-memory stand-ins) on fake_cifar10 cut to TQ_N / TQ_N_TEST; a
    task's result holds its run's launches by kernel and the noise_std of
    every `(T,)` launch. Prints TQ_TAG and its count of tasks as JSON."""
    from bnn_priors_tpu_torch import exp_utils
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.exp.taskqueue import cli_args
    from bnn_priors_tpu_torch.experiments import train_sgd as sgd_cli
    from bnn_priors_tpu_torch.ops import fused_update as fu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hdf5_or_stand_in()
    get_data = exp_utils.get_data

    def cut_data(name, device="cuda", **kw):
        if name == "fake_cifar10":
            return FakeCIFAR10(n_train=TQ_N, n_test=TQ_N_TEST, device=device)
        return get_data(name, device=device, **kw)

    sigmas, _ = spy_noise(fu)

    def body(replicate, **config):
        run_dir = os.path.join(runs_dir, f"r{replicate}-lr{config['lr']}")
        reset_counts(fu)
        sigmas.clear()
        t0 = time.perf_counter()
        result = sgd_cli.main(cli_args("argparse", **config,
                                       log_dir=run_dir))
        torch.cuda.synchronize()
        return {"worker": int(worker), "pid": os.getpid(),
                "run_dir": run_dir, "launches": fu.launches,
                "others": other_launches(fu, "launches"),
                "sigmas": sorted(set(sigmas)), "result": result,
                "wall_s": time.perf_counter() - t0}
    exp_utils.get_data = cut_data
    q = declare_sgd_grid(jugdir, body)
    t0 = time.perf_counter()
    ran = q.execute()
    print(TQ_TAG, json.dumps({"worker": int(worker), "done": ran,
                              "wall_s": time.perf_counter() - t0}))
    return 0


def phase_taskqueue(card):
    """(b): two `chip_smoke.py taskqueue` workers on the card share one
    jugdir: every task claimed and run once, all done, each run's `(T,)`
    launches the schedule's at noise_std 0 and no other kernel's"""
    out_dir = os.path.join(RUNS_DIR, "taskqueue23")
    shutil.rmtree(out_dir, ignore_errors=True)
    jugdir, runs_dir = (os.path.join(out_dir, d) for d in ("jugdir", "runs"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "taskqueue", str(w),
         jugdir, runs_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for w in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TQ_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    workers = []
    for p, text in zip(procs, outs):
        lines = [ln for ln in text.splitlines() if ln.startswith(TQ_TAG)]
        check(p.returncode == 0 and lines,
              f"phase 23 (b): a worker failed ({p.returncode}):\n"
              f"{text[-3000:]}")
        workers.append(json.loads(lines[-1][len(TQ_TAG):]))
    q = declare_sgd_grid(jugdir, None)
    status = q.status()
    check(status == {"waiting": 0, "running": 0, "done": len(TQ_GRID),
                     "failed": 0}, f"phase 23 (b): status {status}")
    records = [q.result(t) for t in q.tasks]
    by_worker = [sum(r["worker"] == w for r in records) for w in range(2)]
    expected = TQ_EPOCHS * -(-TQ_N // 128) + 1  # every step, then the last
    check([w["done"] for w in workers] == by_worker
          and sum(by_worker) == len(TQ_GRID)
          and not any(f.endswith(".lock") for f in os.listdir(jugdir)),
          f"phase 23 (b): tasks done by the workers "
          f"{[w['done'] for w in workers]}, records by worker {by_worker}")
    for t, r in zip(q.tasks, records):
        with open(os.path.join(r["run_dir"], "run.json")) as f:
            run = json.load(f)
        check(run["status"] == "COMPLETED" and run["result"] == r["result"]
              and r["launches"] == expected and r["others"] == 0
              and r["sigmas"] == [0.0]
              and all(math.isfinite(v) for v in r["result"].values()),
              f"phase 23 (b) {t.describe()}: run {run['status']}, (T,) "
              f"launches {r['launches']} (others {r['others']}), the "
              f"schedule implies {expected}; noise_std {r['sigmas']}")
        print(f"taskqueue (b) {t.describe()} ok in {r['wall_s']:.1f} s by "
              f"worker {r['worker']}: run.json COMPLETED, (T,) CUDA launches "
              f"{r['launches']} == {expected} = {TQ_EPOCHS} x "
              f"{-(-TQ_N // 128)} + 1, every one at noise_std 0, no other "
              f"kernel; result {json.dumps(r['result'])}")
    print(f"taskqueue (b) two workers on {card} ok in {wall:.1f} s: "
          f"{len(TQ_GRID)} tasks, each claimed and run once ({by_worker[0]} "
          f"+ {by_worker[1]}), all done, no lock left; worker loops "
          f"{workers[0]['wall_s']:.1f} / {workers[1]['wall_s']:.1f} s")
    return {"launches": [r["launches"] for r in records],
            "expected": expected, "by_worker": by_worker, "wall_s": wall}


def phase_slice14(card, cli):
    "phase 23: (a) and (b); returns the (T,) record's entries"
    t0 = time.perf_counter()
    phase_eff_dim(card, cli["run_dir"])
    tq = phase_taskqueue(card)
    print(f"phase 23 (the Hessian spectrum and the task queue) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"taskqueue_launches": tq["launches"],
            "taskqueue_expected": tq["expected"]}


# ------ phase 24: the paper-figure notebooks' compute ------------------------
FIG_WIDTH, FIG_DEPTH = 50, 3   # (a): the CLI's CNN (train_bnn.py:76-77)
FIG_EPOCHS = 2                 # (a): SGD epochs on fake_mnist's 60,000
DIAG_N, DIAG_N_TEST = 1280, 256  # (b): fake_cifar10 cut (from 50,000)
DIAG_RUN = dict(cycles=3, epochs_per_cycle=8, warmup_epochs=4,
                sample_epochs=4, learning_rate=5e-4, momentum=0.994,
                batch_size=128, temperature=1.0, seed=24)
DIAG_STEPS = 20                # (b): steps timed with and without
FIG_STEPS = 50                 # (a): SGD steps timed


def spy_noise(fu):
    """`fu.fused_langevin_update` wrapped to keep each launch's noise_std;
    returns (the list, a function that puts the wrapper back)"""
    update, sigmas = fu.fused_langevin_update, []

    def spied(*args, **kw):
        sigmas.append(float(args[6][2]))  # coeffs: (a, lr, noise_std, ...)
        return update(*args, **kw)
    fu.fused_langevin_update = spied
    return sigmas, lambda: setattr(fu, "fused_langevin_update", update)


def phase_figures_sgd(fu, card):
    """(a) Figs 1-2: the CNN at width 50, depth 3 trained by `sgd_weights`
    on fake_mnist's 60,000 images; launches, noise, fits, step ms"""
    from bnn_priors_tpu_torch import exp_utils
    from bnn_priors_tpu_torch.experiments import figures
    data = exp_utils.get_data("fake_mnist")
    x, y = data.norm.train
    model = figures.sgd_model(x, y, width=FIG_WIDTH, depth=FIG_DEPTH, seed=0)
    sigmas, restore = spy_noise(fu)
    reset_counts(fu)
    t0 = time.perf_counter()
    try:
        runner, params = figures.sgd_weights(model, (x, y), epochs=FIG_EPOCHS,
                                             seed=0)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches, others = fu.launches, other_launches(fu, "launches")
    expected = FIG_EPOCHS * runner.steps_per_epoch + 1  # and the last step
    check(launches == expected and others == 0 and len(sigmas) == launches
          and set(sigmas) == {0.0},
          f"figures (a): (T,) launches {launches} (others {others}), the "
          f"schedule implies {expected}; noise_std {sorted(set(sigmas))}")
    check(all(np.all(np.isfinite(v)) for v in params.values()),
          "figures (a): weights not finite")
    keys = figures.weight_leaves(params)
    check(len(keys) == 3, f"figures (a): weight leaves {keys}")
    fits = {k: figures.fit_weights(params[k]) for k in keys}
    check(all(np.all(np.isfinite(f[d])) for f in fits.values()
              for d in ("normal", "laplace", "t")),
          f"figures (a): fits {fits}")
    step = phase_step_time(runner, FIG_STEPS, temperature=0.0)
    total = runner.kernel.packer.total
    print(f"figures (a) ok in {wall:.1f} s on {card}: classificationconvnet "
          f"width {FIG_WIDTH} depth {FIG_DEPTH} (T = {total:,}) on "
          f"fake_mnist's {runner.N:,} images, SGLDRunner at "
          f"temperature 0 for {FIG_EPOCHS} epochs: (T,) CUDA launches "
          f"{launches} == {expected} = {FIG_EPOCHS} x "
          f"{runner.steps_per_epoch} + 1, every one at noise_std 0, no other "
          f"kernel; weights finite; Student-t (df, scale) of the weights "
          f"over their std "
          + ", ".join(f"{k} ({f['t'][0]:.3f}, {f['t'][2]:.4f})"
                      for k, f in fits.items())
          + f"; {step:.3f} ms a step (CUDA events, {FIG_STEPS} steps)")
    return {"launches": launches, "expected": expected, "step_ms": step,
            "t_df": {k: f["t"][0] for k, f in fits.items()}}


def verlet_expected(runner):
    """(T,) launches of a `VerletSGLDRunner` run: a step a minibatch, one
    more at each boundary after a sampling epoch (final and initial step
    from one gradient), the run's first step and its final boundary"""
    total = runner.cycles * runner.epochs_per_cycle
    boundaries = runner.cycles * runner.sample_epochs
    return total * runner.steps_per_epoch + (boundaries - 1) + 2


def phase_figures_diagnostics(fu, card):
    """(b) the sampler's health at ResNet-20's full width:
    `temperature_diagnostics` at temperature 1 on fake_cifar10 cut in data,
    its metrics through the in-memory stand-in; then the step with and
    without the per-leaf diagnostics in turns"""
    from bnn_priors_tpu_torch import exp_utils
    from bnn_priors_tpu_torch.experiments import figures
    data = exp_utils.get_data("fake_cifar10", n_train=DIAG_N,
                              n_test=DIAG_N_TEST)
    model = exp_utils.get_model("googleresnet")
    exp_utils.he_initialize(model, torch.Generator().manual_seed(24))
    run_dir = os.path.join(RUNS_DIR, "figures24")
    os.makedirs(run_dir, exist_ok=True)
    reset_counts(fu)
    t0 = time.perf_counter()
    diag = figures.temperature_diagnostics(model, data.norm.train, run_dir,
                                           **DIAG_RUN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runner, m, keys = diag["runner"], diag["metrics"], diag["keys"]
    launches, others = fu.launches, other_launches(fu, "launches")
    expected = verlet_expected(runner)
    check(launches == expected and others == 0,
          f"figures (b): (T,) launches {launches} (others {others}), the "
          f"schedule implies {expected}")
    check(len(keys) == runner.kernel.packer.n_leaves == 65,
          f"figures (b): {len(keys)} leaves in the metrics")
    for group in ("est_temperature", "est_config_temp"):
        bad = [k for k in keys if not np.all(np.isfinite(m[group][k]))]
        check(not bad, f"figures (b): {group} not finite for {bad[:5]}")
    cov, rows = diag["coverage"], diag["sampling"]
    check(cov.shape == (5, len(m["steps"])) and np.all(np.isfinite(cov))
          and rows.sum() == DIAG_RUN["cycles"] * DIAG_RUN["sample_epochs"]
          * runner.steps_per_epoch,
          f"figures (b): coverage {cov.shape}, {rows.sum()} sampling rows")
    inside = cov[-1][rows] * len(keys)
    saver = runner.metrics_saver
    turns = {"without": [], "with": []}
    for kind in ("without", "with", "with", "without"):
        runner.metrics_saver = saver if kind == "with" else None
        turns[kind].append(phase_step_time(runner, DIAG_STEPS,
                                           DIAG_RUN["temperature"]))
    runner.metrics_saver = saver
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    print(f"figures (b) ok in {wall:.1f} s on {card}: googleresnet on "
          f"fake_cifar10 {DIAG_N:,} images (cut from 50,000), "
          f"VerletSGLDRunner at temperature 1, {DIAG_RUN['cycles']} cycles "
          f"of {DIAG_RUN['epochs_per_cycle']} epochs: (T,) CUDA launches "
          f"{launches} == {expected}, no other kernel; 65 leaves' kinetic and "
          f"configurational temperatures finite over {len(m['steps'])} rows; "
          f"the 95% chi2 interval holds {inside.mean():.2f} of 65 leaves on "
          f"average over the {int(rows.sum())} sampling-epoch rows (min "
          f"{inside.min():.0f}, max {inside.max():.0f}); coverage at "
          f"5/25/50/75/95%: "
          + ", ".join(f"{c:.3f}" for c in cov[:, rows].mean(axis=1))
          + f"; a step {ms['without']:.3f} ms without and {ms['with']:.3f} "
          f"ms with the per-leaf diagnostics (turns: {turns['without']}, "
          f"{turns['with']}; CUDA events, {DIAG_STEPS} steps)")
    return {"launches": launches, "expected": expected, "step_ms": ms,
            "coverage_95": float(cov[-1][rows].mean())}


def phase_figures_curve(sweep):
    """(c) the tempering curve from phase 20's run dirs, without pandas:
    its lp_ensemble matrix equal to phase 20's results, bit for bit"""
    from bnn_priors_tpu_torch import notebook_utils
    from bnn_priors_tpu_torch.experiments import figures
    records = notebook_utils.run_records(sweep["log_dir"])
    check(len(records) == SWEEP_K, f"figures (c): {len(records)} run dirs")
    temps, reps, lp = figures.grid_matrix(records)
    check(list(temps) == SWEEP_TEMPS and list(reps) == list(range(SWEEP_REPS)),
          f"figures (c): grid {temps} x {reps}")
    for c, res in enumerate(sweep["results"]):
        r, t = divmod(c, len(SWEEP_TEMPS))
        check(lp[t, r] == res["lp_ensemble"],
              f"figures (c): chain {c}: {lp[t, r]!r} from its run dir, "
              f"{res['lp_ensemble']!r} from phase 20")
    curve = figures.tempering_curve(records)
    check(list(curve) == ["gaussian"]
          and np.all(np.isfinite(curve["gaussian"][1])),
          f"figures (c): curve {curve}")
    print(f"figures (c) ok: the {len(temps)} x {len(reps)} lp_ensemble matrix "
          f"from {len(records)} run dirs equals phase 20's results bit for "
          f"bit; curve (gaussian) "
          + ", ".join(f"T={t:g}: {v:.4f}"
                      for t, v in zip(*curve["gaussian"])))


def phase_figures_fits():
    """(d) Figs 3, 4, 5 and A.10 from the port's fits copies: shapes,
    finite values, symmetric covariances; the GenNorm β per layer"""
    from bnn_priors_tpu_torch.experiments import figures
    mean_covs, lengthscales, weight_fits = figures.cifar10_fits()
    covs = figures.covariances(mean_covs, (9, 9), 8)
    mnist_covs, mnist_fits = figures.mnist_fits()
    covs2 = figures.covariances(mnist_covs)
    for k, c in covs + covs2:
        check(c.ndim == 2 and c.shape[0] == c.shape[1]
              and np.all(np.isfinite(c)) and np.array_equal(c, c.T),
              f"figures (d): covariance {k} {c.shape}")
    check(len(covs) == 8 and len(covs2) == 2,
          f"figures (d): {len(covs)} and {len(covs2)} covariances")
    keys, ls = figures.lengthscales(lengthscales)
    layers, ll, beta = figures.family_fits(weight_fits)
    names, dfs = figures.mvt_dfs()
    check(len(ls) == len(keys) > 0 and np.all(np.isfinite(ls))
          and all(v.shape == (len(layers),) and np.all(np.isfinite(v))
                  for v in (*ll.values(), beta))
          and len(dfs) == len(names) > 0 and np.all(np.isfinite(dfs)),
          "figures (d): lengthscales, family fits or dfs")
    variances = figures.scalar_variances(mnist_covs)
    fitted = {figures.short(k): np.isfinite(np.asarray(m)).all()
              for k, (m, c) in mnist_covs.items() if np.ndim(c) == 0}
    check(all(np.isfinite(v) == fitted[k] for k, v in variances.items()),
          f"figures (d): scalar variances {variances}")
    best = figures.best_families(mnist_fits)
    check(all(np.isfinite(lp) for _, _, lp in best), f"figures (d): {best}")
    print(f"figures (d) ok: {len(covs)} CIFAR-10 and {len(covs2)} MNIST "
          f"covariances finite and symmetric, {len(ls)} lengthscales, "
          f"{len(layers)} layers' family fits, {len(dfs)} multivariate-t df "
          f"({dfs.min():.3f}-{dfs.max():.1f}), MNIST best families "
          f"{[f for _, f, _ in best]}; GenNorm beta per layer "
          + ", ".join(f"{b:.3f}" for b in beta))


def phase_slice15(fu, card, sweep):
    "phase 24: (a)-(d); returns the (T,) record's entries"
    t0 = time.perf_counter()
    sgd = phase_figures_sgd(fu, card)
    diag = phase_figures_diagnostics(fu, card)
    phase_figures_curve(sweep)
    phase_figures_fits()
    print(f"phase 24 (the paper-figure notebooks' compute) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"figures_sgd_launches": sgd["launches"],
            "figures_sgd_expected": sgd["expected"],
            "figures_sgd_step_ms": sgd["step_ms"],
            "figures_diag_launches": diag["launches"],
            "figures_diag_expected": diag["expected"],
            "figures_diag_step_ms": diag["step_ms"]}


# ---------------------------------- phase 25: matmul_precision on the card --
# every mode, by a JAX value that selects it
PRECISION_MODES = ("float32", "tensorfloat32", "bfloat16", "F16_F16_F32",
                   "BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "F16_F16_F16",
                   "F64_F64_F64")
# the modes that change a float32 product's arithmetic: the split modes
# (bfloat16 and F16_F16_F32 repaired to a float32 result, X3 and X6) and
# the cast modes (an f16 result, float64), held against emulations in (a)
EMULATED_MODES = PRECISION_MODES[2:]
# (b)'s bounds, stated before the first call: the relative L2 error of the
# minibatch gradient and of the exact-pass potential against float32
PRECISION_BOUNDS = {"float32": 0.0, "tensorfloat32": 2e-2, "bfloat16": 1e-1,
                    "F16_F16_F32": 2e-2, "BF16_BF16_F32_X3": 1e-3,
                    "BF16_BF16_F32_X6": 1e-4, "F16_F16_F16": 2e-2,
                    "F64_F64_F64": 1e-4}
# (b): the gradient as the sampler takes it, where a ReLU whose input
# changes sign moves the gradient by O(1), against the minibatch noise
PRECISION_NOISE_SHARE = 0.5
PRECISION_N = 1280        # (b)-(d)'s fake_cifar10 points: 10 full batches
PRECISION_STEPS = 15      # (d): minibatch steps a turn (CUDA events; 30
                          # when (d) timed three modes)
PRECISION_PROFILE_STEPS = 2  # (d): a profiler window's steps (3 when (d)
                             # timed three modes)
# (d): the modes a profiler window is taken at, for the busy share (all
# three when (d) timed three modes)
PRECISION_WINDOW_MODES = ("float32", "bfloat16", "BF16_BF16_F32_X3",
                          "BF16_BF16_F32_X6", "F64_F64_F64")
# (d): the modes at which an evaluation's peak device memory is read
PRECISION_MEMORY_MODES = ("float32", "bfloat16", "BF16_BF16_F32_X3",
                          "BF16_BF16_F32_X6")
PRECISION_CLI = "BF16_BF16_F32_X3"  # (c): the CLI's run (phases 2 and 9
                                    # run its default, bfloat16)
U_BF16 = 2.0 ** -8        # bf16's unit roundoff
U_F32 = 2.0 ** -24        # float32's: one rounding of a result
TF32_ULP = 2.0 ** -10     # one TF32 ulp, relative: an operand's conversion
LAYER_ATOL = 1e-5         # float32 accumulation order, of the magnitudes
# (a): X3 against the exact product drops lo·lo, hi·lo₂ and lo₂·hi, each
# at most 2^-16 of its term's magnitude; X6 and float64 drop nothing
# above float32's own noise
X3_TRUNCATION = 3 * 2.0 ** -16
# (a): the split kernel at ResNet-20's and resnet18's widest activations
# (batch 128, 32x32 maps), and the layouts the layers ask of it
SPLIT_SHAPES = (("ResNet-20", (128, 16, 32, 32)),
                ("resnet18", (128, 64, 32, 32)))
# (a): the weight tables the runners split, by model and mode
SPLIT_TABLE_MODELS = (("ResNet-20", "googleresnet"), ("resnet18", "resnet18"))
SPLIT_TABLE_MODES = ("BF16_BF16_F32", "F16_F16_F32", "BF16_BF16_F32_X3",
                     "BF16_BF16_F32_X6")
SPLIT_CALLS = 50          # (a): launches a CUDA graph
SPLIT_REPLAYS = 10        # (a): replays of the graph between two events
# (a): the bytes of a timing ring of inputs and outputs, five times the
# H100's 50 MB L2, so that each launch of the graph reads and writes DRAM
SPLIT_RING_BYTES = 256 << 20
SPLIT_KERNEL = "split_table_kernel"  # the kernel's name in a trace
SPLIT_SOURCE = "bnn_priors_tpu_torch/csrc/split_operand.cu"
# the JAX package's dispatch under `jax.default_matmul_precision`, where XLA
# runs the split-bf16 dots on the TPU's MXU: no TPU kernel of its own
SPLIT_REPLACES = "bnn_priors_tpu/inference/runner.py:214"


def round_tf32(t):
    "float32 rounded to TF32's 10-bit significand, to nearest"
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(t):
    return t.bfloat16().float()


def split_bound_ms(numel, P):
    "the split's byte bound: 4 B read and 4·P B written an element"
    return numel * 4 * (1 + P) / H100_BYTES_PER_S * 1e3


def table_bound_ms(table):
    """a table's byte bound: each source element read once (at P > 1 a
    weight has two entries over one range, the forward's and the dgrad's
    layout), and every entry's P blocks written"""
    read = end = 0
    for o, r, m in sorted(table.operands):
        read += max(0, o + r * m - max(o, end))
        end = max(end, o + r * m)
    written = table.P * sum(r * m for _, r, m in table.operands)
    return (read + written) * 4 / H100_BYTES_PER_S * 1e3


def ring(*tensors):
    """copies of `tensors` (the first the tensors themselves) whose bytes
    together pass SPLIT_RING_BYTES, at most SPLIT_CALLS"""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    k = max(2, min(SPLIT_CALLS, -(-SPLIT_RING_BYTES // nbytes)))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(k - 1)]


def nans(*shape):
    "a float32 tensor on the card filled with NaN: what a launch must fill"
    return torch.full(shape, float("nan"), device="cuda")


def graph_us(fn, n=SPLIT_CALLS, replays=SPLIT_REPLAYS):
    """µs a launch of `n` launches `fn(0)` ... `fn(n - 1)` captured in one
    CUDA graph, CUDA events around `replays` replays (the graph's own gaps
    between kernels included, no host). `fn(i)` takes its operands from
    copy i of a ring (`ring`), so that no launch finds them in L2"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    ms = events_ms(lambda: [graph.replay() for _ in range(replays)])
    del graph
    return ms * 1e3 / (n * replays)


def weight_tables(model_name):
    """(the model's flat position on the card, {mode: the table of its
    multiplying layers' weights that the runners split in that mode}):
    full width, He-initialised from a seed"""
    from bnn_priors_tpu_torch import precision
    from bnn_priors_tpu_torch.exp_utils import get_model, he_initialize
    from bnn_priors_tpu_torch.mcmc.packing import Packer
    from bnn_priors_tpu_torch.models import layers
    model = he_initialize(get_model(model_name),
                          torch.Generator().manual_seed(0))
    pk = Packer(model.params())
    pos = pk.pack({k: v.detach() for k, v in model.params().items()})
    tables = {}
    for v in SPLIT_TABLE_MODES:
        with precision.matmul_precision(v):
            with layers.split_weights(model, pk, pos) as split:
                tables[v] = split.plan.table
    return pos, tables


def check_split_table(tag, src, table):
    """the table form against one plain split an operand, into an output
    filled with NaN, bit for bit; returns max |d|"""
    from bnn_priors_tpu_torch.ops import split_operand as so
    out = so.split_table(src, table, out=nans(table.size))
    ref = so.split_table_reference(src, table)
    torch.cuda.synchronize()
    err = 0.0
    for i, (o, r, m) in enumerate(table.operands):
        k, p = table.view(out, i), table.view(ref, i)
        check(torch.equal(k, p), f"split (a) {tag} operand {i} (offset {o}, "
              f"{r} x {m}): kernel != plain, max |d| "
              f"{float((k - p).abs().nan_to_num(float('inf')).max()):.3g}")
        err = max(err, float((k - p).abs().max()))
    return err


def split_timing(tag, kernel, copies, plain, bound_ms, card):
    """the device's µs a launch (CUDA events around a CUDA graph of
    SPLIT_CALLS launches over a ring of `copies` operands and outputs
    larger than L2: no host in it; the profiler's kernel records went
    missing in whole-script runs), host µs a call, the plain version's
    ms, beside the byte bound"""
    t = {"graph_us": graph_us(kernel), "ring": copies,
         "enqueue_us": enqueue_us(lambda: kernel(0), 200),
         "plain_ms": time_ms(plain, 10), "bound_ms": bound_ms}
    t["ms"] = t["graph_us"] / 1e3
    print(f"split (a) {tag} on {card}: {t['graph_us']:.2f} us a launch in a "
          f"CUDA graph of {SPLIT_CALLS} over a ring of {copies} "
          f"({1e3 * bound_ms / t['graph_us']:.0%} of the byte bound, "
          f"{1e3 * bound_ms:.2f} us), host {t['enqueue_us']:.2f} us a call, "
          f"plain {t['plain_ms']:.4f} ms")
    return t


def phase_split_kernel(card):
    """(a) the split kernel against its plain version, bit for bit, into
    outputs filled with NaN: at ResNet-20's and resnet18's widest
    activations in 16 layouts (n = 1, 2, 3 bf16 and f16 parts in the
    plain layout, X3's and X6's forward layouts: rows of one image, the
    left operand's parts of each pair; the kernel reads the plain n = 2,
    3 and X6's left layouts at run time) and one no mode uses; operands
    at odd offsets, with an M
    not a multiple of 4, and into an unaligned output; the table form on
    odd operands, past one launch's 64 entries, and on both models' weight
    tables in bfloat16, F16_F16_F32, X3 and X6. Then its device time a
    launch (`split_timing`, over a ring of operands larger than L2)
    beside the plain version's and the byte bound, at the main path's
    shapes: the widest activations at one part, X3 and X6, and the
    weight tables at one part and X3"""
    from bnn_priors_tpu_torch import precision
    from bnn_priors_tpu_torch.ops import _cuda_lib
    from bnn_priors_tpu_torch.ops import split_operand as so
    gen = torch.Generator().manual_seed(17)
    rnd = lambda *shape: (torch.randn(shape, generator=gen) * torch.exp(
        torch.randn(shape, generator=gen))).cuda()
    err, timing, acts = 0.0, {}, {}
    left = lambda v: tuple(p[0] for p in precision.mode_of(v).pairs)

    def one(tag, x, n, dt, sel, rows, out=None):
        nonlocal err
        P, M = len(sel or range(n)), x.numel() // rows
        out = nans(rows, P, M) if out is None else out
        k = so.split_operand(x, n, dt, sel, rows, out=out)
        r = so.split_operand_reference(x, n, dt, sel, rows)
        torch.cuda.synchronize()
        check(torch.equal(k, r), f"split (a) {tag} {dt} n={n} select={sel} "
              f"rows={rows}: kernel != plain, max |d| "
              f"{float((k - r).abs().nan_to_num(float('inf')).max()):.3g}")
        err = max(err, float((k - r).abs().max()))

    for name, shape in SPLIT_SHAPES:
        x = acts[name] = rnd(*shape)
        for dt in (torch.bfloat16, torch.float16):
            for n in (1, 2, 3):
                one(name, x, n, dt, None, 1)
        for value in ("BF16_BF16_F32_X3", "BF16_BF16_F32_X6"):
            one(name, x, precision.mode_of(value).parts, torch.bfloat16,
                left(value), shape[0])
        # a layout no mode uses: the kernel's run-time instantiation
        one(name, x, 3, torch.float16, (2, 0, 1, 1), shape[0])
    buf = rnd(1 << 16)
    for off, rows, M in ((1, 5, 27), (2, 16, 144), (3, 1, 4099), (4, 7, 64)):
        x = buf[off:off + rows * M]
        for n, sel in ((1, None), (2, (0, 1, 0)), (3, (0, 0, 1, 1, 0, 2)),
                       (2, (1, 0))):
            one(f"offset {off} {rows} x {M}", x, n, torch.bfloat16, sel, rows)
    flat = nans(1 + 5 * 3 * 64)
    one("into an output at an odd offset", buf[:5 * 64], 2, torch.bfloat16,
        (0, 0, 1), 5, out=flat[1:].view(5, 3, 64))
    check(bool(torch.isnan(flat[0])), "split (a): a write before the output")
    odd = [(1, 3, 27), (7, 1, 5), (13, 5, 12), (2, 9, 100), (40000, 1, 4097)]
    for v in SPLIT_TABLE_MODES:
        mode = precision.mode_of(v)
        err = max(err, check_split_table(
            f"odd table {v}", buf, so.SplitTable(
                odd, mode.parts, mode.operand, left(v))))
    many = so.SplitTable([(97 * i + i % 4, 1 + i % 3, 33 + i)
                          for i in range(70)], 2, torch.bfloat16, (0, 1, 0))
    cap = _cuda_lib.load("split_operand").bnn_split_max_entries()
    before = so.launches
    err = max(err, check_split_table("70 operands", buf, many))
    check(so.launches - before == -(-len(many) // cap), f"split (a): 70 "
          f"operands took {so.launches - before} launches, {cap} a launch")
    tables = {}
    for name, model_name in SPLIT_TABLE_MODELS:
        pos, by_mode = weight_tables(model_name)
        for v, table in by_mode.items():
            err = max(err, check_split_table(f"{name} weights {v}", pos,
                                             table))
        tables[name] = (pos, by_mode)
        print(f"split (a) {name} weights: {len(by_mode['BF16_BF16_F32'])} "
              f"operands at one part, {len(by_mode['BF16_BF16_F32_X3'])} at "
              f"X3 and X6, bit for bit in {len(by_mode)} modes")
    print(f"split (a) ok: the kernel equals its plain version bit for bit "
          f"in {2 * 8} layouts at both activations and one read at run "
          f"time, at odd offsets and M, and on "
          f"{2 * len(SPLIT_TABLE_MODES)} weight tables (max |d| {err})")

    for name, shape in SPLIT_SHAPES:
        x = acts[name]
        for tag, n, sel, rows in (("bfloat16", 1, None, 1),
                                  ("X3", 2, (0, 0, 1), shape[0]),
                                  ("X6", 3, (0, 0, 1, 1, 0, 2), shape[0])):
            P = len(sel or (0,))
            rg = ring(x, torch.empty((rows, P, x.numel() // rows),
                                     device="cuda"))
            timing[f"{name}/{tag}"] = split_timing(
                f"{name} {tuple(shape)} {tag} (P = {P})",
                lambda i: so.split_operand(rg[i % len(rg)][0], n,
                                           torch.bfloat16, sel, rows,
                                           out=rg[i % len(rg)][1]),
                len(rg),
                lambda: so.split_operand_reference(x, n, torch.bfloat16, sel,
                                                   rows),
                split_bound_ms(x.numel(), P), card)
            del rg
    for name, (pos, by_mode) in tables.items():
        for tag, v in (("bfloat16", "BF16_BF16_F32"),
                       ("X3", "BF16_BF16_F32_X3")):
            table = by_mode[v]
            rg = ring(pos, torch.empty(table.size, device="cuda"))
            timing[f"{name} weights/{tag}"] = split_timing(
                f"{name} weight table {tag} ({len(table)} operands, "
                f"{sum(r * m for _, r, m in table.operands):,} elements)",
                lambda i: so.split_table(rg[i % len(rg)][0], table,
                                         out=rg[i % len(rg)][1]),
                len(rg), lambda: so.split_table_reference(pos, table),
                table_bound_ms(table), card)
            del rg
    return {"max_abs_err": err, "timing": timing}


def precision_layer_cases(gen):
    """(name, layer, x, w) at ResNet-20's shapes on the card: a 3x3
    convolution of 32 channels on 16x16 maps and the 64 -> 10 head, one
    chain and K chains (channel groups, batched product), no bias"""
    from bnn_priors_tpu_torch import priors
    from bnn_priors_tpu_torch.models import layers
    rn = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    conv = lambda: layers.Conv2d(priors.Normal((32, 32, 3, 3), 0., 1.),
                                 padding=1).cuda()
    conv4 = lambda: layers.Conv2d(priors.Normal((16, 16, 3, 3), 0., 1.),
                                  padding=1).cuda()
    lin = lambda: layers.Linear(priors.Normal((10, 64), 0., 1.)).cuda()
    return [("conv", conv(), rn(128, 32, 16, 16), rn(32, 32, 3, 3) / 17),
            ("conv K=4", conv4(), rn(32, 64, 16, 16),
             rn(4, 16, 16, 3, 3) / 12),
            ("linear", lin(), rn(128, 64), rn(10, 64) / 8),
            ("linear K=8", lin(), rn(128, 8 * 64), rn(8, 10, 64) / 8)]


def layer_products(layer, x, w, v, mode):
    """(out, dgrad, wgrad) of `layer` at input x and weight w with the
    cotangent v, under `mode`"""
    from bnn_priors_tpu_torch import precision
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    with precision.matmul_precision(mode):
        out = torch.func.functional_call(layer, {"weight_prior.p": w}, (x,))
        out.backward(v)
    torch.cuda.synchronize()
    return out.detach(), x.grad, w.grad


def emulated_products(layer, x, w, v, value):
    """(out, dgrad, wgrad) of the mode of `value` emulated in float64 on
    the same operands: the plain version's parts and the mode's pairs of
    part products summed, or the cast and the result's rounding"""
    from bnn_priors_tpu_torch import precision
    from bnn_priors_tpu_torch.ops.split_operand import \
        split_operand_reference
    mode = precision.mode_of(value)
    f64 = lambda a, b, g: layer_products(layer, a.double(), b.double(),
                                         g.double(), None)
    if not mode.parts:
        dt = mode.operand
        c = lambda t: t.to(dt).double()
        return [c(p) for p in f64(c(x), c(w), c(v))]
    parts = lambda t: split_operand_reference(
        t, mode.parts, mode.operand).view(mode.parts, *t.shape)
    xp, wp, vp = parts(x), parts(w), parts(v)
    return [sum(f64(xp[i], wp[j], vp[0])[0] for i, j in mode.pairs),
            sum(f64(xp[0], wp[j], vp[i])[1] for i, j in mode.pairs),
            sum(f64(xp[j], wp[0], vp[i])[2] for i, j in mode.pairs)]


def phase_precision_layers(card):
    """(a) the two layers on the card. TF32 against the float32 op (TF32
    off) on TF32-rounded operands, within 2 TF32 ulps (the card may
    truncate where the reference rounds) + LAYER_ATOL of the magnitudes.
    Each mode that changes the arithmetic against its float64 emulation
    on the same operands, within LAYER_ATOL of the magnitudes and the
    result's rounding (U_F32; an f16 ulp for F16_F16_F16); the split
    modes' and float64's results float32 (the repaired bfloat16's dgrad
    and wgrad not bf16-exact); X3 within X3_TRUNCATION + LAYER_ATOL of the
    magnitudes of the exact product, X6 and float64 within LAYER_ATOL"""
    gen = torch.Generator().manual_seed(25)
    errs = {}

    def hold(name, mode, part, o, r, bound, what):
        err = (o - r).abs()
        check(bool((err <= bound).all()),
              f"precision (a) {name} {mode} {part} {what}: off by "
              f"{float(err.max()):.3g}, worst over its bound "
              f"{float((err / bound).max()):.3g}")
        rel = float(err.norm() / r.norm())
        print(f"precision (a) {name:10s} {mode:16s} {part:5s}: max |d| "
              f"{float(err.max()):.3g} {what} (rel L2 {rel:.3g}), worst "
              f"share of the bound {float((err / bound).max()):.3f}")
        return rel
    for name, layer, x, w in precision_layer_cases(gen):
        with torch.no_grad():
            shape = torch.func.functional_call(
                layer, {"weight_prior.p": w}, (x,)).shape
        v = torch.randn(shape, generator=gen).cuda()
        mags = layer_products(layer, x.abs(), w.abs(), v.abs(), "float32")
        exact = layer_products(layer, x.double(), w.double(), v.double(),
                               None)
        ours = layer_products(layer, x, w, v, "tensorfloat32")
        ref = layer_products(layer, round_tf32(x), round_tf32(w), v,
                             "float32")
        for part, o, r, m in zip(("out", "dgrad", "wgrad"), ours, ref, mags):
            errs[f"{name} tensorfloat32 {part}"] = hold(
                name, "tensorfloat32", part, o, r,
                (2 * TF32_ULP + LAYER_ATOL) * m,
                "to the float32 op on TF32-rounded operands")
        for mode in EMULATED_MODES:
            ours = layer_products(layer, x, w, v, mode)
            emu = emulated_products(layer, x, w, v, mode)
            f16_out = mode == "F16_F16_F16"
            for k, (part, o, e, m, t) in enumerate(zip(
                    ("out", "dgrad", "wgrad"), ours, emu, mags, exact)):
                check(o.dtype == torch.float32, f"precision (a) {name} "
                      f"{mode} {part}: {o.dtype}")
                if f16_out:
                    check(torch.equal(o, o.half().float()), f"precision "
                          f"(a) {name} {mode} {part}: not f16-exact")
                    # one f16 ulp: 2^-10 of the value, 2^-24 in subnormals
                    rnd = torch.clamp(e.abs() * 2.0 ** -10, min=2.0 ** -24)
                else:
                    rnd = U_F32 * e.abs()
                errs[f"{name} {mode} {part}"] = hold(
                    name, mode, part, o, e, rnd + LAYER_ATOL * m,
                    "to its float64 emulation")
                if mode == "bfloat16" and k:
                    check(not torch.equal(o, round_bf16(o)), f"precision "
                          f"(a) {name} bfloat16 {part}: rounded to bf16")
                if mode in ("BF16_BF16_F32_X3", "BF16_BF16_F32_X6",
                            "F64_F64_F64"):
                    trunc = X3_TRUNCATION if mode.endswith("X3") else 0.0
                    hold(name, mode, part, o, t,
                         U_F32 * t.abs() + (trunc + LAYER_ATOL) * m,
                         "to the exact product")
    print(f"precision (a) ok on {card}: TF32 within its ulps; bfloat16, "
          f"F16_F16_F32, X3, X6, F16_F16_F16 and F64_F64_F64 within "
          f"float32's accumulation noise of their float64 emulations")
    return errs


def phase_precision_path(card):
    """(b) ResNet-20 at He-initialised parameters on PRECISION_N points and
    one batch of 128, at each mode against float32, with cuDNN's
    deterministic algorithms (so that float32 is bit for bit the run
    without a mode): the minibatch gradient with the float32 run's ReLU
    masks replayed (the mode's arithmetic) and the exact pass's potential
    within PRECISION_BOUNDS (relative L2); the gradient as the sampler
    takes it (its ReLUs free to flip) within PRECISION_NOISE_SHARE of the
    minibatch noise, ‖g(batch 2) − g(batch 1)‖ / ‖g(batch 1)‖ at
    float32"""
    from bnn_priors_tpu_torch.exp_utils import get_data
    data = get_data("fake_cifar10", n_train=PRECISION_N, n_test=N_TEST)
    runner = make_runner(data, fresh_model(), "cuda", matmul_precision=None)
    batch = lambda b: (runner.train_x[b * 128:(b + 1) * 128],
                       runner.train_y[b * 128:(b + 1) * 128])
    pos = runner.chain.position
    grad = lambda b: runner._value_grad_of_batch(pos, *batch(b))[2].double()
    got, masks = {}, []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runner.matmul_precision = "float32"
        with relu_masks(record=masks):
            grad(0)
        noise_g = grad(1)
        for mode in (None,) + PRECISION_MODES:
            runner.matmul_precision = mode
            with relu_masks(replay=masks):
                masked = grad(0)
            got[mode] = (masked, grad(0),
                         runner._exact_vg()[2].double())
    finally:
        torch.backends.cudnn.deterministic = det
    ref = got["float32"]
    rel = lambda a, b: float((a - b).norm() / b.norm())
    noise = rel(noise_g, ref[1])
    check(all(torch.equal(a, b) for a, b in zip(got[None], ref)),
          "precision (b): float32 differs from the run without a mode")
    check(torch.equal(ref[0], ref[1]), "precision (b): the float32 "
          "gradient with its own ReLU masks replayed differs from it")
    out = {"minibatch_noise": noise}
    for mode in PRECISION_MODES:
        masked, free, pot = (rel(a, b) for a, b in zip(got[mode], ref))
        out[mode] = {"grad_masked": masked, "grad": free, "potential": pot}
        bound = PRECISION_BOUNDS[mode]
        check(masked <= bound and pot <= bound
              and free <= PRECISION_NOISE_SHARE * noise,
              f"precision (b) {mode}: minibatch gradient {masked:.3g} on "
              f"float32's ReLU masks, exact potential {pot:.3g} (bound "
              f"{bound}); free gradient {free:.3g} (bound "
              f"{PRECISION_NOISE_SHARE} x the minibatch noise {noise:.3g})")
        print(f"precision (b) {mode:16s} on {card}: relative L2 to float32:"
              f" minibatch gradient on float32's ReLU masks {masked:.3g}, "
              f"exact-pass potential {pot:.3g} (bound {bound}); minibatch "
              f"gradient as the sampler takes it {free:.3g} "
              f"({free / noise:.3f} of the minibatch noise {noise:.3g}, bound "
              f"{PRECISION_NOISE_SHARE})")
    print(f"precision (b) ok: float32 bit for bit the run without a mode; "
          f"potential {float(ref[2]):.6f} at float32")
    return out


@contextlib.contextmanager
def counted_products():
    """the layers' forward F.conv2d / F.linear counted by their operands
    (the yielded dict): their type, or "bf16 parts" for float32 operands
    that bf16 holds exactly, for the block"""
    import torch.nn.functional as F
    from bnn_priors_tpu_torch.models import layers
    counts = {}

    def count(x, w):
        exact = all(torch.equal(t, round_bf16(t)) for t in (x, w))
        kind = ("bf16 parts" if x.dtype == torch.float32 and exact
                else str(x.dtype))
        counts[kind] = counts.get(kind, 0) + 1

    class Counting:
        def __getattr__(self, name):
            return getattr(F, name)

        def conv2d(self, x, w, *args):
            count(x, w)
            return F.conv2d(x, w, *args)

        def linear(self, x, w, *args):
            count(x, w)
            return F.linear(x, w, *args)
    layers.F = Counting()
    try:
        yield counts
    finally:
        layers.F = F


def split_window(runner, n=PROFILE_STEPS):
    """a profiler window of `n` minibatch steps of `runner`: the split
    kernel's launches in the trace against the wrapper's count, and its
    device µs a launch"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bnn_priors_tpu_torch.ops import split_operand as so
    perm = torch.randperm(runner.N, device="cuda")
    B = runner.batch_size
    run = lambda: [runner._plain_step(
        perm[i % runner.n_full * B:(i % runner.n_full + 1) * B], i, 1.0)
        for i in range(n)]
    run()
    torch.cuda.synchronize()
    before = so.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counted = so.launches - before
    hit = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and SPLIT_KERNEL in e.key and e.self_device_time_total > 0]
    for e in hit:
        print(f"precision (c) window: {e.count} x {e.key[:100]}")
    traced = sum(e.count for e in hit)
    us = (sum(e.self_device_time_total for e in hit) / traced if traced
          else None)
    return counted, traced, us


def phase_precision_cli(fu, card):
    """(c) train_bnn at matmul_precision=PRECISION_CLI (its other keys the
    defaults) on fake_cifar10 cut to PRECISION_N / N_TEST, one cycle of 3
    epochs (1 warmup, 2 sampling): (T,) launches the schedule's, split
    launches, the forward products on bf16 parts, M-H acceptance in
    [0, 1]; a profiler window over the run's runner showing the split
    kernel; then the update kernel against its plain version on the run's
    last state and a minibatch gradient under the mode"""
    from bnn_priors_tpu_torch import exp_utils, precision
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.experiments import train_bnn
    from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject as R
    from bnn_priors_tpu_torch.ops import split_operand as so
    check(train_bnn.DEFAULTS["matmul_precision"] == "bfloat16",
          "train_bnn's default matmul_precision "
          f"{train_bnn.DEFAULTS['matmul_precision']}")
    cfg = cli_config(train_bnn, data="fake_cifar10", model="googleresnet",
                     inference="VerletSGLDReject", reject_samples=True,
                     cycles=1, warmup=1, burnin=0, n_samples=2, skip_first=0,
                     matmul_precision=PRECISION_CLI,
                     log_dir=os.path.join(RUNS_DIR, "precision"))
    expected = single_expected(PRECISION_N, cfg["batch_size"], 3, 2)
    real = exp_utils.get_data_seeded
    exp_utils.get_data_seeded = lambda name, seed, device="cuda": FakeCIFAR10(
        n_train=PRECISION_N, n_test=N_TEST, seed=int(seed), device=device)
    try:
        with captured_runs(R) as runs, counted_products() as counts:
            reset_counts(fu)
            t0 = time.perf_counter()
            result = train_bnn.main(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, others = fu.launches, other_launches(fu, "launches")
            splits = so.launches
    finally:
        exp_utils.get_data_seeded = real
    (runner, _), = runs
    rejected = [b["rejected"] for b in runner.boundaries]
    acceptance = 1.0 - float(np.mean(rejected))
    check(all(math.isfinite(v) for v in result.values()),
          f"precision (c): result {result}")
    check(launches == expected and others == 0,
          f"precision (c): (T,) launches {launches} (others {others}), the "
          f"schedule implies {expected}")
    n_boundaries = 2
    split_expected = resnet20_splits(
        precision.mode_of(PRECISION_CLI).parts, 3 * runner.steps_per_epoch,
        1 + n_boundaries, (1 + n_boundaries) * runner.steps_per_epoch, 3,
        3 * -(-N_TEST // runner.eval_batch_size))
    check(runner.matmul_precision == PRECISION_CLI
          and splits == split_expected and counts.get("bf16 parts", 0) > 0,
          f"precision (c): runner at {runner.matmul_precision}, split "
          f"launches {splits} (the schedule implies {split_expected}), "
          f"forward products by operands {counts}")
    check(len(rejected) == 2 and 0.0 <= acceptance <= 1.0,
          f"precision (c): M-H decisions {rejected}")
    counted, traced, split_us = split_window(runner)
    # a trace may miss records (one whole-script run showed 380 of 390),
    # never show more than were launched
    check(0 < traced <= counted,
          f"precision (c): the profiler shows {traced} split kernels over "
          f"{PROFILE_STEPS} steps, the wrapper counted {counted}")
    # the update's inputs under the mode: the run's last state and a
    # minibatch gradient, through the kernel and its plain version
    st, total = runner.chain, runner.kernel.packer.total
    g = runner._value_grad_of_batch(st.position, runner.train_x[:128],
                                    runner.train_y[:128])[2]
    c = with_sigma(coefficient_sets(runner.learning_rate, runner.N, 0.994,
                                    0.99)["ggmc_mid"], 1.0)
    base = [t.clone() for t in (st.position, st.momentum, st.square_avg, g,
                                st.precond)]
    ker = [t.clone() for t in base]
    ref = [t.clone() for t in base]
    *_, pk = fu.fused_langevin_update(*ker, 2516, c, total=total)
    *_, pr = fu.fused_langevin_update_reference(*ref, 2516, c, total=total)
    err, rel = compare_to_plain("precision (c) kernel", ker, ref, pk, pr,
                                total, 1e-5, lambda t: t[total:])
    print(f"precision (c) ok in {wall:.1f} s on {card}: train_bnn at "
          f"matmul_precision={PRECISION_CLI} on {PRECISION_N} points, "
          f"(T,) CUDA launches {launches} == {expected}, no other update "
          f"kernel; split launches {splits} == {split_expected}; forward "
          f"products by operands "
          f"{counts} (float32 ones: the final evaluate_model, outside the "
          f"runner); the profiler shows {traced} split kernels in "
          f"{PROFILE_STEPS} steps (counted {counted}), "
          f"{split_us:.2f} us a launch; acceptance {acceptance} (rejected "
          f"{rejected}); result {json.dumps(result)}; the update kernel on "
          f"the run's state and an X3 gradient against its plain version: "
          f"max |d| {err:.2e}, partials rel {rel:.2e}")
    return {"launches": launches, "expected": expected, "splits": splits,
            "acceptance": acceptance, "max_abs_err": err,
            "split_traced": traced, "split_us": split_us}


def peak_mb(fn):
    "MB of device memory that fn() held at its peak above its start"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def evaluation_peaks(runner, mode):
    """peak MB above its start of a minibatch gradient, an exact pass and
    a test pass under `mode`: what the weights split ahead hold"""
    from bnn_priors_tpu_torch import precision
    runner.matmul_precision = mode
    pos = runner.chain.position
    xb, yb = runner.train_x[:128], runner.train_y[:128]
    out = {"step": peak_mb(lambda: runner._value_grad_of_batch(pos, xb, yb))}
    with precision.matmul_precision(mode):
        out["exact"] = peak_mb(runner._exact_vg)
    out["test"] = peak_mb(runner._eval_current)
    return out


def phase_precision_steps(card):
    """(d) ms a minibatch step (CUDA events, PRECISION_STEPS steps) at
    every mode in turns (the modes, then the modes backwards), the split
    kernel's launches a step, then a profiler window at each of
    PRECISION_WINDOW_MODES for the busy share, and the peak memory of an
    evaluation at each of PRECISION_MEMORY_MODES: full-width ResNet-20
    and resnet18, one chain, batch 128"""
    from bnn_priors_tpu_torch.exp_utils import get_data, get_model, \
        he_initialize
    from bnn_priors_tpu_torch.ops import split_operand as so
    data = get_data("fake_cifar10", n_train=PRECISION_N, n_test=N_TEST)
    out = {}
    for name in ("googleresnet", "resnet18"):
        model = (fresh_model() if name == "googleresnet" else he_initialize(
            get_model(name), torch.Generator().manual_seed(0)))
        runner = make_runner(data, model, "cuda")
        ms = {m: [] for m in PRECISION_MODES}
        splits = {}
        for mode in PRECISION_MODES + PRECISION_MODES[::-1]:
            runner.matmul_precision = mode
            before = so.launches
            ms[mode].append(phase_step_time(runner, PRECISION_STEPS))
            splits[mode] = (so.launches - before) / (PRECISION_STEPS + 5)
        out[name] = {}
        for mode in PRECISION_MODES:
            runner.matmul_precision = mode
            step = float(np.mean(ms[mode]))
            w = (phase_profile(runner, step, f"precision (d) {name} {mode}",
                               n=PRECISION_PROFILE_STEPS)
                 if mode in PRECISION_WINDOW_MODES else {})
            out[name][mode] = {"step_ms": step, "turns_ms": ms[mode],
                               "busy": w.get("busy"),
                               "kernel_ms": w.get("kernel_ms"),
                               "kernels": w.get("kernels"),
                               "split_launches": splits[mode]}
            window = (f"{w['kernel_ms']:.3f} ms of kernels ({w['kernels']:.0f}"
                      f" a step), busy {w['busy']:.1%}" if w else
                      "no profiler window")
            print(f"precision (d) {name} {mode:16s} on {card}: "
                  f"{step:.3f} ms a step (turns "
                  f"{', '.join(f'{t:.3f}' for t in ms[mode])}), "
                  f"{splits[mode]:g} split launches a step; {window}")
        for mode in PRECISION_MEMORY_MODES:
            peaks = out[name][mode]["peak_mb"] = evaluation_peaks(runner,
                                                                  mode)
            print(f"precision (d) {name} {mode:16s} on {card}: peak MB "
                  f"above an evaluation's start: minibatch gradient "
                  f"{peaks['step']:.1f}, exact pass ({PRECISION_N} points) "
                  f"{peaks['exact']:.1f}, test pass ({N_TEST}) "
                  f"{peaks['test']:.1f}")
        del runner, model
    return out


def phase_slice16(fu, card):
    "phase 25: (a)-(d); returns the (T,) record's and the split record's"
    t0 = time.perf_counter()
    split = phase_split_kernel(card)
    layer_errs = phase_precision_layers(card)
    path = phase_precision_path(card)
    cli = phase_precision_cli(fu, card)
    steps = phase_precision_steps(card)
    print(f"phase 25 (matmul_precision on the card) ok in "
          f"{time.perf_counter() - t0:.1f} s")
    update = {"precision_launches": cli["launches"],
              "precision_expected": cli["expected"],
              "precision_acceptance": cli["acceptance"],
              "precision_layer_rel_err": max(layer_errs.values()),
              "precision_path_rel_err": path,
              "precision_step_ms": {n: {m: v["step_ms"] for m, v in d.items()}
                                    for n, d in steps.items()},
              "precision_busy": {n: {m: v["busy"] for m, v in d.items()}
                                 for n, d in steps.items()}}
    return update, {"split": split, "cli": cli, "steps": steps}


def split_record(main_launches, cli_launches, slice16):
    """the kernels-line entry of the split kernel: `launches` on the main
    path (phase 2, the CLI's default bfloat16), timing at ResNet-20's
    widest activation in that mode (one part): `ms` a launch's device
    time in a CUDA graph over a ring larger than L2"""
    split, cli = slice16["split"], slice16["cli"]
    t = split["timing"]["ResNet-20/bfloat16"]
    return {"name": "split_operand", "route": "cuda", "source": SPLIT_SOURCE,
            "replaces": SPLIT_REPLACES, "launches": main_launches,
            "cli_launches": cli_launches,
            "x3_cli_launches": cli["splits"],
            "x3_cli_traced": cli["split_traced"],
            "launches_a_step": {
                n: {m: v["split_launches"] for m, v in d.items()}
                for n, d in slice16["steps"].items()},
            "peak_mb": {n: {m: v["peak_mb"] for m, v in d.items()
                            if "peak_mb" in v}
                        for n, d in slice16["steps"].items()},
            "max_abs_err": split["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "graph_us": t["graph_us"],
            "enqueue_us": t["enqueue_us"], "device_us": cli["split_us"],
            "timing": split["timing"]}


def segments_record(name, seg, K):
    """one kernels-line entry of the segments kernel (ResNet-20's hybrid
    state at `K` chains; the segmented state's and resnet18's forms
    beside it)"""
    timing = seg["kernel"]["timing"]
    t = timing[f"ResNet-20/hybrid/{K}"]
    paths = seg["paths"]
    if K == 1:
        counts = {p: paths[p]["launches"] for p in SEG_PACKINGS}
        expected = paths["hybrid"]["expected"]
    else:
        counts = {p: paths["chains"][p]["launches"] for p in SEG_PACKINGS}
        expected = paths["chains"]["hybrid"]["expected"]
    forms = {key: {"ring_us": m["ring_us"], "hot_us": m["hot_us"],
                   "device_us": m["device_us"], "ms": m["call_ms"],
                   "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"]}
             for key, m in timing.items()
             if "/flat/" not in key and key.endswith(f"/{K}")}
    return {"name": name, "route": "cuda", "source": SEG_SOURCE,
            "replaces": SEG_REPLACES, "launches": counts["hybrid"],
            "segments_launches": counts, "segments_expected": expected,
            "resume_launches": seg["resume"]["single" if K == 1
                                             else "chains"]["launches"],
            "max_abs_err": seg["kernel"]["max_abs_err"],
            "ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "b2b_ms": t["b2b_ms"],
            "enqueue_us": t["enqueue_us"], "device_us": t.get("device_us"),
            "ring_us": t["ring_us"], "forms": forms,
            "flat_kernel_ms": timing[f"ResNet-20/flat/{K}"]["call_ms"],
            "flat_kernel_ring_us": timing[f"ResNet-20/flat/{K}"]["ring_us"],
            "flat_kernel_hot_us": timing[f"ResNet-20/flat/{K}"]["hot_us"]}


def kernel_record(name, launches, timing, cli, more):
    """one entry of the `kernels` JSON line; `launches` is the count on
    the runner's path (phase 2 or 6), `cli_launches` on the CLI's (9, 10),
    and `more` the resume (13), HMC (14) and prior-grid (15) paths'
    counts"""
    cuda, triton = timing["cuda"], timing["triton"]
    return {"name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": "bnn_priors_tpu/ops/fused_update.py:47",
            "launches": launches, "cli_launches": cli["launches"],
            "cli_expected": cli["expected"], **more,
            "max_abs_err": timing["max_abs_err"],
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
    if sys.argv[1:2] == ["resume-deterministic"]:  # phases 13, 16 (e)
        return resume_deterministic_main(*sys.argv[2:3])
    if sys.argv[1:2] == ["resume-cli-chains"]:  # phase 17 (e)
        return cli_resume_main()
    if sys.argv[1:2] == ["ranks"]:  # phase 22
        return ranks_main(*sys.argv[2:6])
    if sys.argv[1:2] == ["taskqueue"]:  # phase 23 (b)
        return taskqueue_main(*sys.argv[2:5])
    from bnn_priors_tpu_torch.ops import fused_update as fu
    card = card_line()
    print(card)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)
    t_start = time.perf_counter()

    def elapsed(phases):
        "the script's time so far, for its 1,200 s budget"
        print(f"chip_smoke: phases {phases} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    phase_build()
    elapsed("0")

    timing = phase_kernel(fu)
    runner, launches, split_launches, data = phase_main_path(fu)
    phase_reference()
    runner.matmul_precision = "float32"  # phase 4's steps: float32, TF32 off
    steps = steps_in_turns(fu, "main path (f32)",
                           lambda: phase_step_time(runner),
                           f"ms per minibatch step (batch 128, ResNet-20) on "
                           f"{card}")
    phase_profile(runner, steps["cuda"])
    with_triton(fu, lambda: phase_profile(runner, steps["triton"], "triton"))
    runner.compute_dtype = torch.bfloat16
    print(f"main path: {phase_step_time(runner):.3f} ms per minibatch step "
          f"in bf16 compute on {card}")
    phase_step_parts(data, runner.model, card)
    key2 = runner.chain.key
    del runner, data
    chain_timing = phase_chain_kernel(fu)
    chains, chain_launches, data = phase_chain_path(fu)
    phase_chain_reference()
    rates, turns = phase_chain_throughput(fu, chains, data, card)
    phase_chain_profile(chains, rates[K_CHAINS][0])
    with_triton(fu, lambda: phase_chain_profile(
        chains, K_CHAINS * 1e3 / turns["triton"], "triton"))
    del chains
    elapsed("1-8")
    hdf5_or_stand_in()
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    cli = phase_cli_single(fu, card)
    cli_chains = phase_cli_chains(fu, card)
    phase_cli_eval(cli)
    phase_eval_card_vs_cpu(cli_chains["bank"])
    elapsed("9-12")
    resume = phase_resume(fu, card)
    hmc = phase_hmc(fu, card)
    phase_hmc_reference()
    elapsed("13-14")
    priors = phase_priors(fu, card, key2, resume)
    elapsed("15")
    segments = phase_segments(fu, card)
    elapsed("16")
    chains17 = phase_chains(fu, card)
    elapsed("17")
    mnist = phase_mnist(fu, card)
    elapsed("18")
    preact = phase_preact(fu, card)
    elapsed("19")
    sweep = phase_sweep(fu, card)
    elapsed("20")
    mesh_dirs = sweep.pop("sweep_dirs")
    slice12 = phase_slice12(fu, card)
    elapsed("21")
    mesh = phase_mesh(fu, card, mesh_dirs)
    elapsed("22")
    slice14 = phase_slice14(card, cli)
    elapsed("23")
    slice15 = phase_slice15(fu, card, mesh_dirs)
    elapsed("24")
    slice16, split = phase_slice16(fu, card)
    elapsed("25")
    check("jax" not in sys.modules and "bnn_priors_tpu" not in sys.modules,
          "JAX was imported")

    print(json.dumps({"kernels": [
        kernel_record("fused_langevin_update", launches, timing, cli, {
            "resume_launches": resume["single"]["launches"],
            "resume_expected": resume["single"]["expected"],
            "hmc_launches": {k: v["launches"] for k, v in hmc.items()},
            "hmc_expected": {k: v["expected"] for k, v in hmc.items()},
            "priors_launches": priors["single"],
            "priors_expected": priors["single_expected"],
            **mnist["single"], **preact["single"], **slice12,
            **slice14, **slice15, **slice16}),
        kernel_record("fused_langevin_update_chains", chain_launches,
                      chain_timing, cli_chains, {
                          "resume_launches": resume["chains"]["launches"],
                          "resume_expected": resume["chains"]["expected"],
                          "priors_launches": priors["chains"],
                          "priors_expected": priors["chains_expected"],
                          "chain_paths_launches": chains17["launches"],
                          "chain_paths_expected": chains17["expected"],
                          **mnist["chains"], **preact["chains"], **sweep,
                          **mesh}),
        segments_record("fused_langevin_update_segments", segments, 1),
        segments_record("fused_langevin_update_segments_chains", segments,
                        K_CHAINS),
        split_record(split_launches, cli["split_launches"], split),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
