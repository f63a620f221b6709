"""Training script for BNN experiments (counterpart of
`experiments/train_bnn.py`), with the same sacred-style CLI, config names,
defaults and run directories:

    python -m bnn_priors_tpu_torch.experiments.train_bnn with \\
        data=fake_cifar10 model=googleresnet inference=VerletSGLDReject \\
        reject_samples=True warmup=45 burnin=0 skip=1 n_samples=300 \\
        cycles=60 lr=5e-4 momentum=0.994 batch_size=128 temperature=1.0

With no `data`/`model` given it runs the JAX CLI's defaults: GGMC with
exact M-H (`VerletSGLDReject`) on MNIST's IDX files under
`$BNN_PRIORS_DATA/MNIST` with the CNN `classificationconvnet` of width 50
and depth 3. `data=UCI_<name> model=densenet` runs dense regression on the
bundled splits, with the sampled `noise_std`.

Artifacts per run dir (reference contract): config.json, run.json,
metrics.h5, samples.pt (HDF5). The result dict is the final evaluation.
With `n_chains=K` the K chains run as one
bank on the card, each with a run dir of its own; the parent run records
the pooled ensemble. SGLD, VerletSGLD and OurHMC then run the plain chain
loop (`parallel.MultiChainRunner`), the other four the exact-gradient one
(`MultiChainRunnerReject`), as the JAX CLI dispatches them;
`chain_group_size` splits the bank into dispatch groups and `eval_skip`
sets the chains' test-pass cadence (a single chain evaluates every epoch,
as in the JAX CLI). The run goes on the card (`device=cuda`, the default)
or the CPU (`device=cpu`), in float32 with TF32 off.

`inference` is any of the JAX CLI's seven: SGLD, VerletSGLD, OurHMC (HMC
without M-H), and the exact-gradient runners SGLDReject, VerletSGLDReject,
HMCReject and HMC (classical HMC: HMCReject with the batch size N and an
M-H test). `checkpoint_every=E` writes the whole chain state to the run
dir every E epochs (`chain.ckpt.npz`, or `chains.ckpt.npz` for K chains),
and `resume_from=<that file>` continues such a run, bit for bit, in a
fresh run dir.

The keys the port does not honour yet raise NotImplementedError naming
their ROADMAP item (`UNPORTED`). `pipeline` is accepted: the port's loop is
synchronous and computes the same thing.
"""
import copy
import json
import sys
import time
from pathlib import Path

from ..exp.config import RunDirectory, parse_cli

REPO = Path(__file__).resolve().parents[2]

DEFAULTS = dict(
    data="mnist",                  # dataset name (see exp_utils.get_data)
    inference="VerletSGLDReject",  # GGMC from arXiv:2102.01691 by default
    model="classificationconvnet",
    width=50,
    depth=3,
    weight_prior="gaussian",
    bias_prior="gaussian",
    weight_loc=0.0,
    weight_scale=2.0 ** 0.5,
    bias_loc=0.0,
    bias_scale=1.0,
    weight_prior_params={},
    bias_prior_params={},
    n_samples=300,                 # total posterior samples
    cycles=60,                     # cosine LR cycles
    burnin=0,                      # descent epochs per cycle (T=0)
    warmup=45,                     # warmup epochs per cycle
    skip=1,                        # sample thinning
    metrics_skip=10,
    eval_skip=1,                   # chains: test-eval every N epochs (0=off)
    pipeline=True,                 # accepted; the port's loop is synchronous
    skip_first=50,                 # samples discarded at evaluation
    temperature=1.0,
    sampling_decay="cosine",
    momentum=0.994,
    precond_update=1,
    lr=5e-4,
    init_method="he",              # he | he_uniform | he_zerobias | prior
    load_samples=None,             # warm start from a previous sample bank
    batch_size=128,
    reject_samples=False,
    batchnorm=True,
    device="cuda",                 # cuda | cpu
    matmul_precision="bfloat16",   # the JAX default; the port runs float32
    compute_dtype=None,            # e.g. 'bfloat16': mixed-precision net
                                   # forward/backward (reductions stay f32);
                                   # M-H boundary grads always full precision
    save_samples=True,
    checkpoint_every=None,
    resume_from=None,
    profile_dir=None,
    progressbar=True,              # one line an epoch on stderr
    seed=0,
    n_chains=1,                    # >1: the chain axis, one run dir a chain
    n_devices=None,
    chain_group_size=None,
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    log_dir=str(REPO / "logs"),
)

# key -> (test that the value is ported, the ROADMAP item that ports it)
UNPORTED = {
    "profile_dir": (lambda v: v is None, "item 6 (profiling)"),
    "n_devices": (lambda v: v is None or int(v) <= 1,
                  "item 8 (the mesh and multi-process paths)"),
    "coordinator_address": (lambda v: v is None,
                            "item 8 (the mesh and multi-process paths)"),
    "num_processes": (lambda v: v is None or int(v) <= 1,
                      "item 8 (the mesh and multi-process paths)"),
    "process_id": (lambda v: v is None,
                   "item 8 (the mesh and multi-process paths)"),
    "matmul_precision": (lambda v: v in ("bfloat16", "float32"),
                         "item 9 (reduced-precision matmuls on the card)"),
}
RUNNERS = ("SGLD", "VerletSGLD", "OurHMC", "SGLDReject",
           "VerletSGLDReject", "HMCReject", "HMC")


def check_device(device):
    "the port runs on 'cuda' (raises without a card) or 'cpu'"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: the port runs on 'cuda' (the "
                         "default) or 'cpu'")
    from ..device import resolve_device
    resolve_device(device)


def check_config(cfg, unported=UNPORTED):
    """raise for what the port cannot run: a non-default value of an
    unported key"""
    for key, (ok, item) in unported.items():
        if not ok(cfg[key]):
            raise NotImplementedError(
                f"{key}={cfg[key]!r} is not ported yet (ROADMAP {item})")
    inference = cfg["inference"]
    assert inference in RUNNERS, f"unknown inference={inference!r}"


def set_float32(device):
    "float32 means float32: TF32 off for matmuls and cuDNN convolutions"
    import torch
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def main(cfg):
    check_config(cfg)
    check_device(cfg["device"])
    set_float32(cfg["device"])
    run = RunDirectory(cfg["log_dir"], cfg)
    try:
        return _main_inner(cfg, run)
    except Exception as e:  # noqa: BLE001 — record FAILED status in run.json
        run.fail(e)
        raise


def model_of(cfg, device, seed=0, train=None):
    """the config's model with its priors and their params, its input and
    output widths from the training data `train` = (x, y), its `width` and
    `depth` (train_bnn.py:131-135); `googleresnet` and
    `correlatedgoogleresnet` are ResNet-20 on 10 classes whatever these
    are, and need no data"""
    from .. import exp_utils
    x_train, y_train = train if train is not None else (None, None)
    return exp_utils.get_model(
        cfg["model"], weight_prior=cfg["weight_prior"],
        weight_loc=cfg["weight_loc"], weight_scale=cfg["weight_scale"],
        bias_prior=cfg["bias_prior"], bias_loc=cfg["bias_loc"],
        bias_scale=cfg["bias_scale"], batchnorm=cfg["batchnorm"],
        weight_prior_params=cfg["weight_prior_params"],
        bias_prior_params=cfg["bias_prior_params"], x_train=x_train,
        y_train=y_train, width=cfg["width"], depth=cfg["depth"],
        device=device, seed=seed)


def _init_model(cfg, model, generator):
    "the configured initializer, in place (train_bnn.py:139-149)"
    from .. import exp_utils
    init = {"he": exp_utils.he_initialize,
            "he_uniform": exp_utils.he_uniform_initialize,
            "he_zerobias": exp_utils.he_zerobias_initialize,
            "prior": lambda m, g: m}.get(cfg["init_method"])
    if init is None:
        raise ValueError(f"unknown init_method={cfg['init_method']}")
    return init(model, generator)


def _warm_start(model, path):
    "each state_dict entry from the bank's last sample (train_bnn.py:150-165)"
    import torch

    from ..io import load_samples
    bank = load_samples(path, keep_steps=False)
    ours = model.state_dict()
    loaded = 0
    with torch.no_grad():
        for k, v in bank.items():
            if k in ours and tuple(ours[k].shape) == v.shape[1:]:
                ours[k].copy_(torch.as_tensor(v[-1]).to(ours[k].dtype))
                loaded += 1
            else:
                print(f"warning: ignoring loaded key {k}", file=sys.stderr)
    print(f"warm start: loaded {loaded} arrays", file=sys.stderr)


def checkpoint_path(cfg, run, name):
    """the run dir's checkpoint file, registered as an artifact only when
    `checkpoint_every` writes one (train_bnn.py:217-218,378-379)"""
    return run.artifact(name) if cfg["checkpoint_every"] else None


def _compute_dtype(name):
    import torch
    return None if name is None else getattr(torch, name)


def _main_inner(cfg, run):
    import torch

    from .. import exp_utils, inference
    from ..evaluate import evaluate_model
    from ..io import HDF5Metrics, HDF5ModelSaver

    device = cfg["device"]
    # one host generator for the run's seeds (explicit, never global)
    gen = torch.Generator().manual_seed(int(cfg["seed"]))
    init_seed, he_seed, run_seed = (
        int(torch.randint(0, 2 ** 62, (), generator=gen)) for _ in range(3))

    # -- data --------------------------------------------------------------
    data = exp_utils.get_data_from_config(cfg, device=device)
    x_train, y_train = data.norm.train
    x_test, y_test = data.norm.test

    # -- model -------------------------------------------------------------
    model = model_of(cfg, device, seed=init_seed, train=(x_train, y_train))
    if cfg["load_samples"] is None:
        _init_model(cfg, model, torch.Generator().manual_seed(he_seed))
    else:
        _warm_start(model, cfg["load_samples"])

    augment_fn = getattr(type(data), "augment_fn", None)
    assert (cfg["n_samples"] * cfg["skip"]) % cfg["cycles"] == 0
    sample_epochs = cfg["n_samples"] * cfg["skip"] // cfg["cycles"]
    epochs_per_cycle = cfg["warmup"] + cfg["burnin"] + sample_epochs
    schedule = dict(epochs_per_cycle=epochs_per_cycle,
                    warmup_epochs=cfg["warmup"], sample_epochs=sample_epochs,
                    learning_rate=cfg["lr"], skip=cfg["skip"],
                    metrics_skip=cfg["metrics_skip"],
                    sampling_decay=cfg["sampling_decay"], cycles=cfg["cycles"],
                    momentum=cfg["momentum"],
                    precond_update=cfg["precond_update"],
                    batch_size=cfg["batch_size"], augment_fn=augment_fn,
                    seed=run_seed,
                    compute_dtype=_compute_dtype(cfg["compute_dtype"]),
                    device=device)

    if int(cfg["n_chains"]) > 1:
        return _run_multichain(cfg, run, model, x_train, y_train, x_test,
                               y_test, schedule)

    # -- runner ------------------------------------------------------------
    runner_class = {
        "SGLD": inference.SGLDRunner,
        "VerletSGLD": inference.VerletSGLDRunner,
        "OurHMC": inference.HMCRunner,
        "HMC": inference.HMCRunnerReject,
        "VerletSGLDReject": inference.VerletSGLDRunnerReject,
        "HMCReject": inference.HMCRunnerReject,
        "SGLDReject": inference.SGLDRunnerReject,
    }[cfg["inference"]]
    if cfg["inference"] == "HMC":
        # classical HMC: every gradient is the exact full-data one
        # (train_bnn.py:172-189)
        schedule["batch_size"] = int(x_train.shape[0])
        assert cfg["temperature"] == 1.0 and cfg["burnin"] == 0, \
            "classical HMC requires temperature=1 and no descent epochs"
    with HDF5Metrics(run.artifact("metrics.h5")) as metrics_saver:
        saver_path = run.artifact("samples.pt") if cfg["save_samples"] else None
        model_saver = HDF5ModelSaver(saver_path) if saver_path else None
        try:
            runner = runner_class(
                model, (x_train, y_train), (x_test, y_test),
                temperature=cfg["temperature"], metrics_saver=metrics_saver,
                model_saver=model_saver,
                reject_samples=(cfg["reject_samples"]
                                or cfg["inference"] == "HMC"),
                checkpoint_path=checkpoint_path(cfg, run, "chain.ckpt.npz"),
                checkpoint_every=cfg["checkpoint_every"], **schedule)
            runner.run(progressbar=cfg["progressbar"],
                       resume_from=cfg["resume_from"])
            samples = runner.get_samples()
        finally:
            if model_saver is not None:
                model_saver.close()

    n_saved = min(v.shape[0] for v in samples.values())
    skip_first = cfg["skip_first"]
    if skip_first >= n_saved:
        # keep at least the final sample (tiny runs save < skip_first)
        print(f"WARNING: skip_first={skip_first} >= {n_saved} saved samples;"
              f" clamping to {n_saved - 1}")
        skip_first = n_saved - 1
    samples = {k: v[skip_first:] for k, v in samples.items()}
    result = evaluate_model(model, (x_test, y_test), samples,
                            likelihood_eval=True, accuracy_eval=True,
                            calibration_eval=False)
    run.finish(result)
    print(json.dumps(result))
    return result


# n_chains > 1: each inference's runner and kernel (train_bnn.py:259-264)
REJECT_KERNELS = {"VerletSGLDReject": "VerletSGLD", "HMCReject": "HMC",
                  "SGLDReject": "SGLD", "HMC": "HMC"}
# OurHMC is the HMC kernel without M-H: the plain loop refreshes momenta at
# the single-chain HMCRunner's trajectory boundaries
PLAIN_KERNELS = {"SGLD": "SGLD", "VerletSGLD": "VerletSGLD",
                 "OurHMC": "HMC"}


def _run_multichain(cfg, run, model, x_train, y_train, x_test, y_test,
                    schedule):
    """n_chains > 1 (train_bnn.py:246-436): K chains in one bank, of
    `MultiChainRunnerReject` or `MultiChainRunner` with the inference's
    kernel. One reference-compatible run dir a chain (config.json /
    samples.pt / metrics.h5 / run.json), so `eval_bnn` evaluates each chain
    dir unchanged; the parent run records the pooled all-chain ensemble."""
    import numpy as np

    from ..evaluate import evaluate_model
    from ..io import HDF5Metrics, HDF5ModelSaver, load_samples
    from ..parallel import MultiChainRunner, MultiChainRunnerReject

    n_chains = int(cfg["n_chains"])
    is_reject = cfg["inference"] in REJECT_KERNELS
    if cfg["inference"] == "HMC":  # classical HMC: exact full-data grads
        batch_size = schedule["batch_size"] = int(x_train.shape[0])
        assert cfg["temperature"] == 1.0 and cfg["burnin"] == 0
        # the JAX CLI's memory guard (train_bnn.py:268-281): batch=N means
        # every chain holds full-dataset activations a step
        est_gb = (n_chains * batch_size *
                  float(np.prod(x_train.shape[1:])) * 4 / 1e9)
        assert est_gb < 2.0, (
            f"inference=HMC with n_chains={n_chains} needs full-batch "
            f"gradients: >= {est_gb:.1f} GB of input activations alone "
            f"(batch={batch_size}/chain) would not fit. Use "
            "inference=HMCReject (minibatch-scanned exact gradients, "
            "constant memory) or fewer chains/smaller data.")
    loaded = {k: v.detach().clone() for k, v in model.params().items()}

    # per-chain initial parameters: warm starts replicate the loaded
    # sample; otherwise each chain gets an independent init_method draw
    def init_params_fn(c, generator):
        if cfg["load_samples"] is not None:
            return loaded
        m = copy.deepcopy(model).init(generator)
        return _init_model(cfg, m, generator).params()

    chain_runs, savers, msavers = {}, [], []
    for c in range(n_chains):
        crun = RunDirectory(cfg["log_dir"], {**cfg, "chain_index": c})
        chain_runs[c] = crun
        savers.append(HDF5ModelSaver(crun.artifact("samples.pt"))
                      if cfg["save_samples"] else None)
        msavers.append(HDF5Metrics(crun.artifact("metrics.h5")))
    if not cfg["save_samples"]:
        savers = []

    t0 = time.perf_counter()

    def _phase(name):
        print(f"[timing] {name}: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

    extra = {}
    if is_reject:
        extra["reject_samples"] = bool(cfg["reject_samples"]
                                       or cfg["inference"] == "HMC")
    try:
        runner = (MultiChainRunnerReject if is_reject else MultiChainRunner)(
            model, (x_train, y_train), n_chains,
            temperatures=float(cfg["temperature"]),
            kernel=(REJECT_KERNELS.get(cfg["inference"])
                    or PLAIN_KERNELS[cfg["inference"]]),
            init_params_fn=init_params_fn, test_data=(x_test, y_test),
            model_savers=savers or None, metrics_savers=msavers,
            chain_group_size=cfg["chain_group_size"],
            eval_skip=cfg["eval_skip"], **schedule, **extra)
        _phase("runner constructed (chain init + data upload)")
        runner.run(progressbar=cfg["progressbar"],
                   checkpoint_path=checkpoint_path(cfg, run,
                                                   "chains.ckpt.npz"),
                   checkpoint_every=cfg["checkpoint_every"],
                   resume_from=cfg["resume_from"])
    finally:
        for s in savers + msavers:
            if s is not None:
                s.close()

    _phase("training epochs done")
    results, pooled_banks = [], []
    for c, crun in sorted(chain_runs.items()):
        if c in runner.nan_chains:
            res = {"diverged": True, "chain_index": c}
            crun.finish(res)
            results.append(res)
            continue
        if savers:
            bank = load_samples(str(crun.dir / "samples.pt"))
        else:
            bank = runner.chain_samples(c)
        n_saved = min(v.shape[0] for v in bank.values())
        skip_first = min(cfg["skip_first"], n_saved - 1)
        bank = {k: np.asarray(v)[skip_first:] for k, v in bank.items()}
        pooled_banks.append(bank)
        res = evaluate_model(model, (x_test, y_test), bank,
                             likelihood_eval=True, accuracy_eval=True,
                             calibration_eval=False)
        res["chain_index"] = c
        if extra.get("reject_samples"):
            res["acceptance"] = float(runner.acceptance_rates()[c])
        crun.finish(res)
        results.append(res)
        print(json.dumps(res))

    pooled = {}
    if pooled_banks:
        all_bank = {k: np.concatenate([b[k] for b in pooled_banks])
                    for k in pooled_banks[0]}
        pooled = evaluate_model(model, (x_test, y_test), all_bank,
                                likelihood_eval=True, accuracy_eval=True,
                                calibration_eval=False)
    _phase("final per-chain + pooled evaluation done")
    summary = {"chains": results, "pooled": pooled,
               "chain_dirs": [str(chain_runs[c].dir)
                              for c in sorted(chain_runs)],
               "n_diverged": len(runner.nan_chains)}
    run.finish(summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(parse_cli(DEFAULTS))
