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
or the CPU (`device=cpu`), in float32 with TF32 off, but for the
single-chain runner's convolutions and products on the card:
`matmul_precision` (the JAX key, default `bfloat16`: bf16 operands with
float32 accumulation; `float32`, `tensorfloat32`, their JAX aliases and
`F16_F16_F32`, see `precision.py`) is the runner's, as the JAX CLI passes
it (train_bnn.py:220-221). On the CPU the key is ignored, as JAX's CPU
backend ignores it, and the chain axis does not receive it; a value the
card cannot honour raises ValueError before any run dir.

`profile_dir=<dir>` writes a torch.profiler trace (Chrome trace JSON) of
the first steps of epoch 1 of a single-chain run there
(`inference.runner.profiled`); with `n_chains>1` it is accepted and takes
no trace, as the JAX CLI routes the chain axis away before it passes
`profile_dir` (train_bnn.py:167,219).

`inference` is any of the JAX CLI's seven: SGLD, VerletSGLD, OurHMC (HMC
without M-H), and the exact-gradient runners SGLDReject, VerletSGLDReject,
HMCReject and HMC (classical HMC: HMCReject with the batch size N and an
M-H test). `checkpoint_every=E` writes the whole chain state to the run
dir every E epochs (`chain.ckpt.npz`, or `chains.ckpt.npz` for K chains),
and `resume_from=<that file>` continues such a run, bit for bit, in a
fresh run dir.

The chain axis across devices and processes, as in the JAX CLI:
`n_devices=D` (D > 1) splits the K chains over the first D devices of a
`chains` mesh (`parallel.distributed.global_chains_mesh`; more devices
than there are raises, naming both counts, before any run dir), and
`num_processes=N process_id=<rank> coordinator_address=host:port` runs the
same command as one program over N processes (`torch.distributed` over
gloo), each making run dirs and savers for its own chains only and
evaluating them, its pooled result over its own chains. `pipeline=True`
(the default) drains each epoch's host work on a thread behind the next
epoch's dispatch (`parallel.MultiChainRunner`); the single-chain runners
have no pipeline, as in the JAX CLI.

The Rao-Blackwellized models (`raobdensenet`, `raob_linear`) raise
ValueError: their likelihood is the whole training set's, with whole-set
features that the minibatch accuracy cannot take, and the JAX CLI fails
on them too (ROADMAP §3).
"""
import copy
import json
import sys
import time
from pathlib import Path

from ..exp.config import RunDirectory, parse_cli
from ..parallel import distributed

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
    pipeline=True,     # one-epoch-deep dispatch pipeline (False = sync debug)
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
    matmul_precision="bfloat16",   # conv/matmul operands on the card
                                   # (precision.py); ignored on the CPU
    compute_dtype=None,            # e.g. 'bfloat16': mixed-precision net
                                   # forward/backward (reductions stay f32);
                                   # M-H boundary grads always full precision
    save_samples=True,
    checkpoint_every=None,
    resume_from=None,
    profile_dir=None,              # torch.profiler trace dir (epoch 1)
    progressbar=True,              # one line an epoch on stderr
    seed=0,
    n_chains=1,                    # >1: the chain axis, one run dir a chain
    n_devices=None,                # chains mesh axis size (None = 1 device)
    chain_group_size=None,
    log_dir=str(REPO / "logs"),
)
# multi-process: the same command in every process with
# num_processes=N process_id=<rank> coordinator_address=host:port
distributed.add_distributed_config(DEFAULTS)

RUNNERS = ("SGLD", "VerletSGLD", "OurHMC", "SGLDReject",
           "VerletSGLDReject", "HMCReject", "HMC")
# models whose likelihood the runners cannot take (models/raob.py)
RAOB_MODELS = ("raobdensenet", "raob_linear")


def check_device(device):
    "the port runs on 'cuda' (raises without a card) or 'cpu'"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: the port runs on 'cuda' (the "
                         "default) or 'cpu'")
    from ..device import resolve_device
    resolve_device(device)


def check_model(model):
    """raise for a Rao-Blackwellized model: its log-likelihood is the whole
    training set's marginal likelihood and its features f are the whole
    set's, which the runners' minibatch accuracy (f − y) cannot take; the
    JAX CLI raises on both names too (raob.py:51-72, base.py:272-274)"""
    if model in RAOB_MODELS:
        raise ValueError(
            f"model={model!r}: the RaoB likelihood returns the whole "
            "training set's features, which the minibatch accuracy cannot "
            "take (as in the JAX CLI); use the model as a library "
            "(models.RaoBRegressionModel)")


def check_config(cfg):
    """raise for what the port cannot run: a `matmul_precision` the card
    cannot honour (ValueError, `precision.mode_of`), a RaoB model"""
    from ..precision import mode_of
    mode_of(cfg["matmul_precision"])
    check_model(cfg["model"])
    inference = cfg["inference"]
    assert inference in RUNNERS, f"unknown inference={inference!r}"


def set_float32(device):
    "float32 means float32: TF32 off for matmuls and cuDNN convolutions"
    import torch
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def chain_mesh(n_devices, n_chains, device):
    """the `chains` mesh of `n_devices` > 1 (train_bnn.py:316-326) and the
    chains this process holds under it, else (None, None); refuses more
    devices than there are, or a split that is not even, before any run
    dir"""
    if int(n_devices or 1) <= 1:
        return None, None
    mesh = distributed.global_chains_mesh(int(n_devices), device)
    return mesh, distributed.local_chain_indices_for_mesh(mesh, n_chains)


def main(cfg):
    check_config(cfg)
    check_device(cfg["device"])
    # multi-process: before the mesh, which lists every rank's devices
    distributed.initialize_from_config(cfg)
    set_float32(cfg["device"])
    n_chains = int(cfg["n_chains"])
    if n_chains == 1 and int(cfg["n_devices"] or 1) > 1:
        raise ValueError(f"n_devices={cfg['n_devices']} splits the chain "
                         "axis: it needs n_chains > 1")
    split = chain_mesh(cfg["n_devices"], n_chains, cfg["device"])
    run = RunDirectory(cfg["log_dir"], cfg)
    try:
        return _main_inner(cfg, run, split)
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
            "prior": _prior_draw}.get(cfg["init_method"])
    if init is None:
        raise ValueError(f"unknown init_method={cfg['init_method']}")
    return init(model, generator)


def _prior_draw(model, generator):
    "the model as `get_model` drew it from its priors"
    if not model.drawable():
        raise NotImplementedError(
            "init_method=prior: the model's priors cannot all be drawn (a "
            "data-driven ResNet-18 with mean_covs fits), as in the reference "
            "(ROADMAP §3)")
    return model


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


def _main_inner(cfg, run, split=(None, None)):
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
                               y_test, schedule, split)

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
                checkpoint_every=cfg["checkpoint_every"],
                profile_dir=cfg["profile_dir"],
                matmul_precision=(cfg["matmul_precision"]
                                  if device != "cpu" else None),
                **schedule)
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


class ChainRuns:
    """one reference-compatible run dir a chain (config.json / samples.pt /
    metrics.h5 / run.json), each with its sample saver (with
    `save_samples`) and metrics saver, made up front so that every chain's
    bank and series stream to disk during the run; `eval_bnn` evaluates
    each dir as it evaluates a single-chain run (train_bnn.py:294-318,
    sweep_tempering.py:131-154). With `local` (the chains of this process
    in a multi-process run) the other chains get no dir and None savers."""

    def __init__(self, log_dir, chain_cfgs, save_samples, local=None):
        from ..io import HDF5Metrics, HDF5ModelSaver
        self.runs, self.savers, self.msavers = [], [], []
        local = set(range(len(chain_cfgs)) if local is None else local)
        for c, chain_cfg in enumerate(chain_cfgs):
            if c not in local:
                self.runs.append(None)
                self.savers.append(None)
                self.msavers.append(None)
                continue
            run = RunDirectory(log_dir, chain_cfg)
            self.runs.append(run)
            self.savers.append(HDF5ModelSaver(run.artifact("samples.pt"))
                               if save_samples else None)
            self.msavers.append(HDF5Metrics(run.artifact("metrics.h5")))
        if not save_samples:
            self.savers = []
        self.local = sorted(local)
        self._open = set(local)

    def close(self, start=0, stop=None):
        """close the savers of chains start..stop-1 (default: all) that are
        still open; their banks and series are on disk after"""
        for c in sorted(self._open & set(range(start, stop or
                                               len(self.runs)))):
            self._open.discard(c)
            for savers in (self.savers, self.msavers):
                if savers and savers[c] is not None:
                    savers[c].close()

    def bank(self, runner, c, row, skip_first):
        """chain c's samples (its file, else row `row` of the runner's
        bank) without the first `skip_first`, capped to keep the last one;
        None if the chain saved none"""
        import numpy as np

        from ..io import load_samples
        bank = (load_samples(str(self.runs[c].dir / "samples.pt"))
                if self.savers else runner.chain_samples(row))
        n_saved = min((v.shape[0] for v in bank.values()), default=0)
        if n_saved == 0:
            return None
        skip_first = min(skip_first, n_saved - 1)
        return {k: np.asarray(v)[skip_first:] for k, v in bank.items()}


def _run_multichain(cfg, run, model, x_train, y_train, x_test, y_test,
                    schedule, split=(None, None)):
    """n_chains > 1 (train_bnn.py:246-436): K chains in one bank, of
    `MultiChainRunnerReject` or `MultiChainRunner` with the inference's
    kernel, over `split` = (the mesh, this process's chains) when there
    is one (`chain_mesh`). One reference-compatible run dir a chain of
    this process (`ChainRuns`), so `eval_bnn` evaluates each chain dir
    unchanged; the parent run records the pooled ensemble of this
    process's chains."""
    import numpy as np

    from ..evaluate import evaluate_model
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

    mesh, local = split
    runs = ChainRuns(cfg["log_dir"], [{**cfg, "chain_index": c}
                                      for c in range(n_chains)],
                     cfg["save_samples"], local)
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
            model_savers=runs.savers or None, metrics_savers=runs.msavers,
            chain_group_size=cfg["chain_group_size"],
            eval_skip=cfg["eval_skip"], mesh=mesh, pipeline=cfg["pipeline"],
            **schedule, **extra)
        _phase("runner constructed (chain init + data upload)")
        runner.run(progressbar=cfg["progressbar"],
                   checkpoint_path=checkpoint_path(cfg, run,
                                                   "chains.ckpt.npz"),
                   checkpoint_every=cfg["checkpoint_every"],
                   resume_from=cfg["resume_from"])
    finally:
        runs.close()

    _phase("training epochs done")
    results, pooled_banks = [], []
    for c in runs.local:
        crun = runs.runs[c]
        if c in runner.nan_chains:
            res = {"diverged": True, "chain_index": c}
            crun.finish(res)
            results.append(res)
            continue
        bank = runs.bank(runner, c, c, cfg["skip_first"])
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
               "chain_dirs": [str(runs.runs[c].dir) for c in runs.local],
               "n_diverged": len(runner.nan_chains)}
    run.finish(summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(parse_cli(DEFAULTS))
