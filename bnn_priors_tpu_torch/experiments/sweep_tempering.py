"""Tempering sweep (counterpart of `experiments/sweep_tempering.py`): a
prior's whole temperatures × replicates grid runs as one bank of chains on
the card, each chain with a run directory of its own, so `eval_bnn`
evaluates each as it evaluates a `train_bnn` run:

    python -m bnn_priors_tpu_torch.experiments.sweep_tempering with \\
        data=cifar10 model=googleresnet weight_prior=gaussian \\
        inference=VerletSGLDReject compute_dtype=bfloat16 \\
        temperatures='[0.001,0.01,0.03,0.1,0.3,1.0]' replicates=5

Chain c is replicate r at temperature t, c = r·len(temperatures) + t; its
config adds `temperature`, `replicate`, `chain_index`, `n_chains` and
`temperatures` (sweep_tempering.py:131-157). Every chain starts from its
own draw of the priors. The reject inferences (VerletSGLDReject,
HMCReject, SGLDReject) run `MultiChainRunnerReject` with the M-H test on,
the others `MultiChainRunner` of the named kernel; each chain streams its
samples and metrics to its run dir, and after the run is evaluated on its
bank without its first `skip_first` samples (capped to keep the last),
with its acceptance rate for the reject inferences, and prints one JSON
line.

`max_chains_per_program=M` splits the bank into parts of at most M chains
that run one after another, each part's state freed before the next; None
(the default) runs one bank. Part p's runner takes the p-th 62-bit draw of
a generator seeded with `seed` (one part: the first). Resuming a split
sweep is refused. The JAX default of 60 chains a part is a TPU
transport's watchdog limit and is not carried over: on the card the bound
is memory.

The chain axis over devices and processes, as in the JAX sweep:
`n_devices` is the size of the `chains` mesh (None: every device, every
rank's when there are several; 1: no mesh), which every part's chains
split over evenly (sweep_tempering.py:125-137, 193-195), and
`num_processes=N process_id=<rank> coordinator_address=host:port` runs one
program over N processes, each making run dirs and savers for its own
chains only (a split bank is refused there). `pipeline=True` (the default)
drains each epoch's host work on a thread behind the next epoch's
dispatch. A
`synthetic.<base>.<prior>` dataset is regenerated from the config's seed
(`exp_utils.get_data_from_config`), so `eval_bnn` scores the labels the
chains trained on; `raobdensenet` and `raob_linear` raise ValueError, as
in `train_bnn`.
"""
import json
import sys
from pathlib import Path

from ..exp.config import parse_cli
from ..parallel import distributed
from .train_bnn import (REPO, ChainRuns, _compute_dtype, chain_mesh,
                        check_device, check_model, model_of, set_float32)

DEFAULTS = dict(
    data="cifar10",
    model="googleresnet",
    compute_dtype=None,   # 'bfloat16': mixed-precision minibatch steps
    width=50,
    depth=3,
    weight_prior="gaussian",
    bias_prior="gaussian",
    weight_loc=0.0,
    weight_scale=1.41,
    bias_loc=0.0,
    bias_scale=1.0,
    weight_prior_params={},
    bias_prior_params={},
    temperatures=[0.001, 0.01, 0.03, 0.1, 0.3, 1.0],
    replicates=5,
    inference="VerletSGLD",  # SGLD | VerletSGLD | VerletSGLDReject |
                             # HMCReject | SGLDReject (exact-gradient M-H)
    n_samples=300,
    cycles=60,
    burnin=0,
    warmup=45,
    skip=1,
    skip_first=50,
    metrics_skip=10,   # per-chain step-granular metrics cadence
    eval_skip=1,       # test-eval every N epochs (0 = off; final epoch always)
    pipeline=True,     # one-epoch-deep dispatch pipeline (False = sync debug)
    lr=0.01,
    momentum=0.994,
    precond_update=1,
    batch_size=128,
    batchnorm=True,
    n_devices=None,                # chains mesh axis size (None = all)
    max_chains_per_program=None,   # None: one bank; M: parts of <= M chains
    chain_group_size=None,         # chains a dispatch group (None: one)
    checkpoint_every=None,         # epochs between full chain-state snapshots
    resume_from=None,              # checkpoint path: continue bit for bit
    device="cuda",                 # cuda | cpu
    seed=0,
    save_samples=True,
    progressbar=True,
    log_dir=str(REPO / "logs_sweep"),
)
# multi-process: the same command in every process with
# num_processes=N process_id=<rank> coordinator_address=host:port
distributed.add_distributed_config(DEFAULTS)

# the exact-gradient M-H inferences and their kernels
# (sweep_tempering.py:169-172); any other runs the plain loop
REJECT_KERNELS = {"VerletSGLDReject": "VerletSGLD", "HMCReject": "HMC",
                  "SGLDReject": "SGLD"}


def part_bounds(n_chains, max_chains):
    """(start, stop) chains of each part: as even as possible, at most
    `max_chains` each (None or 0: one part)"""
    import numpy as np
    max_chains = int(max_chains or 0) or n_chains
    n_parts = -(-n_chains // max_chains)
    bounds = np.linspace(0, n_chains, n_parts + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_parts)]


def main(cfg):
    check_model(cfg["model"])
    check_device(cfg["device"])
    # multi-process: before the mesh, which lists every rank's devices
    distributed.initialize_from_config(cfg)
    set_float32(cfg["device"])
    import torch

    from .. import exp_utils
    from ..evaluate import evaluate_model
    from ..parallel import MultiChainRunner, MultiChainRunnerReject

    n_chains = len(cfg["temperatures"]) * int(cfg["replicates"])
    # None: every device (every rank's)
    mesh, local = chain_mesh(
        cfg["n_devices"] or len(distributed.global_positions(cfg["device"])),
        n_chains, cfg["device"])

    device = cfg["device"]
    # seeded, so eval_bnn's re-hydration scores the same toy points
    data = exp_utils.get_data_from_config(cfg, device=device)
    x_train, y_train = data.norm.train
    test = data.norm.test
    model = model_of(cfg, device, seed=int(cfg["seed"]),
                     train=(x_train, y_train))

    temps = [float(t) for t in cfg["temperatures"]]
    reps = int(cfg["replicates"])
    assert temps and reps >= 1, (
        f"need a non-empty temperature grid and replicates>=1, got "
        f"temperatures={temps} replicates={reps}")
    chain_temps = temps * reps  # chain c = r * len(temps) + t
    assert (cfg["n_samples"] * cfg["skip"]) % cfg["cycles"] == 0
    sample_epochs = cfg["n_samples"] * cfg["skip"] // cfg["cycles"]
    is_reject = cfg["inference"] in REJECT_KERNELS
    runner_cls = MultiChainRunnerReject if is_reject else MultiChainRunner
    parts = part_bounds(n_chains, cfg["max_chains_per_program"])
    if len(parts) > 1:
        if distributed.is_multiprocess():
            raise ValueError("a bank split into parts "
                             "(max_chains_per_program) runs in one process")
        for lo, hi in parts if mesh is not None else ():
            mesh.chain_ranges(hi - lo)  # each part splits evenly
        assert cfg["resume_from"] is None, (
            "resume of a partitioned sweep is not supported; raise "
            "max_chains_per_program or resume each part manually")
        print(f"# {n_chains} chains as {len(parts)} sequential programs of "
              f"<= {parts[0][1] - parts[0][0]}", file=sys.stderr)
    gen = torch.Generator().manual_seed(int(cfg["seed"]))
    part_seeds = [int(torch.randint(0, 2 ** 62, (), generator=gen))
                  for _ in parts]

    runs = ChainRuns(cfg["log_dir"], [
        {**cfg, "temperature": chain_temps[c], "replicate": c // len(temps),
         "chain_index": c, "n_chains": n_chains, "temperatures": temps}
        for c in range(n_chains)], cfg["save_samples"], local)
    results = {}
    try:
        for p, (lo, hi) in enumerate(parts):
            runner = runner_cls(
                model, (x_train, y_train), hi - lo,
                temperatures=chain_temps[lo:hi],
                kernel=REJECT_KERNELS.get(cfg["inference"], cfg["inference"]),
                learning_rate=cfg["lr"], momentum=cfg["momentum"],
                batch_size=cfg["batch_size"], cycles=cfg["cycles"],
                epochs_per_cycle=cfg["warmup"] + cfg["burnin"] + sample_epochs,
                warmup_epochs=cfg["warmup"], sample_epochs=sample_epochs,
                skip=cfg["skip"], precond_update=cfg["precond_update"],
                seed=part_seeds[p], augment_fn=getattr(type(data),
                                                       "augment_fn", None),
                model_savers=runs.savers[lo:hi] or None,
                metrics_savers=runs.msavers[lo:hi],
                metrics_skip=cfg["metrics_skip"], test_data=test,
                chain_group_size=cfg["chain_group_size"],
                eval_skip=cfg["eval_skip"],
                compute_dtype=_compute_dtype(cfg["compute_dtype"]),
                device=device, mesh=mesh, pipeline=cfg["pipeline"])
            ckpt = None
            if cfg["checkpoint_every"]:
                suffix = f"_part{p}" if len(parts) > 1 else ""
                ckpt = str(Path(cfg["log_dir"])
                           / f"sweep_checkpoint{suffix}.npz")
            runner.run(progressbar=cfg["progressbar"], checkpoint_path=ckpt,
                       checkpoint_every=cfg["checkpoint_every"],
                       resume_from=cfg["resume_from"])
            # finish this part's chains now and free the runner: a finished
            # part's chain state must not stay resident while the next runs
            runs.close(lo, hi)
            acceptance = runner.acceptance_rates() if is_reject else None
            for c in range(lo, hi):
                if runs.runs[c] is None:  # another process's chain
                    continue
                r = c // len(temps)
                bank = runs.bank(runner, c, c - lo, cfg["skip_first"])
                if bank is None:  # e.g. resumed at or after the final epoch
                    res = {"n_samples": 0, "temperature": chain_temps[c],
                           "replicate": r}
                else:
                    res = evaluate_model(model, test, bank)
                    res.update(temperature=chain_temps[c], replicate=r)
                    if is_reject:
                        res["acceptance"] = float(acceptance[c - lo])
                runs.runs[c].finish(res)
                results[c] = res
            del runner
    finally:
        runs.close()
    out = [results[c] for c in sorted(results)]
    for res in out:
        print(json.dumps(res))
    return out


if __name__ == "__main__":
    main(parse_cli(DEFAULTS))
