"""One process of a 2-process run of the port's chain axis over
`torch.distributed` (gloo on localhost), for tests/test_torch_distributed.py:

    python torch_distributed_worker.py <rank> <nprocs> <port> <outdir>

Runs `MultiChainRunnerReject` on the workload of tests/distributed_worker.py
(LogisticRegression(4, 2) on 48 points, K=8, two cycles of 2 epochs) over
a `chains` mesh of one CPU position a rank, with the pipeline on. Its
initial parameters and fixed minibatch orders are numpy's (`workload`), so
that the test can give the JAX runner the same; chains 0-3 run at
temperature 0 and 4-7 at 1. Its checkpoint comes after epoch 3 (of 4), so
that a resume from it runs a sampling epoch and its boundary. Each rank
streams its own chains' samples and metrics to
<outdir>/chain_<c>.{h5,metrics.h5} and writes its view of the shared
diagnostics to <outdir>/rank<r>.npz. Then, in the same process group, it
runs the `train_bnn` CLI as one program over the processes (`CLI`, with
`num_processes`, `process_id`, `coordinator_address` and
`log_dir=<outdir>/cli`).
"""
import sys
from pathlib import Path

import numpy as np

N_CHAINS, N, BATCH = 8, 48, 16
TEMPERATURES = [0.0] * 4 + [1.0] * 4
RUN = dict(learning_rate=1e-2, momentum=0.9, batch_size=BATCH, cycles=2,
           epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1)


# train_bnn over the processes: four chains, two a rank
CLI = ("data=random", "model=densenet", "width=8", "depth=2", "n_samples=2",
       "cycles=1", "warmup=1", "skip_first=0", "batch_size=50",
       "progressbar=False", "device=cpu", "inference=VerletSGLDReject",
       "n_chains=4", "n_devices=2", "reject_samples=True")


def workload():
    """(x, y, per-chain initial parameters {name: (K, ...)} in the JAX
    package's names, (cycles, K, n_full, B) minibatch orders)"""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 4))
    y = (rng.standard_normal(N) > 0).astype(np.int64)
    params = {"net.weight_prior.p": rng.standard_normal((N_CHAINS, 2, 4)),
              "net.bias_prior.p": rng.standard_normal((N_CHAINS, 2))}
    orders = np.stack([[rng.permutation(N).reshape(-1, BATCH)
                        for _ in range(N_CHAINS)] for _ in range(2)])
    return x, y, params, orders


def fixed_orders(runner, orders, to_tensor):
    "each chain's fixed order a cycle from `orders`, on the runner"
    runner._epoch_idxs = lambda cycle=0, epoch=0: to_tensor(orders[cycle])


def main(rank, nprocs, port, outdir):
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bnn_priors_tpu_torch import models
    from bnn_priors_tpu_torch.exp.config import parse_cli
    from bnn_priors_tpu_torch.experiments import train_bnn
    from bnn_priors_tpu_torch.io import HDF5Metrics, HDF5ModelSaver
    from bnn_priors_tpu_torch.parallel import (MultiChainRunnerReject,
                                               distributed)

    torch.set_num_threads(1)
    distributed.initialize(f"localhost:{port}", nprocs, rank)
    mesh = distributed.global_chains_mesh(device="cpu")
    assert mesh.size == nprocs, mesh
    local = distributed.local_chain_indices_for_mesh(mesh, N_CHAINS)
    x, y, params, orders = workload()
    savers, msavers = [None] * N_CHAINS, [None] * N_CHAINS
    for c in local:
        savers[c] = HDF5ModelSaver(outdir / f"chain_{c}.h5")
        msavers[c] = HDF5Metrics(outdir / f"chain_{c}.metrics.h5")
    model = models.LogisticRegression(4, 2).to(torch.float64)
    runner = MultiChainRunnerReject(
        model, (torch.as_tensor(x), torch.as_tensor(y)), N_CHAINS,
        temperatures=TEMPERATURES, seed=42, device="cpu", mesh=mesh,
        init_params_fn=lambda c, g: {k: torch.as_tensor(v[c])
                                     for k, v in params.items()},
        model_savers=savers, metrics_savers=msavers, pipeline=True, **RUN)
    fixed_orders(runner, orders, torch.as_tensor)
    runner.run(checkpoint_path=str(outdir / "chains.ckpt.npz"),
               checkpoint_every=3)
    for s in savers + msavers:
        if s is not None:
            s.close()
    np.savez(outdir / f"rank{rank}.npz", local_chains=np.asarray(local),
             rejections=np.stack(runner.rejections),
             delta_energies=np.stack(runner.delta_energies),
             acceptance=runner.acceptance_rates(),
             potentials=np.stack(runner.potentials),
             nan_chains=np.asarray(sorted(runner.nan_chains)))
    train_bnn.main(parse_cli(train_bnn.DEFAULTS, [
        "with", *CLI, f"num_processes={nprocs}", f"process_id={rank}",
        f"coordinator_address=localhost:{port}", f"log_dir={outdir / 'cli'}"]))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         Path(sys.argv[4]))
