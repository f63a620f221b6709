"""The port's chain axis across processes: a real 2-process
`torch.distributed` run (gloo on localhost, one CPU mesh position a rank,
tests/torch_distributed_worker.py, the workload of the JAX package's
tests/distributed_worker.py) must

* split the chains, each rank writing only its own chains' files,
* give both ranks the same shared diagnostics (gathered over gloo),
* write one checkpoint, from rank 0, that resumes in one process,
* equal the one-process run of the port chain for chain (noise and M-H
  draws keyed by the chain, not by its rank), and
* match the JAX package's single-process mesh run, computed here, on the
  chains at temperature 0 (the two packages' noise differs) in f64 to
  rtol 1e-8;

and the same two processes then run the `train_bnn` CLI as one program.

The ranks run as subprocesses, each with its own timeout.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxReject
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.io import load_metrics, load_samples
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_distributed_worker as worker  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
COLD = range(4)  # the chains at temperature 0
RANK_TIMEOUT = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    "both ranks' output directory, after both exited 0"
    outdir = tmp_path_factory.mktemp("torch_dist")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), str(r), "2", str(port),
         str(outdir)], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outdir


def _port_runner(seed=42):
    x, y, params, orders = worker.workload()
    runner = MultiChainRunnerReject(
        models.LogisticRegression(4, 2).to(torch.float64),
        (torch.as_tensor(x), torch.as_tensor(y)), worker.N_CHAINS,
        temperatures=worker.TEMPERATURES, seed=seed, device="cpu",
        init_params_fn=lambda c, g: {k: torch.as_tensor(v[c])
                                     for k, v in params.items()},
        **worker.RUN)
    worker.fixed_orders(runner, orders, torch.as_tensor)
    return runner


@pytest.fixture(scope="module")
def one_process():
    "the port's one-process run of the workload, without a mesh"
    runner = _port_runner()
    runner.run()
    return runner


@pytest.fixture(scope="module")
def jax_mesh_run():
    "the JAX runner on a 2-device mesh of the virtual CPU devices, f64"
    x, y, params, orders = worker.workload()
    runner = JaxReject(
        jax_models.LogisticRegression(4, 2), (jnp.asarray(x), jnp.asarray(y)),
        n_chains=worker.N_CHAINS, temperatures=worker.TEMPERATURES,
        key=jax.random.key(42), dtype=jnp.float64,
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("chains",)),
        init_params_fn=lambda c, key: {k: jnp.asarray(v[c])
                                       for k, v in params.items()},
        **worker.RUN)
    worker.fixed_orders(runner, orders, jnp.asarray)
    runner.run()
    return runner


def test_two_ranks_split_the_chains_and_their_files(dist_run):
    """disjoint halves, each rank's own files only (rank 1's chains are
    4-7), the same diagnostics on both ranks, one checkpoint"""
    r0, r1 = (np.load(dist_run / f"rank{r}.npz") for r in range(2))
    assert list(r0["local_chains"]) == [0, 1, 2, 3]
    assert list(r1["local_chains"]) == [4, 5, 6, 7]
    for c in range(worker.N_CHAINS):
        assert (dist_run / f"chain_{c}.h5").exists(), c
        assert (dist_run / f"chain_{c}.metrics.h5").exists(), c
    for k in ("rejections", "delta_energies", "acceptance", "potentials",
              "nan_chains"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0["rejections"].shape == (2, worker.N_CHAINS)
    assert (dist_run / "chains.ckpt.npz").exists()


def test_two_ranks_equal_the_one_process_run(dist_run, one_process):
    """every chain, the T=1 ones with their noise and M-H draws too: the
    diagnostics, each chain's samples and its metric series"""
    r0 = np.load(dist_run / "rank0.npz")
    np.testing.assert_array_equal(r0["rejections"],
                                  np.stack(one_process.rejections))
    np.testing.assert_allclose(r0["delta_energies"],
                               np.stack(one_process.delta_energies),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r0["potentials"],
                               np.stack(one_process.potentials), rtol=1e-8)
    bank = one_process.get_samples()
    for c in range(worker.N_CHAINS):
        theirs = load_samples(str(dist_run / f"chain_{c}.h5"))
        assert set(theirs) == set(bank)
        for k, v in theirs.items():
            np.testing.assert_allclose(v, bank[k][:, c], rtol=1e-8,
                                       atol=1e-12, err_msg=f"{c} {k}")
        de = load_metrics(dist_run / f"chain_{c}.metrics.h5",
                          ("delta_energy",))["delta_energy"]
        np.testing.assert_array_equal(de[~np.isnan(de)],
                                      r0["delta_energies"][:, c])


def test_rank0_checkpoint_resumes_in_one_process(dist_run, one_process):
    """the gathered checkpoint after epoch 3 (of 4), resumed by a fresh
    one-process runner of another seed, ends where the unbroken run ends"""
    resumed = _port_runner(seed=7)
    resumed.run(resume_from=str(dist_run / "chains.ckpt.npz"))
    for a, b in ((resumed.chains.position, one_process.chains.position),
                 (resumed.chains.momentum, one_process.chains.momentum)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-12)
    np.testing.assert_array_equal(np.stack(resumed.rejections),
                                  np.stack(one_process.rejections))


def test_cold_chains_match_the_jax_mesh_run(dist_run, jax_mesh_run):
    "the T=0 chains against the JAX 2-device mesh run, f64, rtol 1e-8"
    r0 = np.load(dist_run / "rank0.npz")
    cold = list(COLD)
    np.testing.assert_allclose(
        r0["delta_energies"][:, cold],
        np.stack(jax_mesh_run.delta_energies)[:, cold], rtol=1e-8)
    assert not r0["rejections"][:, cold].any()
    bank = jax_mesh_run.get_samples()
    for c in cold:
        for k, v in load_samples(str(dist_run / f"chain_{c}.h5")).items():
            np.testing.assert_allclose(v, bank[k][:, c], rtol=1e-8,
                                       atol=1e-12, err_msg=f"{c} {k}")


def test_cli_over_two_processes(dist_run):
    """train_bnn as one program over two processes (`num_processes=2
    n_devices=2`, one CPU position a rank, run by the worker after its
    runner): each rank makes the run dirs of its own two chains of four,
    all COMPLETED (chip_smoke.py phase 22 runs the sweep this way too)"""
    import json
    chains = {}
    for d in (dist_run / "cli").iterdir():
        cfg = json.loads((d / "config.json").read_text())
        assert json.loads((d / "run.json").read_text())["status"] == \
            "COMPLETED", d
        if "chain_index" in cfg:
            assert cfg["chain_index"] not in chains
            chains[cfg["chain_index"]] = cfg["process_id"]
            assert (d / "samples.pt").exists() and (d / "metrics.h5").exists()
    assert chains == {0: 0, 1: 0, 2: 1, 3: 1}
