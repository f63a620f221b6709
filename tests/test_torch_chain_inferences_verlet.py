"""Every inference on the chain axis (test_torch_chain_inferences.py,
whose helpers and fixtures this file imports), for the GGMC kernel's plain
loop (VerletSGLD): the port's chain runner against the JAX package's step
for step in f64 (rtol 1e-8), each chain against a one-chain bank, the JAX
chain checkpoint; and a checkpoint resuming the plain loop and the SGLD
and HMC chain forms bit for bit."""
import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_chain_inferences import (  # noqa: F401
    _port_runner,
    check_jax_checkpoint, check_single_chains, check_step_for_step, jax_runs,
    port_runs)
from test_torch_models import torch_threads_per_worker  # noqa: F401

NAMES = ("VerletSGLD",)


@pytest.mark.parametrize("name", NAMES)
def test_chain_runner_matches_jax_step_for_step(jax_runs, port_runs, name):
    check_step_for_step(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_each_chain_is_a_single_chain_run(jax_runs, port_runs, name):
    check_single_chains(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_jax_chain_checkpoint_loads(jax_runs, name):
    check_jax_checkpoint(jax_runs, name)


@pytest.mark.parametrize("name", ["SGLD", "OurHMC", "SGLDReject",
                                  "HMCReject"])
def test_checkpoint_resume_is_bitwise(tmp_path, name):
    """the plain loop and the SGLD and HMC chain states: a fresh runner of
    another seed resumed from the checkpoint written after epoch 2 ends
    where the uninterrupted run ends, bit for bit (at T>0 where the kernel
    draws noise)"""
    temps = [0.5, 1.0, 1.0] if name.startswith("SGLD") else 1.0
    path = tmp_path / "chains.ckpt.npz"
    full = _port_runner(name, temperatures=temps, seed=3)
    # the file keeps the state after epoch 2 (of 3)
    hist = full.run(checkpoint_path=str(path), checkpoint_every=2)
    resumed = _port_runner(name, temperatures=temps, seed=4)
    rhist = resumed.run(resume_from=str(path))
    assert len(rhist) == 1
    for k in hist[-1]:
        np.testing.assert_array_equal(rhist[-1][k], hist[-1][k], err_msg=k)
    for f in ("position", "momentum", "square_avg", "precond"):
        assert torch.equal(getattr(resumed.chains, f),
                           getattr(full.chains, f)), f
    assert resumed.chains.n_updates == full.chains.n_updates
    if isinstance(full, MultiChainRunnerReject):
        np.testing.assert_array_equal(np.stack(resumed.delta_energies),
                                      np.stack(full.delta_energies))
