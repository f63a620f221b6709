"""Every inference on the chain axis (test_torch_chain_inferences.py,
whose helpers and fixtures this file imports), for the SGLD kernel's plain
loop (SGLD) and exact-gradient runner (SGLDReject): the port's chain
runners against the JAX package's step for step in f64 (rtol 1e-8), each
chain against the single-chain runner, the JAX chain checkpoints; and the
plain SGLD loop on a hybrid bank."""
import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch import mcmc
from bnn_priors_tpu_torch.ops import fused_update

from test_torch_chain_inferences import (  # noqa: F401
    BATCH, CLOSE, EPOCHS, K, ChainRecorder, _close, _orders, _port_runner,
    check_jax_checkpoint, check_single_chains, check_step_for_step, jax_runs,
    port_runs)
from test_torch_models import torch_threads_per_worker  # noqa: F401

NAMES = ("SGLD", "SGLDReject")


@pytest.mark.parametrize("name", NAMES)
def test_chain_runner_matches_jax_step_for_step(jax_runs, port_runs, name):
    check_step_for_step(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_each_chain_is_a_single_chain_run(jax_runs, port_runs, name):
    check_single_chains(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_jax_chain_checkpoint_loads(jax_runs, name):
    check_jax_checkpoint(jax_runs, name)


def test_sgld_chains_on_a_hybrid_bank(jax_runs):
    """the plain SGLD loop on a hybrid bank (the convolutions as segments
    of their own, the small leaves as one) from the JAX run's flat chains:
    the same entries, recorded rows and final parameters at rtol 1e-8"""
    start, jhist, jrec, jr, _ = jax_runs("SGLD")
    trec = [ChainRecorder() for _ in range(K)]
    tr = _port_runner("SGLD", packing="hybrid", metrics_savers=trec)
    assert isinstance(tr.chains.position, mcmc.SegVec)
    tr.chains.position.copy_(tr.kernel.packer.from_flat(
        torch.as_tensor(start[0])))
    for k, v in start[1].items():
        tr.buffers[k].copy_(torch.as_tensor(v))
    orders = torch.as_tensor(_orders(BATCH))
    tr._epoch_idxs = lambda cycle=0, epoch=0: orders[cycle * EPOCHS + epoch]
    before = fused_update.segments_chain_launches
    thist = tr.run()
    assert fused_update.segments_chain_launches == before
    for t, j in zip(thist, jhist):
        for k in t:
            _close(t[k], j[k], k)
    for c in range(K):
        ours, theirs = trec[c].logged(), jrec[c].logged()
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], err_msg=str(k),
                                       **CLOSE)
    _close(tr.kernel.packer.to_flat(tr.chains.position).numpy(),
           jr.states.position, "position")
