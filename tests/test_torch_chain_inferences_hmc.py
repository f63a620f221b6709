"""Every inference on the chain axis (test_torch_chain_inferences.py,
whose helpers and fixtures this file imports), for the HMC kernel's plain
loop (OurHMC) and exact-gradient runner (HMCReject): the port's chain
runners against the JAX package's step for step in f64 (rtol 1e-8), each
chain against a single-chain run, and the JAX chain checkpoints."""
import pytest

from test_torch_chain_inferences import (  # noqa: F401
    check_jax_checkpoint, check_single_chains, check_step_for_step, jax_runs,
    port_runs)
from test_torch_models import torch_threads_per_worker  # noqa: F401

NAMES = ("OurHMC", "HMCReject")


@pytest.mark.parametrize("name", NAMES)
def test_chain_runner_matches_jax_step_for_step(jax_runs, port_runs, name):
    check_step_for_step(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_each_chain_is_a_single_chain_run(jax_runs, port_runs, name):
    check_single_chains(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_jax_chain_checkpoint_loads(jax_runs, name):
    check_jax_checkpoint(jax_runs, name)
