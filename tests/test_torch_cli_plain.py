"""The port's `train_bnn` with the runners beside GGMC with exact M-H:
`inference=SGLD` and `VerletSGLD` (the plain loops with their final
boundary step) and `SGLDReject` (the fixed-order protocol with the SGLD
kernel), each against the JAX CLI on the same warm start, minibatch order
and T=0, with the augmentation off. Data, model, warm start, runs and
tolerances are test_torch_cli.py's.
"""
import pytest

from test_torch_cli import (assert_runs_match, bank, cli_run,  # noqa: F401
                            patched)
from test_torch_models import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("inference", ["SGLD", "VerletSGLD", "SGLDReject"])
def test_runner_matches_the_jax_cli(cli_run, inference):
    assert_runs_match(cli_run("jax", inference), cli_run("port", inference),
                      inference)
