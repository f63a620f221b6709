"""The port's `train_bnn` with `inference=HMC`, classical HMC: the reject
runner with one batch of all N points and the M-H test on, beside the JAX
CLI's run (see test_torch_cli_hmc.py), and its refusal of tempering and
descent epochs.
"""
import pytest

from bnn_priors_tpu_torch.experiments import train_bnn

from test_torch_cli import bank, patched  # noqa: F401
from test_torch_cli_hmc import (HMC, assert_writes_the_jax_metrics,  # noqa: F401
                                hmc_runs)
from test_torch_models import torch_threads_per_worker  # noqa: F401


def test_classical_hmc_writes_the_jax_metrics(hmc_runs):
    assert_writes_the_jax_metrics(hmc_runs, "HMC")


@pytest.mark.parametrize("key,value", [("temperature", 0.5), ("burnin", 1)])
def test_classical_hmc_refuses_tempering_and_descent(patched, tmp_path, key,
                                                     value):
    "train_bnn.py:186-189: classical HMC needs T=1 and no descent epochs"
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(HMC, inference="HMC", log_dir=str(tmp_path), **{key: value})
    with pytest.raises(AssertionError, match="classical HMC"):
        train_bnn.main(cfg)
