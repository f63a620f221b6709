"""`train_bnn` through every registry prior that builds on ResNet-20 (29
names), on `data=cifar10_small` read from local CIFAR-10 python batches:
each run completes, its result is finite, and its sample bank holds every
leaf of the prior, hyper leaves included."""
import json

import numpy as np
import pytest

from bnn_priors_tpu_torch.experiments import train_bnn
from bnn_priors_tpu_torch.io import load_samples

from test_torch_cli_priors import _cli, cifar_root  # noqa: F401
from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_resnet_priors import ON_RESNET20


@pytest.mark.parametrize("name", ON_RESNET20)
def test_cli_runs_every_prior_on_cifar10_files(name, cifar_root, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("BNN_PRIORS_DATA", cifar_root)
    cfg = _cli(tmp_path, weight_prior=name, batch_size=40, metrics_skip=10)
    result = train_bnn.main(cfg)
    run_dir = next(tmp_path.iterdir())
    assert json.loads((run_dir / "run.json").read_text())["status"] == \
        "COMPLETED"
    assert all(np.isfinite(v) for v in result.values()), result
    bank = load_samples(str(run_dir / "samples.pt"))
    leaves = train_bnn.model_of(cfg, "cpu").params()
    prior_leaves = {k for k in leaves if "net.14.weight_prior" in k}
    assert prior_leaves and prior_leaves <= set(bank)
    for k in prior_leaves:
        assert bank[k].shape == (1,) + tuple(leaves[k].shape)
        assert np.all(np.isfinite(bank[k]))
