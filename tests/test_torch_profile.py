"""`profile_dir` on the port's single-chain runners and its CLI, on the CPU:
the trace is a Chrome trace JSON file in `profile_dir`, it covers at most
`profile_max_steps` minibatch steps of epoch `profile_epoch` (counted by a
probe around the update wrapper), and the profiled chain is bit for bit
the unprofiled one.
"""
import json

import pytest
import torch

from bnn_priors_tpu_torch import exp_utils
from bnn_priors_tpu_torch.data import RandomData
from bnn_priors_tpu_torch.experiments import train_bnn
from bnn_priors_tpu_torch.inference import (SGLDRunner,
                                            VerletSGLDRunnerReject)
from bnn_priors_tpu_torch.ops import fused_update

from test_torch_models import torch_threads_per_worker  # noqa: F401

PROBE = "test_probe_langevin_update"


@pytest.fixture
def probe(monkeypatch):
    "each (T,) update call inside a profiler range named PROBE"
    orig = fused_update.fused_langevin_update

    def probed(*args, **kwargs):
        with torch.profiler.record_function(PROBE):
            return orig(*args, **kwargs)
    monkeypatch.setattr(fused_update, "fused_langevin_update", probed)


def _run(cls, profile_dir=None):
    data = RandomData(seed=0, device="cpu")  # 1,000 training points
    model = exp_utils.get_model("densenet", x_train=data.norm.train_X,
                                y_train=data.norm.train_y, width=8,
                                device="cpu", seed=1)
    runner = cls(model, data.norm.train, data.norm.test, epochs_per_cycle=3,
                 warmup_epochs=1, sample_epochs=2, learning_rate=1e-3,
                 momentum=0.9, batch_size=90, seed=2, device="cpu",
                 profile_dir=profile_dir, profile_epoch=1,
                 profile_max_steps=4)
    runner.run()
    return runner


def _probes(path):
    events = json.loads(path.read_text())["traceEvents"]
    return sum(1 for e in events if e.get("name") == PROBE)


@pytest.mark.parametrize("cls", [SGLDRunner, VerletSGLDRunnerReject])
def test_profile_window_and_same_chain(cls, probe, tmp_path):
    """11 full batches of 90 and a tail an epoch: the trace of epoch 1
    holds 4 updates; the chain and samples equal the unprofiled run's"""
    traced = _run(cls, tmp_path / "trace")
    assert [p.name for p in (tmp_path / "trace").iterdir()] == [
        "trace_epoch1.json"]
    assert _probes(tmp_path / "trace" / "trace_epoch1.json") == 4
    plain = _run(cls)
    for field in ("position", "momentum", "square_avg", "precond"):
        assert torch.equal(getattr(traced.chain, field),
                           getattr(plain.chain, field)), field
    a, b = traced.get_samples(), plain.get_samples()
    assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
               for k in a)


def test_cli_writes_the_trace(probe, tmp_path):
    """train_bnn profile_dir=<dir> (the JAX CLI's defaults: epoch 1, at
    most 50 steps) writes the trace; 1,000 points in batches of 16 make
    62 full batches an epoch"""
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(data="random", model="densenet", width=8,
               inference="VerletSGLDReject", cycles=1, warmup=1, burnin=0,
               n_samples=1, skip_first=0, batch_size=16, progressbar=False,
               device="cpu", profile_dir=str(tmp_path / "trace"),
               log_dir=str(tmp_path / "runs"))
    result = train_bnn.main(cfg)
    assert _probes(tmp_path / "trace" / "trace_epoch1.json") == 50
    run = json.loads((tmp_path / "runs" / "1" / "run.json").read_text())
    assert run["status"] == "COMPLETED" and run["result"] == result
