"""The pipelined epoch (`pipeline=True`): each epoch's host work (the NaN
check, the metric rows, the boundary row, the sample writes) drains on a
worker thread behind the next epoch's dispatch, from host copies staged
before the next epoch writes the bank in place. It must

* give the same histories and the same HDF5 sample and metric files (but
  their timings) as `pipeline=False`, for both runners, with a checkpoint
  mid-run whose file is the same too: a drain that read a later epoch's
  values would differ;
* with metrics savers, match the JAX runner with its own pipeline on (the
  workload of tests/distributed_worker.py, its temperature-0 chains: the
  packages' noise differs), f64, rtol 1e-8;
* hand an error raised in the drain (a saver that fails) to `run()`'s
  caller, with the worker thread gone.
"""
import threading

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu.io import HDF5Metrics as JaxHDF5Metrics
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxReject
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.io import HDF5Metrics, HDF5ModelSaver
from bnn_priors_tpu_torch.parallel import (MultiChainRunner,
                                           MultiChainRunnerReject)

from test_torch_distributed import COLD, worker
from test_torch_models import torch_threads_per_worker  # noqa: F401

K = 2


def _files(path, skip=("timestamps",)):
    "every dataset of an HDF5 file but the timings and timestamps"
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f
                if not k.startswith("timings") and k not in skip}


def _run(cls, pipeline, tmp_path, **kw):
    """a ResNet-8 bank of K chains with augmentation, metrics and model
    savers and a checkpoint after epoch 3 of 4; (runner, history, the
    files' directory)"""
    out = tmp_path / f"{cls.__name__}_{pipeline}"
    out.mkdir()
    data = FakeCIFAR10(dtype="float64", n_train=32, n_test=8, device="cpu")
    savers = [HDF5ModelSaver(out / f"samples{c}.h5") for c in range(K)]
    msavers = [HDF5Metrics(out / f"metrics{c}.h5") for c in range(K)]
    runner = cls(models.ResNet(depth=8).to(torch.float64), data.norm.train,
                 K, temperatures=[1.0, 0.3], learning_rate=0.02,
                 momentum=0.9, batch_size=16, cycles=2, epochs_per_cycle=2,
                 warmup_epochs=1, sample_epochs=1, precond_update=1,
                 augment_fn=FakeCIFAR10.augment_fn, metrics_skip=2, seed=3,
                 init_params_fn=lambda i, g: he_initialize(
                     models.ResNet(depth=8).to(torch.float64), g).params(),
                 test_data=data.norm.test, device="cpu", model_savers=savers,
                 metrics_savers=msavers, pipeline=pipeline, **kw)
    try:
        hist = runner.run(checkpoint_path=str(out / "ckpt.npz"),
                          checkpoint_every=3)
    finally:
        for s in savers + msavers:
            s.close()
    return runner, hist, out


@pytest.mark.parametrize("cls", [MultiChainRunner, MultiChainRunnerReject])
def test_pipeline_equals_the_synchronous_loop(cls, tmp_path):
    """histories, sample banks, metric series (timings aside, and the
    pipeline's wall_s there) and the checkpoint file: equal"""
    on, hon, don = _run(cls, True, tmp_path)
    off, hoff, doff = _run(cls, False, tmp_path)
    assert on._drain_thread is None
    assert len(hon) == len(hoff) == 4
    for a, b in zip(hon, hoff):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for c in range(K):
        for name in (f"samples{c}.h5", f"metrics{c}.h5"):
            a, b = _files(don / name), _files(doff / name)
            assert set(a) == set(b) and a, name
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name + k)
        with h5py.File(don / f"metrics{c}.h5", "r") as f:
            assert "timings/wall_s" in f and "timings/epoch_s" in f
        with h5py.File(doff / f"metrics{c}.h5", "r") as f:
            assert "timings/wall_s" not in f
    with np.load(don / "ckpt.npz") as a, np.load(doff / "ckpt.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if cls is MultiChainRunnerReject:
        np.testing.assert_array_equal(np.stack(on.delta_energies),
                                      np.stack(off.delta_energies))


def test_pipeline_matches_the_jax_pipeline(tmp_path):
    """the reject runner with metrics savers, both packages' pipelines on:
    the temperature-0 chains' metric series (but timings), ΔE and samples"""
    x, y, params, orders = worker.workload()
    run = dict(temperatures=worker.TEMPERATURES, metrics_skip=2, **worker.RUN)
    jsavers = [JaxHDF5Metrics(tmp_path / f"jax{c}.h5")
               for c in range(worker.N_CHAINS)]
    jr = JaxReject(jax_models.LogisticRegression(4, 2),
                   (jnp.asarray(x), jnp.asarray(y)), n_chains=worker.N_CHAINS,
                   key=jax.random.key(0), dtype=jnp.float64,
                   init_params_fn=lambda c, key: {
                       k: jnp.asarray(v[c]) for k, v in params.items()},
                   metrics_savers=jsavers, pipeline=True, **run)
    worker.fixed_orders(jr, orders, jnp.asarray)
    jr.run()
    savers = [HDF5Metrics(tmp_path / f"port{c}.h5")
              for c in range(worker.N_CHAINS)]
    tr = MultiChainRunnerReject(
        models.LogisticRegression(4, 2).to(torch.float64),
        (torch.as_tensor(x), torch.as_tensor(y)), worker.N_CHAINS, seed=0,
        device="cpu", init_params_fn=lambda c, g: {
            k: torch.as_tensor(v[c]) for k, v in params.items()},
        metrics_savers=savers, pipeline=True, **run)
    worker.fixed_orders(tr, orders, torch.as_tensor)
    tr.run()
    for s in jsavers + savers:
        s.close()
    cold = list(COLD)
    np.testing.assert_allclose(np.stack(tr.delta_energies)[:, cold],
                               np.stack(jr.delta_energies)[:, cold],
                               rtol=1e-8)
    for c in cold:
        ours, ref = (_files(tmp_path / f"port{c}.h5"),
                     _files(tmp_path / f"jax{c}.h5"))
        assert set(ours) == set(ref)
        for k in ref:
            if ref[k].dtype.kind in "fc":
                np.testing.assert_allclose(ours[k], ref[k], rtol=1e-8,
                                           atol=1e-12, err_msg=f"{c} {k}")
            else:
                np.testing.assert_array_equal(ours[k], ref[k])
    jbank, bank = jr.get_samples(), tr.get_samples()
    for k, v in bank.items():
        np.testing.assert_allclose(v[:, cold], jbank[k][:, cold], rtol=1e-8,
                                   atol=1e-12, err_msg=k)


class FailingSaver:
    "a metrics saver whose third block of rows fails"

    def __init__(self):
        self.blocks = 0

    def add_rows(self, cols, steps):
        self.blocks += 1
        if self.blocks == 3:
            raise OSError("disk full")

    def add_scalar(self, *args):
        pass

    def flush(self, *args, **kw):
        pass


@pytest.mark.parametrize("cls", [MultiChainRunner, MultiChainRunnerReject])
def test_a_drain_error_reaches_the_caller(cls):
    x, y, params, _ = worker.workload()
    runner = cls(models.LogisticRegression(4, 2).to(torch.float64),
                 (torch.as_tensor(x), torch.as_tensor(y)), worker.N_CHAINS,
                 seed=0, device="cpu", pipeline=True,
                 metrics_savers=[FailingSaver()] + [None] * 7,
                 **dict(worker.RUN, cycles=3))
    with pytest.raises(OSError, match="disk full"):
        runner.run()
    assert runner._drain_thread is None
    assert not any(t.name == "drain-worker" and t.is_alive()
                   for t in threading.enumerate())
