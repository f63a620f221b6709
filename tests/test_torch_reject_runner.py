"""The whole slice: the port's `VerletSGLDRunnerReject` (GGMC with exact
full-data gradients and M-H boundaries) against the JAX package's, step for
step, in f64 at temperature 0 on FakeCIFAR10 with a depth-8 ResNet.

Both runners start from the same carried-over JAX init, visit the data in
the same order (each instance's `_epoch_perm` returns one numpy
permutation) and log through the same recording `metrics_saver`; every
logged number (per-step potentials, losses, per-leaf diagnostics, boundary
ΔE, test metrics), the final parameters and batchnorm state and the sample
bank must agree. The JAX reference uses the f64-statistics batchnorm of
test_torch_models.py (see the note there).
"""
import math

import jax
import numpy as np
import pytest
import torch

from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxRunner
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.interop import load_jax_state
from bnn_priors_tpu_torch.ops import fused_update

from test_torch_models import (_jax_init, _jax_resnet,  # noqa: F401
                              torch_threads_per_worker)

# 3 full batches + a tail of 4. The JAX reference's time here is mostly
# running the f64 ResNet on XLA's CPU backend, so its data is kept small.
N_TRAIN, N_TEST, BATCH = 100, 25, 32
RUN = dict(epochs_per_cycle=3, warmup_epochs=1, sample_epochs=2,
           learning_rate=1e-3, momentum=0.9, precond_update=1,
           reject_samples=True, batch_size=BATCH)


class Recorder:
    "a metrics_saver that keeps every scalar, keyed by (name, step)"

    def __init__(self):
        self.rows = {}

    def add_scalar(self, name, value, step):
        assert (name, step) not in self.rows, (name, step)
        self.rows[(name, step)] = float(value)

    def flush(self, **kw):
        pass


def _perm():
    perm = np.random.RandomState(7).permutation(N_TRAIN)
    return lambda cycle, epoch: perm


def _port_runner(temperature, params, state, saver=None, seed=0):
    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    model = models.ResNet(depth=8).to(torch.float64)
    load_jax_state(model, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in state.items()})
    return VerletSGLDRunnerReject(model, data.norm.train, data.norm.test,
                                  temperature=temperature,
                                  metrics_saver=saver, seed=seed,
                                  device="cpu", **RUN)


def test_reject_runner_matches_jax_step_for_step(monkeypatch):
    import jax.numpy as jnp
    params, state = _jax_init(8, jnp.float64)
    jrec, trec = Recorder(), Recorder()
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    jr = JaxRunner(_jax_resnet(8, monkeypatch), jdata.norm.train,
                   jdata.norm.test, temperature=0.0, init_params=params,
                   init_model_state=state, key=jax.random.key(0),
                   packing="flat", metrics_saver=jrec, **RUN)
    tr = _port_runner(0.0, params, state, saver=trec)
    jr._epoch_perm = tr._epoch_perm = _perm()
    assert tr.kernel.packer.names == jr.kernel.packer.names
    jr.run()
    launches = fused_update.launches
    tr.run()
    assert fused_update.launches == launches  # the CPU runs the plain version

    keys = {k for k in jrec.rows if not k[0].startswith("timings/")}
    assert keys == {k for k in trec.rows if not k[0].startswith("timings/")}
    names = {k[0] for k in keys}
    for must in ("potential", "loss", "delta_energy", "acceptance/rejected",
                 "test/acc", "test/loss", "est_temperature/net.1.weight",
                 "preconditioner/net.0.weight_prior.p"):
        assert must in names, must
    # per-step potentials: 1 initial + 2 boundaries + 3 epochs x 4 steps
    assert len([k for k in keys if k[0] == "potential"]) == 15
    bad = {k: (trec.rows[k], jrec.rows[k]) for k in sorted(keys)
           if not np.isclose(trec.rows[k], jrec.rows[k], rtol=1e-8,
                             atol=1e-12)}
    assert not bad, list(bad.items())[:10]
    assert len(tr.boundaries) == 2
    for b in tr.boundaries:
        np.testing.assert_allclose(b["delta_energy"],
                                   jrec.rows[("delta_energy", b["step"])],
                                   rtol=1e-8)

    # final parameters + batchnorm state, and the sample bank
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    ts, js = tr.get_samples(keep_steps=True), jr.get_samples(keep_steps=True)
    assert set(ts) == set(js)
    np.testing.assert_array_equal(ts["steps"], js["steps"])
    assert ts["net.0.weight_prior.p"].shape[0] == 2
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)


def test_reject_runner_at_temperature_one():
    "the port alone at T=1: finite potentials, one M-H decision a boundary"
    import jax.numpy as jnp
    params, state = _jax_init(8, jnp.float64)
    rec = Recorder()
    tr = _port_runner(1.0, params, state, saver=rec, seed=3)
    tr.run()
    assert len(tr.potentials) == 3 * 4
    assert np.all(np.isfinite(tr.potentials))
    # metrics steps: 4 steps an epoch, +1 for each boundary
    assert [b["step"] for b in tr.boundaries] == [9, 14]
    for b in tr.boundaries:
        assert math.isfinite(b["delta_energy"])
        assert isinstance(b["rejected"], bool)
        assert rec.rows[("acceptance/rejected", b["step"])] == b["rejected"]
    assert len(tr.get_samples()["net.1.running_mean"]) == 2
    assert 0.0 <= tr.last_eval["test/acc"] <= 1.0


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_reject_runner_is_reproducible(temperature):
    "same seed, same run: no hidden global random state"
    import jax.numpy as jnp
    params, state = _jax_init(8, jnp.float64)
    runs = []
    for _ in range(2):
        tr = _port_runner(temperature, params, state, seed=5)
        tr.run()
        runs.append((tr.potentials, tr.boundaries,
                     tr.kernel.params_of(tr.chain)))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    for k, v in runs[0][2].items():
        assert torch.equal(v, runs[1][2][k])
