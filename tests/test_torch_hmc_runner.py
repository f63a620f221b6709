"""The port's HMC runners against the JAX package's, step for step in f64:
`HMCRunner` (`inference=OurHMC`: leapfrog trajectories of minibatch
gradients, a fresh momentum at every boundary) and `HMCRunnerReject`
(`inference=HMCReject`, and with the batch size N `inference=HMC`: exact
full-data gradients at the trajectory ends and an M-H test).

HMC's only noise is the momentum refresh, so both sides' `sample_momentum`
is patched to return the same numpy draws in the order the runners ask for
them; the JAX runners call it inside jitted functions, so there it reads
the next draw through a host callback. Both runners start from the same
JAX init, visit the data in one fixed order and log through recording
metrics savers: every logged number, the final state and the samples must
agree at rtol 1e-8. The M-H uniforms come from each side's own generator,
so the M-H test runs where its outcome is sure: `HMCReject` runs as the
JAX CLI runs it by default, with `reject_samples=False` (ΔE is logged, no
decision taken), and classical HMC (`kind="HMC"`, run by
test_torch_hmc.py to keep each file's time short) takes its decision on a
ΔE so small that both sides accept, and the test checks that they do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.inference.reject import HMCRunnerReject as JaxReject
from bnn_priors_tpu.inference.runner import HMCRunner as JaxRunner
from bnn_priors_tpu_torch import mcmc, models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.inference import HMCRunner, HMCRunnerReject
from bnn_priors_tpu_torch.interop import load_jax_state
from bnn_priors_tpu_torch.ops import fused_update

from test_torch_models import (_jax_init, _jax_resnet,  # noqa: F401
                              torch_threads_per_worker)
from test_torch_reject_runner import Recorder

# 2 full batches + a tail of 8 (the reject runner's HMC=classical form
# takes all 72 points as one batch)
N_TRAIN, N_TEST = 72, 16
RUN = dict(epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1, cycles=1,
           learning_rate=1e-5, momentum=1.0, temperature=1.0,
           precond_update=1)
PERM = np.random.RandomState(7).permutation(N_TRAIN)


def _draws(n, T, total):
    "the momentum draws both sides take, padding tail zero"
    rng = np.random.RandomState(11)
    out = rng.standard_normal((n, T))
    out[:, total:] = 0.0
    return out


def _patch_momentum(monkeypatch, draws):
    """both packages' HMC.sample_momentum → sqrt(T)·(the next draw), each
    side from its own copy of the list"""
    jax_next, port_next = iter(draws), iter(draws)

    def jax_sample(self, state, temperature, keep=0.0):
        m = jax.pure_callback(lambda: next(jax_next),
                              jax.ShapeDtypeStruct(state.momentum.shape,
                                                   state.momentum.dtype))
        return state._replace(momentum=jnp.sqrt(temperature) * m)

    def port_sample(self, state, temperature, keep=0.0):
        m = torch.as_tensor(next(port_next), dtype=state.momentum.dtype)
        state.momentum = temperature ** 0.5 * m
        return state
    monkeypatch.setattr(jax_mcmc.HMC, "sample_momentum", jax_sample)
    monkeypatch.setattr(mcmc.HMC, "sample_momentum", port_sample)


@pytest.mark.parametrize("kind", ["OurHMC", "HMCReject"])
def test_hmc_runner_matches_jax_step_for_step(monkeypatch, kind):
    assert_matches_jax(monkeypatch, kind)


def assert_matches_jax(monkeypatch, kind):
    "the port's runner for `kind` against the JAX CLI's runner for it"
    params, state = _jax_init(8, jnp.float64)
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    jcls, tcls = ((JaxRunner, HMCRunner) if kind == "OurHMC"
                  else (JaxReject, HMCRunnerReject))
    run = dict(RUN, batch_size=N_TRAIN if kind == "HMC" else 32,
               reject_samples=kind == "HMC")
    jrec, trec = Recorder(), Recorder()
    jr = jcls(_jax_resnet(8, monkeypatch), jdata.norm.train, jdata.norm.test,
              init_params=params, init_model_state=state,
              key=jax.random.key(0), packing="flat", metrics_saver=jrec,
              **run)
    model = models.ResNet(depth=8).to(torch.float64)
    load_jax_state(model, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in state.items()})
    tr = tcls(model, data.norm.train, data.norm.test, metrics_saver=trec,
              device="cpu", **run)
    jr._epoch_perm = tr._epoch_perm = lambda cycle, epoch: PERM
    pk = tr.kernel.packer
    _patch_momentum(monkeypatch, _draws(4, pk.total_padded, pk.total))
    jr.run()
    launches = fused_update.launches
    tr.run()
    assert fused_update.launches == launches  # the CPU runs the plain version

    keys = {k for k in jrec.rows if not k[0].startswith("timings/")}
    assert keys == {k for k in trec.rows if not k[0].startswith("timings/")}
    names = {k[0] for k in keys}
    assert {"potential", "delta_energy", "est_temperature/all"} <= names
    if kind == "HMC":
        assert "acceptance/rejected" in names
        rejected = [v for (n, _), v in trec.rows.items()
                    if n == "acceptance/rejected"]
        assert rejected and not any(rejected)
    bad = {k: (trec.rows[k], jrec.rows[k]) for k in sorted(keys)
           if not np.isclose(trec.rows[k], jrec.rows[k], rtol=1e-8,
                             atol=1e-12)}
    assert not bad, list(bad.items())[:10]
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(tr.chain.momentum.numpy(),
                               np.asarray(jr.chain.momentum), rtol=1e-8,
                               atol=1e-12)
    ts, js = tr.get_samples(keep_steps=True), jr.get_samples(keep_steps=True)
    np.testing.assert_array_equal(ts["steps"], js["steps"])
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
