"""Priors with and without hyper leaves through the samplers: the port's
`VerletSGLDRunnerReject` against the JAX package's, step for step, in f64
at temperature 0, on a depth-8 ResNet whose dense layer carries `laplace`
or `gaussian_gamma` (a scalar hyper leaf `net.….weight_prior.scale.p` that
joins the packed vector, its preconditioner and its diagnostics). Every
logged number, under the JAX package's metric names, the final state and
the sample bank must agree at rtol 1e-8.

Both runners start from the port's initial values (its prior init and He
weights, from a torch generator): JAX's own `init` draws every leaf through
a jitted sampler, one XLA compile a leaf shape (~10 s a process on the
CPU), and nothing here tests it. 32 points in batches of 16 keep the two
steps an epoch and the boundaries of the run."""
import jax
import numpy as np
import pytest
import torch

from bnn_priors_tpu import priors as JP
from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxRunner
from bnn_priors_tpu.models import google_resnet as jax_gr
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch import priors as TP
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject

from test_torch_models import (F64StatsBatchNorm,  # noqa: F401
                              answer_init, torch_threads_per_worker)
from test_torch_reject_runner import Recorder

N_TRAIN, N_TEST, BATCH = 32, 16, 16
RUN = dict(epochs_per_cycle=3, warmup_epochs=1, sample_epochs=2,
           learning_rate=1e-3, momentum=0.9, precond_update=1,
           reject_samples=True, batch_size=BATCH)


def jax_model(name, monkeypatch):
    "the JAX ResNet-8 with `name` on its dense layer, f64 batch statistics"
    monkeypatch.setattr(jax_gr, "BatchNorm2d", F64StatsBatchNorm)
    return jax_gr.ResNet(depth=8, prior_w=JP.get_prior(name))


def port_model(name, dtype=torch.float64):
    return models.ResNet(depth=8, prior_w=TP.get_prior(name)).to(dtype)


def port_init(model, seed):
    """the port model's prior init (hyper leaves at their pins) and He
    weights from one generator, in place; (params, buffers) as numpy"""
    g = torch.Generator().manual_seed(seed)
    he_initialize(model.init(g), g)
    return ({k: v.detach().numpy().copy() for k, v in model.params().items()},
            {k: v.numpy().copy() for k, v in model.named_buffers()})


@pytest.mark.parametrize("name", ["laplace", "gaussian_gamma"])
def test_prior_runner_matches_jax_step_for_step(name, monkeypatch):
    jm = jax_model(name, monkeypatch)
    tm = port_model(name)
    params, state = answer_init(jm, *port_init(tm, 0))
    hyper = [k for k in params if "weight_prior." in k
             and not k.endswith("weight_prior.p")]
    assert hyper == (["net.8.weight_prior.scale.p"]
                     if name == "gaussian_gamma" else [])

    jrec, trec = Recorder(), Recorder()
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    jr = JaxRunner(jm, jdata.norm.train, jdata.norm.test, temperature=0.0,
                   init_params=params, init_model_state=state,
                   key=jax.random.key(0), packing="flat",
                   metrics_saver=jrec, **RUN)
    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    tr = VerletSGLDRunnerReject(tm, data.norm.train, data.norm.test,
                                temperature=0.0, metrics_saver=trec,
                                device="cpu", **RUN)
    perm = np.random.RandomState(7).permutation(N_TRAIN)
    jr._epoch_perm = tr._epoch_perm = lambda cycle, epoch: perm
    pk = tr.kernel.packer
    assert pk.names == jr.kernel.packer.names
    assert pk.total == jr.kernel.packer.total
    jr.run()
    tr.run()

    keys = {k for k in jrec.rows if not k[0].startswith("timings/")}
    assert keys == {k for k in trec.rows if not k[0].startswith("timings/")}
    names = {k[0] for k in keys}
    for h in hyper:  # the hyper leaf's own diagnostics, JAX's names
        assert {f"est_temperature/{h}", f"preconditioner/{h}"} <= names
    bad = {k: (trec.rows[k], jrec.rows[k]) for k in sorted(keys)
           if not np.isclose(trec.rows[k], jrec.rows[k], rtol=1e-8,
                             atol=1e-12)}
    assert not bad, list(bad.items())[:10]
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    ts, js = tr.get_samples(keep_steps=True), jr.get_samples(keep_steps=True)
    assert set(ts) == set(js) >= set(hyper)
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
