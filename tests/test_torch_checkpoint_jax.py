"""Checkpoints across the two packages, in f64 at temperature 0 with fixed
minibatch orders (no noise enters, so the packages' different generators
do not matter):

* a port run stopped with its checkpoint and resumed by a fresh runner
  ends where the JAX package's uninterrupted run ends;
* a JAX checkpoint (`packing="flat"`) loaded into the port's runner
  (`interop.load_jax_checkpoint`) and run to the end matches it too, for
  one chain (`chain.ckpt.npz`) and for K chains (`chains.ckpt.npz`);
* a hybrid JAX checkpoint is refused, naming the ROADMAP item.

The JAX single-chain run (a depth-8 ResNet with the f64-statistics
batchnorm of test_torch_models.py) writes its checkpoint after each of its
two cycles; the file of epoch 2 is kept (`jax_run`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxRunner
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxChains
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.interop import load_jax_checkpoint, load_jax_state
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_models import (_jax_init, _jax_resnet,  # noqa: F401
                              torch_threads_per_worker)
from test_torch_reject_runner import Recorder

# 2 full batches + a tail of 8; two cycles of 2 epochs (1 warmup, 1 sampling)
N_TRAIN, N_TEST, BATCH = 72, 16, 32
RUN = dict(epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1, cycles=2,
           learning_rate=1e-3, momentum=0.9, precond_update=1,
           reject_samples=True, batch_size=BATCH, temperature=0.0)
PERM = np.random.RandomState(7).permutation(N_TRAIN)
RTOL, ATOL = 1e-8, 1e-12


def _keep_each_checkpoint(runner):
    "the runner's checkpoints go to `<path>.<next epoch>`, one file each"
    real = runner.save_checkpoint

    def save(path, next_epoch_index, *args, **kw):
        real(f"{path}.{next_epoch_index}", next_epoch_index, *args, **kw)
    runner.save_checkpoint = save


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """the JAX reject runner's uninterrupted run, its metric rows and the
    checkpoint it wrote after epoch 2"""
    params, state = _jax_init(8, jnp.float64)
    path = str(tmp_path_factory.mktemp("jax") / "chain.ckpt.npz")
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    mp = pytest.MonkeyPatch()
    try:
        jm = _jax_resnet(8, mp)
    finally:
        mp.undo()
    rec = Recorder()
    jr = JaxRunner(jm, jdata.norm.train, jdata.norm.test, init_params=params,
                   init_model_state=state, key=jax.random.key(0),
                   packing="flat", metrics_saver=rec, checkpoint_path=path,
                   checkpoint_every=2, **RUN)
    jr._epoch_perm = lambda cycle, epoch: PERM
    _keep_each_checkpoint(jr)
    jr.run()
    return jr, rec, path + ".2"


def _port_runner(path=None, every=None, seed=0):
    "the port's runner from the JAX init, with a metrics recorder"
    params, state = _jax_init(8, jnp.float64)
    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    model = models.ResNet(depth=8).to(torch.float64)
    load_jax_state(model, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in state.items()})
    r = VerletSGLDRunnerReject(model, data.norm.train, data.norm.test,
                               metrics_saver=Recorder(), seed=seed,
                               checkpoint_path=path, checkpoint_every=every,
                               device="cpu", **RUN)
    r._epoch_perm = lambda cycle, epoch: PERM
    return r


def _assert_ends_as_jax(tr, jax_run):
    "final state, last sample and the resumed run's metric rows"
    jr, jrec, _ = jax_run
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for name in ("momentum", "square_avg", "precond", "grads"):
        n = tr.kernel.packer.total  # the XLA branch's v tail holds ones
        np.testing.assert_allclose(
            getattr(tr.chain, name)[:n].numpy(),
            np.asarray(getattr(jr.chain, name))[:n], rtol=RTOL, atol=ATOL,
            err_msg=name)
    ts, js = tr.get_samples(keep_steps=True), jr.get_samples(keep_steps=True)
    assert list(ts["steps"]) == list(js["steps"][-1:])
    for k in js:
        np.testing.assert_allclose(ts[k][-1], np.asarray(js[k][-1]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    rows = {k: v for k, v in tr.metrics_saver.rows.items()
            if not k[0].startswith("timings/")}
    assert len(rows) > 100
    bad = {k: (v, jrec.rows[k]) for k, v in rows.items()
           if not np.isclose(v, jrec.rows[k], rtol=RTOL, atol=ATOL)}
    assert not bad, list(bad.items())[:10]


def test_port_resume_matches_jax_uninterrupted(jax_run, tmp_path):
    path = str(tmp_path / "chain.ckpt.npz")
    half = _port_runner(path, every=2)
    half.cycles = 1
    half.run()
    resumed = _port_runner(seed=3)
    resumed.run(resume_from=path)
    _assert_ends_as_jax(resumed, jax_run)


def test_a_jax_checkpoint_carries_across(jax_run):
    tr = _port_runner(seed=5)
    start = load_jax_checkpoint(jax_run[2], tr)
    assert start == (2, 2 * 3)  # epoch 2, after 2 epochs of 3 steps
    assert tr._precond_pending is False
    tr.run(resume_from=start)
    _assert_ends_as_jax(tr, jax_run)


def test_a_hybrid_jax_checkpoint_is_refused(tmp_path):
    "the JAX runners' default packing stores its state in many leaves"
    params, state = _jax_init(8, jnp.float64)
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    jr = JaxRunner(jax_models.google_resnet.ResNet(depth=8),
                   jdata.norm.train, None, init_params=params,
                   init_model_state=state, key=jax.random.key(0),
                   packing="hybrid", **RUN)
    path = str(tmp_path / "chain.ckpt.npz")
    jr.save_checkpoint(path, 0, 0)
    tr = _port_runner()
    before = tr.chain.position.clone()
    with pytest.raises(ValueError, match="ROADMAP item 1"):
        load_jax_checkpoint(path, tr)
    assert torch.equal(tr.chain.position, before)


def test_a_jax_chains_checkpoint_carries_across(tmp_path):
    """K=3 chains of a Gaussian model: the JAX runner's file of epoch 2,
    finished by the port, ends where the JAX run ends"""
    K, D = 3, 10
    rng = np.random.RandomState(0)
    inits = [{f"{i}.p": rng.randn(D) * 2.0 + 1.0 for i in range(3)}
             for _ in range(K)]
    chains = dict(n_chains=K, temperatures=0.0, learning_rate=1e-2,
                  momentum=0.9, batch_size=16, cycles=2, epochs_per_cycle=2,
                  warmup_epochs=1, sample_epochs=1, precond_update=1)
    x, y = np.zeros((32, 3)), np.zeros(32, np.int64)
    jr = JaxChains(jax_models.GaussianModel(3, D, 1.0, 2.0),
                   (jnp.asarray(x), jnp.asarray(y, jnp.int32)),
                   key=jax.random.key(7), dtype=jnp.float64, packing="flat",
                   init_params_fn=lambda c, key: {
                       k: jnp.asarray(v) for k, v in inits[c].items()},
                   **chains)
    _keep_each_checkpoint(jr)
    path = str(tmp_path / "chains.ckpt.npz")
    jr.run(checkpoint_path=path, checkpoint_every=2)

    tr = MultiChainRunnerReject(
        models.GaussianModel(3, D, 1.0, 2.0).to(torch.float64),
        (torch.as_tensor(x), torch.as_tensor(y)), seed=9, device="cpu",
        init_params_fn=lambda c, g: {k: torch.as_tensor(v)
                                     for k, v in inits[c].items()},
        **chains)
    assert tr.kernel.packer.names == jr.kernel.packer.names
    start = load_jax_checkpoint(path + ".2", tr)
    assert start == (2, 2 * 2)
    tr.run(resume_from=start)
    np.testing.assert_allclose(tr.chains.position.numpy(),
                               np.asarray(jr.states.position), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(np.stack(tr.rejections),
                                  np.stack(jr.rejections))
    np.testing.assert_allclose(np.stack(tr.delta_energies),
                               np.stack(jr.delta_energies), rtol=RTOL,
                               atol=ATOL)
