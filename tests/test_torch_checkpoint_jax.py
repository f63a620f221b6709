"""Checkpoints across the two packages, in f64 at temperature 0 with fixed
minibatch orders (no noise enters, so the packages' different generators
do not matter):

* a port run stopped with its checkpoint and resumed by a fresh runner
  ends where the JAX package's uninterrupted run ends;
* a JAX checkpoint loaded into the port's runner
  (`interop.load_jax_checkpoint`) and run to the end matches it too, for
  one chain (`chain.ckpt.npz`) and for K chains (`chains.ckpt.npz`): a
  flat file, and hybrid and segmented files (the JAX runners' default
  packing, and the per-leaf one) into a flat port runner and into a port
  runner of the file's packing;
* a hybrid JAX checkpoint is refused by a segmented port runner, and a
  file of another model by any runner.

The JAX single-chain run (a depth-8 ResNet with the f64-statistics
batchnorm of test_torch_models.py) writes its checkpoint after each of its
two cycles; the file of epoch 2 is kept (`jax_run`). The hybrid and
segmented files hold that file's state in the JAX package's own `SegVec`
layouts (its `HybridPacker`/`SegPacker`), written by its checkpoint writer
(`jax_packed_file`): at temperature 0 the JAX run's deterministic state
does not depend on the packing (tests/test_segmented.py), so JAX's flat
uninterrupted run is the reference for every file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.io import checkpoint as jax_ckpt
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


def _jax_packed_state(state, packing, params, lead=()):
    """a flat JAX chain state in the JAX package's `packing` layout (its
    own packers; K chains by vmap)"""
    fp = jax_mcmc.packing.Packer(params)
    dst = jax_mcmc.VerletSGLD(1.0, packing=packing)._ensure_packer(params)
    per = jax.vmap if lead else (lambda f: f)
    vec = per(lambda v: dst.pack(fp.unpack(v)))
    return state._replace(
        position=vec(state.position), momentum=vec(state.momentum),
        grads=vec(state.grads), square_avg=vec(state.square_avg),
        precond=per(lambda v: dst.expand(fp.leaf_firsts(v)))(state.precond),
        saved=tuple(vec(v) for v in state.saved))


def jax_packed_file(path, out, packing, template, params, lead=()):
    """the JAX checkpoint `path` (flat) rewritten by the JAX package's
    checkpoint writer with its chain state in `packing`'s layout;
    `template` is (chain, model state, key) of the runner that wrote it"""
    chain, mstate, rkey, meta = jax_ckpt.load_chain_checkpoint(path,
                                                               *template)
    jax_ckpt.save_chain_checkpoint(
        out, _jax_packed_state(chain, packing, params, lead), mstate, rkey,
        meta)
    with np.load(out) as data:
        n_leaves = sum(k.startswith("chain_") for k in data.files)
    return out, n_leaves


def _port_runner(path=None, every=None, seed=0, packing="flat"):
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
                               device="cpu", packing=packing, **RUN)
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
    pk = tr.kernel.packer
    for name in ("momentum", "square_avg", "grads"):
        n = pk.total  # the XLA branch's v tail holds ones
        np.testing.assert_allclose(
            pk.to_flat(getattr(tr.chain, name))[:n].numpy(),
            np.asarray(getattr(jr.chain, name))[:n], rtol=RTOL, atol=ATOL,
            err_msg=name)
    np.testing.assert_allclose(tr.kernel.leaf_precond(tr.chain).numpy(),
                               np.asarray(jr.kernel.leaf_precond(jr.chain)),
                               rtol=RTOL, atol=ATOL, err_msg="precond")
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


@pytest.fixture(scope="module")
def jax_packed_files(jax_run, tmp_path_factory):
    "the epoch-2 file of `jax_run` in the hybrid and segmented layouts"
    jr, _, path = jax_run
    params, _ = _jax_init(8, jnp.float64)
    d = tmp_path_factory.mktemp("jax_packed")
    return {p: jax_packed_file(path, str(d / f"{p}.ckpt.npz"), p,
                               (jr.chain, jr.model_state, jr.key), params)
            for p in ("hybrid", "segmented")}


@pytest.mark.parametrize("file_packing,port_packing", [
    ("hybrid", "flat"), ("hybrid", "hybrid"), ("segmented", "flat"),
    ("segmented", "segmented")])
def test_a_packed_jax_checkpoint_carries_across(jax_run, jax_packed_files,
                                                file_packing, port_packing):
    """a hybrid or segmented JAX file (its segments, one leaf each: 22 +
    ... leaves for ResNet-8's hybrid state) resumed by a flat port runner
    and by a runner of its own packing ends where JAX's run ends"""
    path, n_leaves = jax_packed_files[file_packing]
    pk = _port_runner(packing=file_packing).kernel.packer
    assert n_leaves == 8 * pk.n_segments + 2  # 5 vectors, 3 saved, 2 sums
    tr = _port_runner(seed=5, packing=port_packing)
    start = load_jax_checkpoint(path, tr)
    assert start == (2, 2 * 3)
    tr.run(resume_from=start)
    _assert_ends_as_jax(tr, jax_run)


def test_a_hybrid_jax_checkpoint_is_refused(jax_packed_files):
    """a hybrid file loads into a flat runner or a hybrid one; a segmented
    runner refuses it, naming both packings, and keeps its state"""
    tr = _port_runner(packing="segmented")
    before = tr.kernel.packer.to_flat(tr.chain.position).clone()
    with pytest.raises(ValueError, match="a hybrid JAX checkpoint; the "
                       "port's runner packs its state segmented"):
        load_jax_checkpoint(jax_packed_files["hybrid"][0], tr)
    assert torch.equal(tr.kernel.packer.to_flat(tr.chain.position), before)


def test_a_jax_checkpoint_of_another_model_is_refused(jax_packed_files,
                                                      jax_run):
    "a ResNet-8 file into a ResNet-14 runner: no packing of its leaves fits"
    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    for packing in ("flat", "hybrid"):
        tr = VerletSGLDRunnerReject(
            models.ResNet(depth=14).to(torch.float64), data.norm.train, None,
            device="cpu", packing=packing, **RUN)
        for path in (jax_run[2], jax_packed_files["hybrid"][0]):
            with pytest.raises(ValueError, match="not a flat, segmented or "
                               "hybrid state of the runner's model"):
                load_jax_checkpoint(path, tr)


K, D = 3, 10
CHAINS = dict(n_chains=K, temperatures=0.0, learning_rate=1e-2, momentum=0.9,
              batch_size=16, cycles=2, epochs_per_cycle=2, warmup_epochs=1,
              sample_epochs=1, precond_update=1)
INITS = [{f"{i}.p": r.randn(D) * 2.0 + 1.0 for i in range(3)}
         for r in [np.random.RandomState(0)] for _ in range(K)]
XY = np.zeros((32, 3)), np.zeros(32, np.int64)


@pytest.fixture(scope="module")
def jax_chains_run(tmp_path_factory):
    """K=3 chains of a Gaussian model: the JAX chain runner's uninterrupted
    run and its file of epoch 2, flat and in the hybrid and segmented
    layouts"""
    x, y = XY
    jr = JaxChains(jax_models.GaussianModel(3, D, 1.0, 2.0),
                   (jnp.asarray(x), jnp.asarray(y, jnp.int32)),
                   key=jax.random.key(7), dtype=jnp.float64, packing="flat",
                   init_params_fn=lambda c, key: {
                       k: jnp.asarray(v) for k, v in INITS[c].items()},
                   **CHAINS)
    _keep_each_checkpoint(jr)
    d = tmp_path_factory.mktemp("jax_chains")
    path = str(d / "chains.ckpt.npz")
    jr.run(checkpoint_path=path, checkpoint_every=2)
    params = {k: jnp.asarray(v) for k, v in INITS[0].items()}
    files = {"flat": path + ".2"}
    for p in ("hybrid", "segmented"):
        files[p], _ = jax_packed_file(
            path + ".2", str(d / f"{p}.chains.ckpt.npz"), p,
            (jr.states, jr.model_states, jr.key), params, lead=(K,))
    return jr, files


def _port_chains(packing="flat"):
    x, y = XY
    return MultiChainRunnerReject(
        models.GaussianModel(3, D, 1.0, 2.0).to(torch.float64),
        (torch.as_tensor(x), torch.as_tensor(y)), seed=9, device="cpu",
        init_params_fn=lambda c, g: {k: torch.as_tensor(v)
                                     for k, v in INITS[c].items()},
        packing=packing, **CHAINS)


def _chains_end_as_jax(tr, jr):
    np.testing.assert_allclose(
        tr.kernel.packer.to_flat(tr.chains.position).numpy(),
        np.asarray(jr.states.position), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.stack(tr.rejections),
                                  np.stack(jr.rejections))
    np.testing.assert_allclose(np.stack(tr.delta_energies),
                               np.stack(jr.delta_energies), rtol=RTOL,
                               atol=ATOL)


def test_a_jax_chains_checkpoint_carries_across(jax_chains_run):
    """K=3 chains of a Gaussian model: the JAX runner's file of epoch 2,
    finished by the port, ends where the JAX run ends"""
    jr, files = jax_chains_run
    tr = _port_chains()
    assert tr.kernel.packer.names == jr.kernel.packer.names
    start = load_jax_checkpoint(files["flat"], tr)
    assert start == (2, 2 * 2)
    tr.run(resume_from=start)
    _chains_end_as_jax(tr, jr)


@pytest.mark.parametrize("file_packing,port_packing", [
    ("hybrid", "flat"), ("hybrid", "hybrid"), ("segmented", "flat"),
    ("segmented", "segmented")])
def test_a_packed_jax_chains_checkpoint_carries_across(
        jax_chains_run, file_packing, port_packing):
    """the K=3 file in the hybrid (one small segment) and segmented (one
    (K, D) segment a leaf) layouts, into a flat port runner and a runner of
    the file's packing"""
    jr, files = jax_chains_run
    with np.load(files[file_packing]) as data:
        shapes = [data[f"chain_{i}"].shape for i in range(3)]
    assert shapes[0] == ((K, 3 * D) if file_packing == "hybrid" else (K, D))
    tr = _port_chains(port_packing)
    start = load_jax_checkpoint(files[file_packing], tr)
    assert start == (2, 2 * 2)
    tr.run(resume_from=start)
    _chains_end_as_jax(tr, jr)
