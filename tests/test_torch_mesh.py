"""The port's chain axis over a mesh in one process, against the JAX
package's on its virtual CPU devices (tests/conftest.py) and against the
port without a mesh:

* the reject runner with `n_devices=2` (two sub-banks on the one CPU,
  `BNN_PRIORS_CPU_DEVICES=2`), on the workload of
  tests/distributed_worker.py, against the JAX runner on a 2-device mesh
  (its temperature-0 chains: the packages' noise differs) and every chain
  against the port's one-bank run; the plain runner's fresh orders and
  the ResNet's batchnorm buffers, augmentation, metrics and a checkpoint
  on a mesh against one bank;
* `ChainMesh` over a (chains, data) mesh against JAX's (test_parallel.py:
  18-60);
* `evaluate_model(mesh=)` against JAX's (test_evaluate.py:132-160).

f64, rtol 1e-8 unless stated.
"""
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu import models as jax_models
from bnn_priors_tpu.evaluate import metrics as jax_metrics
from bnn_priors_tpu.parallel import ChainMesh as JaxChainMesh
from bnn_priors_tpu.parallel import init_chains as jax_init_chains
from bnn_priors_tpu.parallel import make_mesh as jax_make_mesh
from bnn_priors_tpu_torch import device, mcmc, models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.evaluate import metrics
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.io import HDF5Metrics
from bnn_priors_tpu_torch.parallel import (ChainMesh, MultiChainRunner,
                                           MultiChainRunnerReject,
                                           distributed, make_mesh)

from test_torch_distributed import (COLD, jax_mesh_run,  # noqa: F401
                                    one_process, worker)
from test_torch_models import torch_threads_per_worker  # noqa: F401


@pytest.fixture
def cpu_devices(monkeypatch):
    "the CPU as 8 mesh positions (the JAX tests' 8 virtual devices)"
    monkeypatch.setenv(device.CPU_DEVICES_ENV, "8")


def _mesh(n):
    return distributed.global_chains_mesh(n, "cpu")


def test_mesh_positions_and_counts(cpu_devices):
    """the mesh lists the CPU's positions in order and splits chains evenly;
    more devices than there are raises, naming both counts"""
    mesh = _mesh(2)
    cpu = torch.device("cpu")
    assert mesh.positions == ((0, cpu), (0, cpu))
    assert mesh.local() == [(0, cpu), (1, cpu)]
    assert distributed.local_chain_indices_for_mesh(mesh, 8) == list(range(8))
    assert mesh.chain_ranges(8) == [(0, 4), (4, 8)]
    with pytest.raises(ValueError, match="n_devices=9 but only 8"):
        _mesh(9)
    with pytest.raises(ValueError, match="split evenly"):
        mesh.chain_ranges(5)
    # one process: this rank's rows a position, its rows by chain, and the
    # host values as they are (no collective)
    tree = {"w": torch.arange(16.0).reshape(8, 2)}
    rows = distributed.put_chains(tree, mesh)
    assert [r["w"][:, 0].tolist() for r in rows] == [[0, 2, 4, 6],
                                                      [8, 10, 12, 14]]
    parts = {0: rows[0]["w"].numpy(), 4: rows[1]["w"].numpy()}
    by_chain = distributed.local_chain_rows(parts)
    assert sorted(by_chain) == list(range(8))
    np.testing.assert_array_equal(by_chain[5], [10.0, 11.0])
    assert distributed.host_value(parts, mesh) == parts


@pytest.fixture(scope="module")
def mesh_run():
    "the worker's workload in one process on a 2-position mesh"
    mp = pytest.MonkeyPatch()
    mp.setenv(device.CPU_DEVICES_ENV, "2")
    try:
        x, y, params, orders = worker.workload()
        runner = MultiChainRunnerReject(
            models.LogisticRegression(4, 2).to(torch.float64),
            (torch.as_tensor(x), torch.as_tensor(y)), worker.N_CHAINS,
            temperatures=worker.TEMPERATURES, seed=42, device="cpu",
            mesh=_mesh(2), init_params_fn=lambda c, g: {
                k: torch.as_tensor(v[c]) for k, v in params.items()},
            **worker.RUN)
    finally:
        mp.undo()
    worker.fixed_orders(runner, orders, torch.as_tensor)
    runner.run()
    return runner


def test_mesh_reject_runner_matches_jax_and_one_bank(mesh_run, one_process,
                                                     jax_mesh_run):
    """two sub-banks of 4: every chain equals the one-bank run (T=1 chains
    with their noise and M-H draws), the T=0 chains the JAX mesh run"""
    assert [(b.lo, b.hi) for b in mesh_run.banks] == [(0, 4), (4, 8)]
    with pytest.raises(AttributeError, match="sub-banks"):
        mesh_run.chains
    np.testing.assert_array_equal(np.stack(mesh_run.rejections),
                                  np.stack(one_process.rejections))
    np.testing.assert_allclose(np.stack(mesh_run.delta_energies),
                               np.stack(one_process.delta_energies),
                               rtol=1e-8, atol=1e-12)
    ours, one = mesh_run.get_samples(), one_process.get_samples()
    jbank, cold = jax_mesh_run.get_samples(), list(COLD)
    for k, v in ours.items():
        np.testing.assert_allclose(v, one[k], rtol=1e-8, atol=1e-12,
                                   err_msg=k)
        np.testing.assert_allclose(v[:, cold], jbank[k][:, cold], rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(
        np.stack(mesh_run.delta_energies)[:, cold],
        np.stack(jax_mesh_run.delta_energies)[:, cold], rtol=1e-8)


def test_plain_runner_on_a_mesh_draws_every_chains_orders(cpu_devices):
    """the plain loop's fresh orders a chain an epoch come from the one
    host generator for all K: a 4-position mesh runs each chain as the one
    bank does"""
    x, y, params, _ = worker.workload()

    def run(mesh):
        r = MultiChainRunner(
            models.LogisticRegression(4, 2).to(torch.float64),
            (torch.as_tensor(x), torch.as_tensor(y)), worker.N_CHAINS,
            temperatures=0.5, seed=3, device="cpu", mesh=mesh,
            precond_update=1, **worker.RUN)
        hist = r.run()
        return r, hist
    (a, ha), (b, hb) = run(None), run(_mesh(4))
    assert len(b.banks) == 4
    for ea, eb in zip(ha, hb):
        for k in ea:
            np.testing.assert_allclose(eb[k], ea[k], rtol=1e-8, err_msg=k)
    for k, v in b.get_samples().items():
        np.testing.assert_allclose(v, a.get_samples()[k], rtol=1e-8,
                                   atol=1e-12, err_msg=k)


def _metrics_file(path):
    "every series of a metrics file but the timings"
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f
                if not k.startswith("timings") and k != "timestamps"}


def assert_same_series(got, ref, rtol, err_msg):
    if ref.dtype.kind in "fc":
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-12,
                                   err_msg=err_msg)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=err_msg)


def test_resnet_sub_banks_with_buffers_metrics_and_resume(cpu_devices,
                                                          tmp_path):
    """ResNet-8 with batchnorm, augmentation and metrics savers, 2 chains
    as two sub-banks: the one bank's entries, buffers and metric files;
    then stopped after epoch 2 of 4 and resumed on the mesh, bit for bit
    the unbroken mesh run's end"""
    data = FakeCIFAR10(dtype="float64", n_train=16, n_test=8, device="cpu")
    model = models.ResNet(depth=8).to(torch.float64)
    run = dict(temperatures=[1.0, 0.3], learning_rate=0.02,
               momentum=0.9, batch_size=16, cycles=2, epochs_per_cycle=2,
               warmup_epochs=1, sample_epochs=1, precond_update=1,
               augment_fn=FakeCIFAR10.augment_fn, metrics_skip=2, seed=5,
               init_params_fn=lambda i, g: he_initialize(
                   models.ResNet(depth=8).to(torch.float64), g).params(),
               test_data=data.norm.test, device="cpu")

    def run_with(tag, mesh, cycles=2, **kw):
        savers = [HDF5Metrics(tmp_path / f"{tag}{c}.h5") for c in range(2)]
        r = MultiChainRunnerReject(model, data.norm.train, 2, mesh=mesh,
                                   metrics_savers=savers, **run)
        r.cycles = cycles  # fewer: the run stops early, on the schedule
        hist = r.run(**kw)
        for s in savers:
            s.close()
        return r, hist
    one, hist = run_with("one", None)
    mesh, mhist = run_with("mesh", _mesh(2))
    for e, f in zip(mhist, hist):
        assert set(e) == set(f)
        for k in f:
            np.testing.assert_allclose(e[k], f[k], rtol=1e-8, err_msg=k)
    for b in mesh.banks:
        for k, v in b.buffers.items():
            np.testing.assert_allclose(v.numpy(), one.buffers[k][b.lo:b.hi]
                                       .numpy(), rtol=1e-8, err_msg=k)
    for c in range(2):
        ref = _metrics_file(tmp_path / f"one{c}.h5")
        got = _metrics_file(tmp_path / f"mesh{c}.h5")
        assert set(got) == set(ref)
        for k in ref:
            assert_same_series(got[k], ref[k], 1e-8, f"{c} {k}")
    ckpt = str(tmp_path / "after2.npz")
    run_with("stopped", _mesh(2), cycles=1, checkpoint_path=ckpt,
             checkpoint_every=1)
    resumed, _ = run_with("resumed", _mesh(2), resume_from=ckpt)
    for b, r in zip(mesh.banks, resumed.banks):
        np.testing.assert_array_equal(r.chains.position.numpy(),
                                      b.chains.position.numpy())
        for k, v in b.buffers.items():
            np.testing.assert_array_equal(r.buffers[k].numpy(), v.numpy())
    np.testing.assert_array_equal(np.stack(resumed.rejections),
                                  np.stack(mesh.rejections))


def test_a_one_chain_bank_has_buffers_of_its_own():
    """a sub-bank of one chain (and a runner of one) keeps its batchnorm
    state in memory of its own, as the JAX runner's copy does
    (multichain.py:153-156): it once aliased the model's buffers, whose
    running statistics the chain then wrote, and two one-chain sub-banks
    shared them"""
    data = FakeCIFAR10(dtype="float64", n_train=32, n_test=8, device="cpu")
    model = models.ResNet(depth=8).to(torch.float64)
    before = {k: v.clone() for k, v in model.named_buffers()}
    runner = MultiChainRunner(model, data.norm.train, 1, temperatures=0.0,
                              batch_size=16, device="cpu", seed=0)
    runner.run()
    assert any(not torch.equal(v, before[k])
               for k, v in runner.buffers.items() if v.is_floating_point())
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k


@pytest.fixture
def toy():
    "x, y of test_parallel.py's _toy, and LogisticRegression params"
    k1, k2 = jax.random.split(jax.random.key(0))
    x = np.asarray(jax.random.normal(k1, (64, 4)), dtype=np.float64)
    y = np.asarray(jax.random.normal(k2, (64,)) > 0).astype(np.int64)
    rng = np.random.default_rng(1)
    params = {"net.weight_prior.p": rng.standard_normal((2, 4)),
              "net.bias_prior.p": rng.standard_normal(2)}
    return x, y, params


def _port_chains(params, n, mesh_shape, lr, temperature, x, y, B):
    "one port ChainMesh step of n identical chains on their first B points"
    kernel = mcmc.VerletSGLDChains(num_data=64, momentum=0.9)
    state = kernel.init({k: torch.as_tensor(v).expand(n, *v.shape)
                         for k, v in params.items()}, list(range(n)))
    model = models.LogisticRegression(4, 2).to(torch.float64)
    cm = ChainMesh(make_mesh(*mesh_shape, device="cpu"), kernel, model,
                   eff_num_data=64)
    xb = cm.place_batch(torch.tensor(x[:B]).expand(n, B, 4))
    yb = cm.place_batch(torch.tensor(y[:B]).expand(n, B))
    states, _, m = cm.make_step(lambda i: lr)(cm.place_chains(state), {}, 0,
                                              xb, yb, temperature)
    return state, states, m


def _jax_chains(params, n, mesh_shape, lr, temperature, x, y, B):
    kernel = jax_mcmc.VerletSGLD(num_data=64, momentum=0.9)
    states = jax_init_chains(kernel, {k: jnp.asarray(v)
                                      for k, v in params.items()},
                             jax.random.key(2), n)
    cm = JaxChainMesh(jax_make_mesh(*mesh_shape), kernel,
                      jax_models.LogisticRegression(4, 2), eff_num_data=64)
    states = cm.place_chains(states)
    xb = cm.place_batch(jnp.broadcast_to(jnp.asarray(x[:B]), (n, B, 4)))
    yb = cm.place_batch(jnp.broadcast_to(jnp.asarray(y[:B]), (n, B)))
    new, _, m = cm.make_step(lr_fn=lambda i: lr)(
        states, cm.place_chains({}), jnp.asarray(0), xb, yb,
        jnp.asarray(temperature))
    return new, m


def test_chain_mesh_step(cpu_devices, toy):
    """a (4 chains × 2 data) step of 8 chains at T=1: finite, every chain
    moved, and differently (own noise); at T=0 every chain's position and
    potential equal the JAX ChainMesh's"""
    x, y, params = toy
    state, states, m = _port_chains(params, 8, (4, 2), 1e-3, 1.0, x, y, 16)
    assert np.isfinite(m["mean_potential"]) and sorted(states) == [0, 1, 2, 3]
    pos = torch.cat([states[c].position for c in range(4)]).numpy()
    assert not np.allclose(pos[0], state.position[0].numpy())  # not moved
    assert not np.allclose(pos[0], pos[1])
    _, cold, mc = _port_chains(params, 8, (4, 2), 1e-3, 0.0, x, y, 16)
    jnew, jm = _jax_chains(params, 8, (4, 2), 1e-3, 0.0, x, y, 16)
    T = sum(v.size for v in params.values())
    pos = torch.cat([cold[c].position for c in range(4)]).numpy()
    np.testing.assert_allclose(pos[:, :T], np.asarray(jnew.position)[:, :T],
                               rtol=1e-8)
    np.testing.assert_allclose(
        torch.cat([mc["potential"][c] for c in range(4)]).numpy(),
        np.asarray(jm["potential"]), rtol=1e-8)
    np.testing.assert_allclose(mc["mean_potential"],
                               float(jm["mean_potential"]), rtol=1e-8)


def test_sharded_grad_matches_single_device(cpu_devices, toy):
    """a (1 × 2) mesh at lr 0: the potential of the data-split minibatch is
    the full minibatch's (the JAX model's potential_avg_fn), and a T=0
    step's position equals one data position's over the whole batch"""
    x, y, params = toy
    _, _, m = _port_chains(params, 1, (1, 2), 0.0, 1.0, x, y, 32)
    fn = jax_models.LogisticRegression(4, 2).potential_avg_fn(
        {}, jnp.asarray(x[:32]), jnp.asarray(y[:32]), eff_num_data=64.0,
        train=True)
    pot_ref, _ = fn({k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(float(m["potential"][0][0]), float(pot_ref),
                               rtol=1e-8)
    _, split, _ = _port_chains(params, 1, (1, 2), 1e-2, 0.0, x, y, 32)
    _, whole, _ = _port_chains(params, 1, (1, 1), 1e-2, 0.0, x, y, 32)
    np.testing.assert_allclose(split[0].position.numpy(),
                               whole[0].position.numpy(), rtol=1e-12)


def test_evaluate_model_mesh_matches_jax(cpu_devices):
    """JAX's test (test_evaluate.py:132-160) on the port: an 11-sample bank
    of ClassificationDenseNet(5, 3, 8, depth=2) split over 8 mesh
    positions (padded with the last sample, trimmed) against the JAX
    package's 8-device mesh, and the port without a mesh"""
    jmodel = jax_models.ClassificationDenseNet(5, 3, 8, depth=2)
    banks = [jmodel.init(jax.random.fold_in(jax.random.key(0), i))[0]
             for i in range(11)]
    samples = {k: np.stack([np.asarray(b[k]) for b in banks])
               for k in banks[0]}
    x = np.asarray(jax.random.normal(jax.random.key(1), (37, 5)))
    y = np.asarray(jax.random.randint(jax.random.key(2), (37,), 0, 3))
    kw = dict(likelihood_eval=True, accuracy_eval=True,
              calibration_eval=True, batch_size=16)
    ref = jax_metrics.evaluate_model(
        jmodel, (jnp.asarray(x), jnp.asarray(y)), samples,
        mesh=Mesh(np.asarray(jax.devices()[:8]), ("samples",)), **kw)
    model = models.ClassificationDenseNet(5, 3, 8, depth=2).to(torch.float64)
    data = (torch.as_tensor(x), torch.as_tensor(y))
    mesh = distributed.DeviceMesh([(0, "cpu")] * 8, ("samples",))
    out = metrics.evaluate_model(model, data, samples, mesh=mesh, **kw)
    plain = metrics.evaluate_model(model, data, samples, **kw)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-9, err_msg=k)
        assert out[k] == plain[k], k
