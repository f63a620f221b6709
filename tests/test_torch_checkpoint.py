"""Full chain-state checkpoints of the port's single-chain runners
(`bnn_priors_tpu_torch/io/checkpoint.py`), mirroring tests/test_checkpoint.py:
a run resumed from its checkpoint is the uninterrupted run, bit for bit,
for every runner; the file round-trips every dtype and generator, refuses
a mismatched runner, and survives a failed write. The comparison with the
JAX package (a port run resumed against JAX's uninterrupted run, and a JAX
checkpoint loaded into the port) is in test_torch_checkpoint_jax.py.
"""
import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.inference import (HMCRunner, HMCRunnerReject,
                                            SGLDRunner, SGLDRunnerReject,
                                            VerletSGLDRunner,
                                            VerletSGLDRunnerReject)
from bnn_priors_tpu_torch.io import (load_chain_checkpoint,
                                     save_chain_checkpoint)
from bnn_priors_tpu_torch.mcmc import VerletSGLD, VerletSGLDChains

from test_torch_models import torch_threads_per_worker  # noqa: F401

# 150 points in batches of 32: 4 full batches and a tail of 22
N_TRAIN, N_TEST = 150, 25
RUN = dict(epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
           learning_rate=1e-3, cycles=2, temperature=1.0, batch_size=32,
           precond_update=1, augment_fn=FakeCIFAR10.augment_fn)
HMC_RUNNERS = (HMCRunner, HMCRunnerReject)
REJECTING = (VerletSGLDRunner, VerletSGLDRunnerReject) + HMC_RUNNERS


class Recorder:
    "a metrics_saver that keeps every scalar, keyed by (name, step)"

    def __init__(self):
        self.rows = {}

    def add_scalar(self, name, value, step):
        assert (name, step) not in self.rows, (name, step)
        self.rows[(name, step)] = float(value)

    def flush(self, **kw):
        pass


@pytest.fixture(scope="module")
def data():
    return FakeCIFAR10(n_train=N_TRAIN, n_test=N_TEST, device="cpu")


def _runner(cls, data, path=None, every=None, seed=42):
    model = models.ResNet(depth=8)
    he_initialize(model, torch.Generator().manual_seed(seed))
    return cls(model, data.norm.train, data.norm.test, seed=seed,
               momentum=1.0 if cls in HMC_RUNNERS else 0.9,
               reject_samples=cls in REJECTING, metrics_saver=Recorder(),
               checkpoint_path=path, checkpoint_every=every, device="cpu",
               **RUN)


def _equal_state(a, b):
    sa, sb = a.chain.state_arrays(), b.chain.state_arrays()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for k, g in a.chain.generators().items():
        assert torch.equal(g.get_state(), b.chain.generators()[k].get_state())
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    for (k, u), (_, v) in zip(a.model.named_buffers(),
                              b.model.named_buffers()):
        assert torch.equal(u, v), k


@pytest.mark.parametrize("cls", [SGLDRunner, VerletSGLDRunner,
                                 VerletSGLDRunnerReject, SGLDRunnerReject,
                                 HMCRunner, HMCRunnerReject],
                         ids=lambda c: c.__name__)
def test_resume_is_bitwise_identical(cls, data, tmp_path):
    """tests/test_checkpoint.py:36-70 on the port, augmented, at T=1: the
    run stopped after epoch 2 and resumed by a fresh runner of ANOTHER
    seed (the file carries every seed and generator) ends where the
    uninterrupted run ends, with its samples and metric rows"""
    full = _runner(cls, data)
    full.run()
    path = str(tmp_path / "chain.ckpt.npz")
    half = _runner(cls, data, path, every=2)
    half.cycles = 1  # stop after epoch 2; the file was written after it
    half.run()
    resumed = _runner(cls, data, seed=7)
    resumed.run(resume_from=path)
    _equal_state(full, resumed)
    sf, sr = full.get_samples(keep_steps=True), resumed.get_samples(
        keep_steps=True)
    assert len(sf["steps"]) == 2 and len(sr["steps"]) == 1
    for k in sf:
        np.testing.assert_array_equal(sr[k][-1], sf[k][-1], err_msg=k)
    # every row the resumed run logs is the uninterrupted run's at its
    # index, but the wall-clock timings
    rows = {k: v for k, v in resumed.metrics_saver.rows.items()
            if not k[0].startswith("timings/")}
    assert rows and min(s for _, s in rows) > 1
    assert {k: full.metrics_saver.rows[k] for k in rows} == rows


def test_checkpoint_roundtrip_types(tmp_path):
    """every dtype the runners store, the generators' states, a state
    without rollback slots and the chain form's int64 keys and counter"""
    params = {"b": torch.arange(5.0, dtype=torch.float64),
              "a": torch.ones(2, 3, dtype=torch.float64)}
    k = VerletSGLD(num_data=10.0, momentum=0.9)
    state = k.init(params, seed=3, save_state=False)
    state.momentum = torch.randn(state.momentum.shape, dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(0))
    torch.rand(5, generator=state.gen)
    runner_gen = torch.Generator().manual_seed(11)
    bufs = {"bn.num_batches_tracked": torch.tensor(7),
            "bn.running_mean": torch.full((3,), 0.5)}
    meta = {"next_epoch_index": 4, "step": 17, "initial_potential": -1.5,
            "total_energy": 0.25, "pending": True,
            "seeds": np.arange(3, dtype=np.int64) + 2 ** 61}
    path = str(tmp_path / "c.npz")
    save_chain_checkpoint(path, state.state_arrays(), bufs,
                          {"runner": runner_gen, **state.generators()}, meta)
    fresh = k.init(params, seed=99, save_state=False)
    gens = {"runner": torch.Generator(), **fresh.generators()}
    arrays, b, states, m = load_chain_checkpoint(
        path, fresh.state_arrays(), bufs, gens)
    assert "saved_position" not in arrays
    fresh.load_state_arrays(arrays)
    for name, v in state.state_arrays().items():
        got = fresh.state_arrays()[name]
        assert got.dtype == v.dtype and torch.equal(got, v), name
    assert fresh.saved is None
    assert b["bn.num_batches_tracked"].dtype == np.int64
    np.testing.assert_array_equal(b["bn.running_mean"], 0.5)
    for name, s in states.items():
        gens[name].set_state(s)
    assert torch.equal(gens["runner"].get_state(), runner_gen.get_state())
    assert torch.equal(fresh.gen.get_state(), state.gen.get_state())
    assert int(m["step"]) == 17 and float(m["total_energy"]) == 0.25
    assert bool(m["pending"]) is True
    np.testing.assert_array_equal(m["seeds"], meta["seeds"])

    # the chain form: rollback slots, (K,) accumulators, int64 keys, counter
    ck = VerletSGLDChains(num_data=10.0, momentum=0.9)
    cs = ck.init({n: v.expand(2, *v.shape) for n, v in params.items()},
                 seeds=[1, 2], save_state=True)
    cs.n_updates = 5
    save_chain_checkpoint(path, cs.state_arrays(), {}, cs.generators(), {})
    other = ck.init({n: v.expand(2, *v.shape) for n, v in params.items()},
                    seeds=[8, 9], save_state=True)
    arrays, _, states, _ = load_chain_checkpoint(
        path, other.state_arrays(), {}, other.generators())
    assert arrays["keys"].dtype == np.int64
    other.load_state_arrays(arrays)
    assert other.n_updates == 5 and torch.equal(other.keys, cs.keys)
    for a, b in zip(other.saved, cs.saved):
        assert torch.equal(a, b)


def test_checkpoint_mismatches_raise(tmp_path):
    "shape, dtype, structure and generator-device mismatches refuse to load"
    path = str(tmp_path / "c.npz")
    gen = {"gen": torch.Generator()}
    save_chain_checkpoint(path, {"a": torch.zeros(3)}, {}, gen, {})
    with pytest.raises(ValueError, match="shape"):
        load_chain_checkpoint(path, {"a": torch.zeros(4)}, {}, gen)
    with pytest.raises(ValueError, match="dtype"):
        load_chain_checkpoint(path, {"a": torch.zeros(3, dtype=torch.float64)},
                              {}, gen)
    with pytest.raises(KeyError, match="structure mismatch"):
        load_chain_checkpoint(path, {"a": torch.zeros(3),
                                     "b": torch.zeros(2)}, {}, gen)
    with pytest.raises(KeyError, match="structure mismatch"):
        load_chain_checkpoint(path, {}, {}, gen)
    with pytest.raises(KeyError, match="structure mismatch"):
        load_chain_checkpoint(path, {"a": torch.zeros(3)}, {},
                              {"gen": torch.Generator(),
                               "other": torch.Generator()})
    # a card's generator state does not load into a CPU generator (or back)
    np.savez(path, **{"chain.a": np.zeros(3, np.float32),
                      "gen.cuda.gen": np.zeros(16, np.uint8)})
    with pytest.raises(ValueError, match="saved on cuda"):
        load_chain_checkpoint(path, {"a": torch.zeros(3)}, {}, gen)


def test_failed_write_keeps_the_previous_file(tmp_path, monkeypatch):
    path = tmp_path / "c.npz"
    gen = {"gen": torch.Generator()}
    save_chain_checkpoint(str(path), {"a": torch.ones(3)}, {}, gen,
                          {"step": 1})

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        save_chain_checkpoint(str(path), {"a": torch.zeros(3)}, {}, gen,
                              {"step": 2})
    monkeypatch.undo()
    arrays, _, _, meta = load_chain_checkpoint(str(path),
                                               {"a": torch.ones(3)}, {}, gen)
    np.testing.assert_array_equal(arrays["a"], 1.0)
    assert int(meta["step"]) == 1
    assert [p.name for p in tmp_path.iterdir()] == ["c.npz"]


def test_a_mismatched_runner_refuses_the_file(data, tmp_path):
    "a ResNet-8 runner's checkpoint does not load into a ResNet-14's"
    path = str(tmp_path / "chain.ckpt.npz")
    _runner(VerletSGLDRunnerReject, data).save_checkpoint(path, 1, 5)
    model = models.ResNet(depth=14)
    other = VerletSGLDRunnerReject(model, data.norm.train, data.norm.test,
                                   reject_samples=True, device="cpu", **RUN)
    before = other.chain.position.clone()
    with pytest.raises(ValueError, match="identical model/config"):
        other.run(resume_from=path)
    assert torch.equal(other.chain.position, before)
