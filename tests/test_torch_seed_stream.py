"""The single-chain `(T,)` update's noise seeds: a 62-bit Philox key drawn
once at `init` and a count of the chain's updates, so update n draws with
seed key + n (the chain form's scheme, `VerletSGLDChains`). No update
draws a seed from a host generator, no two updates of a chain share a
stream, and key and counter travel in the checkpoint; a checkpoint written
before they existed is refused by name."""
import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch.io import (load_chain_checkpoint,
                                     restore_chain_checkpoint,
                                     save_chain_checkpoint)
from bnn_priors_tpu_torch.mcmc import HMC, SGLD, VerletSGLD
from bnn_priors_tpu_torch.ops import fused_update
from bnn_priors_tpu_torch.ops.fused_update import philox_normals
from test_torch_models import torch_threads_per_worker  # noqa: F401

PARAMS = {"b": torch.arange(5.0), "a": torch.linspace(-1, 1, 2000)}


@pytest.fixture
def seeds(monkeypatch):
    "the seed of every (T,) update the plain version runs, in order"
    out = []
    real = fused_update.fused_langevin_update_reference

    def spy(theta, momentum, square_avg, grads, precond, seed, *a, **kw):
        out.append(seed)
        return real(theta, momentum, square_avg, grads, precond, seed, *a,
                    **kw)
    monkeypatch.setattr(fused_update, "fused_langevin_update_reference", spy)
    return out


def _grads(state, k):
    g = torch.Generator().manual_seed(100 + k)
    return torch.randn(state.position.shape, generator=g) * (
        state.position != 0).to(torch.float32)


@pytest.mark.parametrize("kernel", [SGLD(10.0, momentum=0.9),
                                    VerletSGLD(10.0, momentum=0.9),
                                    HMC(10.0)],
                         ids=["SGLD", "VerletSGLD", "HMC"])
def test_update_n_draws_with_key_plus_n(kernel, seeds):
    state = kernel.init(PARAMS, seed=3)
    assert 0 <= state.key < 2 ** 62 and state.n_updates == 0
    host = state.gen.get_state()
    steps = [kernel.initial_step, kernel.step, kernel.step, kernel.step,
             kernel.final_step]
    if isinstance(kernel, SGLD) and not isinstance(kernel, VerletSGLD):
        steps = [kernel.step] * 5
    for k, step in enumerate(steps):
        state, _ = step(state, _grads(state, k), 1e-3, 1.0)
    n = len(seeds)
    assert seeds == [state.key + i for i in range(n)] and n >= 4
    assert state.n_updates == n
    # no host draw on the update path: the host generator did not move
    assert torch.equal(state.gen.get_state(), host)
    # another chain seed, another key
    assert kernel.init(PARAMS, seed=4).key != state.key


def test_update_adds_the_stream_of_key_plus_n():
    "update n's noise is philox_normals(key + n), the kernel's stream"
    kernel = SGLD(10.0, momentum=0.0)
    state = kernel.init(PARAMS, seed=5)
    pk = kernel.packer
    grads = torch.zeros_like(state.position)
    for n in range(3):
        before = state.momentum.clone()
        state, _ = kernel.step(state, grads, 1e-3, 2.0)
        xi = philox_normals(torch.tensor([state.key + n]),
                            pk.total_padded)[0]
        xi[pk.total:] = 0.0
        sigma = (2.0 * 2.0) ** 0.5  # sqrt(2 (1 - a) T) at a = 0
        torch.testing.assert_close(state.momentum, sigma * xi + 0 * before,
                                   rtol=1e-6, atol=1e-6)


def test_key_and_counter_round_trip_and_resume(tmp_path):
    "key and counter restore, and the resumed chain repeats bit for bit"
    kernel = VerletSGLD(10.0, momentum=0.9)
    state = kernel.init(PARAMS, seed=6, save_state=True)
    state, _ = kernel.initial_step(state, _grads(state, 0), 1e-3, 1.0)
    path = str(tmp_path / "chain.ckpt.npz")
    save_chain_checkpoint(path, state.state_arrays(), {}, state.generators(),
                          {})
    fresh = kernel.init(PARAMS, seed=99, save_state=True)
    assert fresh.key != state.key
    restore_chain_checkpoint(path, fresh, {}, fresh.generators())
    assert (fresh.key, fresh.n_updates) == (state.key, state.n_updates) \
        == (state.key, 1)
    arrays = np.load(path)
    assert arrays["chain.key"].dtype == np.int64
    for k in range(1, 4):
        state, _ = kernel.step(state, _grads(state, k), 1e-3, 1.0)
        fresh, _ = kernel.step(fresh, _grads(fresh, k), 1e-3, 1.0)
    assert torch.equal(state.position, fresh.position)
    assert torch.equal(state.momentum, fresh.momentum)


@pytest.mark.parametrize("missing", ["key", "n_updates"])
def test_a_checkpoint_without_key_or_counter_is_refused(tmp_path, missing):
    """a file of the earlier format (no chain.key, no chain.n_updates) is
    refused with the missing field's name, not loaded with a made-up key"""
    kernel = VerletSGLD(10.0, momentum=0.9)
    state = kernel.init(PARAMS, seed=7, save_state=True)
    old = {k: v for k, v in state.state_arrays().items() if k != missing}
    path = str(tmp_path / "old.ckpt.npz")
    save_chain_checkpoint(path, old, {}, state.generators(), {})
    fresh = kernel.init(PARAMS, seed=8, save_state=True)
    key = fresh.key
    with pytest.raises(KeyError, match=f"chain.{missing}"):
        load_chain_checkpoint(path, fresh.state_arrays(), {},
                              fresh.generators())
    with pytest.raises(KeyError, match=f"chain.{missing}"):
        restore_chain_checkpoint(path, fresh, {}, fresh.generators())
    assert fresh.key == key and fresh.n_updates == 0
