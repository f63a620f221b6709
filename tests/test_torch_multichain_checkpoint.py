"""K-chain checkpoints (`MultiChainRunnerReject.run(checkpoint_path=,
checkpoint_every=, resume_from=)`), mirroring
tests/test_multichain_checkpoint.py on the port: a resumed run continues
the same trajectory bit for bit, with the rollback slots, per-chain
generators and keys, base potentials, acceptance history, total energies
and the quarantine of a diverged chain.
"""
import warnings

import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_models import torch_threads_per_worker  # noqa: F401

K, N_TRAIN, N_TEST, BATCH = 3, 64, 16, 16
# four sampling epochs, an M-H boundary after each, at a step size large
# enough for T=1 chains to reject
RUN = dict(learning_rate=0.05, momentum=0.9, batch_size=BATCH, cycles=2,
           epochs_per_cycle=2, warmup_epochs=0, sample_epochs=2,
           precond_update=1, temperatures=[1.0, 0.3, 1.0],
           augment_fn=FakeCIFAR10.augment_fn)


def _make(seed=0):
    data = FakeCIFAR10(n_train=N_TRAIN, n_test=N_TEST, device="cpu")
    model = models.ResNet(depth=8)
    he_initialize(model, torch.Generator().manual_seed(seed))
    runner = MultiChainRunnerReject(model, data.norm.train, K,
                                    test_data=data.norm.test, seed=seed,
                                    device="cpu", **RUN)
    with torch.no_grad():  # chain 2 diverges: quarantined, the others go on
        runner.chains.position[2, :100] = float("nan")
    return runner


def _run(runner, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return runner.run(**kw)


def test_reject_runner_resume_bitwise(tmp_path):
    full = _make()
    hist = _run(full)
    half = _make()
    half.cycles = 1  # stop after epoch 2 of 4
    _run(half, checkpoint_path=tmp_path / "mid.npz", checkpoint_every=2)
    assert len(half.rejections) == 2 and half.nan_chains == {2}
    resumed = _make(seed=5)  # the file carries every seed
    rhist = _run(resumed, resume_from=tmp_path / "mid.npz")

    a, b = full.chains.state_arrays(), resumed.chains.state_arrays()
    assert set(a) == set(b) >= {"saved_position", "keys", "n_updates"}
    for k in a:
        np.testing.assert_array_equal(b[k].numpy(), a[k].numpy(), err_msg=k)
    for k, g in full.chains.generators().items():
        assert torch.equal(g.get_state(),
                           resumed.chains.generators()[k].get_state()), k
    for k, v in full.buffers.items():  # NaN in chain 2's equals NaN
        np.testing.assert_array_equal(resumed.buffers[k].numpy(), v.numpy(),
                                      err_msg=k)
    # acceptance history restored and continued; chain 1 at T=0.3 and the
    # quarantined chain 2 differ from chain 0
    assert len(resumed.rejections) == len(full.rejections) == 4
    rej = np.stack(full.rejections)
    np.testing.assert_array_equal(np.stack(resumed.rejections), rej)
    assert rej[:, 0].any()
    np.testing.assert_array_equal(np.stack(resumed.delta_energies),
                                  np.stack(full.delta_energies))
    np.testing.assert_array_equal(resumed._total_energies,
                                  full._total_energies)
    np.testing.assert_array_equal(resumed._initial_pots.numpy(),
                                  full._initial_pots.numpy())
    assert resumed.nan_chains == full.nan_chains == {2}
    # the resumed epochs' entries and samples are the uninterrupted run's
    assert len(rhist) == 2
    for t, f in zip(rhist, hist[2:]):
        assert set(t) == set(f)
        for k in f:
            np.testing.assert_array_equal(t[k], f[k], err_msg=k)
    assert len(resumed._samples) == 2 and len(full._samples) == 4
    for (p, bufs, step), (q, fbufs, fstep) in zip(resumed._samples,
                                                  full._samples[2:]):
        assert step == fstep
        np.testing.assert_array_equal(p, q)
        for k in bufs:
            np.testing.assert_array_equal(bufs[k], fbufs[k])


def test_a_checkpoint_of_other_chains_is_refused(tmp_path):
    "K=3 chains' file does not load into a K=2 runner"
    r = _make()
    r._initial_pots = r.chains.position.new_zeros(K)
    r.save_checkpoint(tmp_path / "c.npz", 1, 4)
    data = FakeCIFAR10(n_train=N_TRAIN, n_test=N_TEST, device="cpu")
    other = MultiChainRunnerReject(models.ResNet(depth=8), data.norm.train,
                                   2, device="cpu",
                                   **dict(RUN, temperatures=1.0))
    with pytest.raises(ValueError, match="shape"):
        other.run(resume_from=tmp_path / "c.npz")
