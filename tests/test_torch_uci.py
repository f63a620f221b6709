"""Dense regression across the two packages' checkpoints: the JAX
package's `VerletSGLDRunnerReject` on `densenet` (in its default hybrid
packing, whose small segment holds the 0-d `noise_std.p`) writes its
checkpoint after epoch 2 of two cycles; `interop.load_jax_checkpoint`
carries it into the port's flat and hybrid runners, which run to the end
and end where the JAX run ends (f64, temperature 0, one minibatch order).
The data are the bundled `UCI_yacht` split, cut to 72 training points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxRunner
from bnn_priors_tpu_torch import exp_utils
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.interop import load_jax_checkpoint

from test_torch_checkpoint_jax import _keep_each_checkpoint
from test_torch_mnist_models import _pair
from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_reject_runner import Recorder

N_TRAIN, BATCH = 72, 32  # 2 full batches + a tail of 8
RUN = dict(epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1, cycles=2,
           learning_rate=1e-3, momentum=0.9, precond_update=1,
           reject_samples=True, batch_size=BATCH, temperature=0.0)
PERM = np.random.RandomState(7).permutation(N_TRAIN)
RTOL, ATOL = 1e-8, 1e-12


def _yacht():
    "(train, test) numpy f64 arrays of the bundled split, train cut"
    d = exp_utils.get_data("UCI_yacht", device="cpu")
    train = tuple(t[:N_TRAIN].double().numpy() for t in d.norm.train)
    return train, tuple(t.double().numpy() for t in d.norm.test)


def _models():
    (x, y), _ = _yacht()
    jm, tm, params = _pair("densenet", x, y, width=8)
    return jm, tm, params


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    jm, _, params = _models()
    train, test = _yacht()
    path = str(tmp_path_factory.mktemp("jax") / "chain.ckpt.npz")
    rec = Recorder()
    jr = JaxRunner(jm, tuple(map(jnp.asarray, train)),
                   tuple(map(jnp.asarray, test)),
                   init_params={k: jnp.asarray(v) for k, v in params.items()},
                   init_model_state={}, key=jax.random.key(0),
                   packing="hybrid", metrics_saver=rec, checkpoint_path=path,
                   checkpoint_every=2, **RUN)
    jr._epoch_perm = lambda cycle, epoch: PERM
    _keep_each_checkpoint(jr)
    jr.run()
    return jr, rec, path + ".2"


@pytest.mark.parametrize("packing", ["flat", "hybrid"])
def test_a_jax_densenet_checkpoint_carries_across(jax_run, packing):
    jr, jrec, path = jax_run
    _, tm, _ = _models()
    train, test = _yacht()
    tr = VerletSGLDRunnerReject(tm, tuple(map(torch.as_tensor, train)),
                                tuple(map(torch.as_tensor, test)),
                                metrics_saver=Recorder(), seed=5,
                                device="cpu", packing=packing, **RUN)
    tr._epoch_perm = lambda cycle, epoch: PERM
    with np.load(path) as f:  # JAX's hybrid file: segments, not one vector
        assert f["chain_0"].shape != (tr.kernel.packer.flat_padded,)
    start = load_jax_checkpoint(path, tr)
    assert start == (2, 2 * 3)
    tr.run(resume_from=start)
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd) and jsd["noise_std.p"].shape == ()
    for k in jsd:
        np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tr.kernel.leaf_precond(tr.chain).numpy(),
                               np.asarray(jr.kernel.leaf_precond(jr.chain)),
                               rtol=RTOL, atol=ATOL)
    rows = {k: v for k, v in tr.metrics_saver.rows.items()
            if not k[0].startswith("timings/")}
    assert any(k[0] == "preconditioner/noise_std.p" for k in rows)
    bad = {k: (v, jrec.rows[k]) for k, v in rows.items()
           if not np.isclose(v, jrec.rows[k], rtol=RTOL, atol=ATOL)}
    assert not bad, list(bad.items())[:10]
