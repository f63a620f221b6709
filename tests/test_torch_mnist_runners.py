"""The port's single-chain runner on the new models against the JAX
package's, step for step: `VerletSGLDRunnerReject` (GGMC with exact M-H) in
f64 at temperature 0 on the small CNN (8x8 images, width 4) and on
`densenet` with its sampled `noise_std.p`, from the same parameters and in
the same minibatch order, in the flat, segmented and hybrid states; then
`evaluate_model`'s regression branch on a bank against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.evaluate import evaluate_model as jax_evaluate
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxRunner
from bnn_priors_tpu_torch.evaluate import evaluate_model
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.ops import fused_update

from test_torch_mnist_models import _data, _pair
from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_reject_runner import Recorder

# 3 full batches + a tail of 4, one cycle of 3 epochs (1 warmup, 2 sampling)
N_TRAIN, N_TEST, BATCH = 100, 25, 32
RUN = dict(epochs_per_cycle=3, warmup_epochs=1, sample_epochs=2,
           learning_rate=1e-3, momentum=0.9, precond_update=1,
           reject_samples=True, batch_size=BATCH)
MODELS = ("classificationconvnet", "densenet")
PERM = np.random.RandomState(7).permutation(N_TRAIN)


def _setup(name):
    """(JAX model, port model, He-initialised params as numpy, train and
    test data as numpy)"""
    x, y = _data(name, n=N_TRAIN + N_TEST, seed=3)
    jm, tm, _ = _pair(name, x[:N_TRAIN], y[:N_TRAIN])
    he_initialize(tm, torch.Generator().manual_seed(1))
    params = {k: v.detach().numpy().copy() for k, v in tm.params().items()}
    return jm, tm, params, ((x[:N_TRAIN], y[:N_TRAIN]),
                            (x[N_TRAIN:], y[N_TRAIN:]))


@pytest.fixture(scope="module")
def jax_runs():
    "the JAX runner on each model, once a module"
    out = {}
    for name in MODELS:
        jm, _, params, (train, test) = _setup(name)
        rec = Recorder()
        jr = JaxRunner(jm, tuple(map(jnp.asarray, train)),
                       tuple(map(jnp.asarray, test)), temperature=0.0,
                       init_params={k: jnp.asarray(v) for k, v in
                                    params.items()},
                       init_model_state={}, key=jax.random.key(0),
                       packing="flat", metrics_saver=rec, **RUN)
        jr._epoch_perm = lambda cycle, epoch: PERM
        jr.run()
        out[name] = (jr, rec)
    return out


@pytest.mark.parametrize("packing", ["flat", "segmented", "hybrid"])
@pytest.mark.parametrize("name", MODELS)
def test_reject_runner_matches_jax_step_for_step(jax_runs, name, packing):
    """every logged number (potentials, losses, per-leaf diagnostics,
    boundary ΔE and decisions, test metrics), the final state and the
    sample bank at rtol 1e-8"""
    jr, jrec = jax_runs[name]
    _, tm, params, (train, test) = _setup(name)
    trec = Recorder()
    tr = VerletSGLDRunnerReject(
        tm, tuple(map(torch.as_tensor, train)),
        tuple(map(torch.as_tensor, test)), temperature=0.0,
        metrics_saver=trec, device="cpu", packing=packing, **RUN)
    tr._epoch_perm = lambda cycle, epoch: PERM
    assert tr.kernel.packer.names == jr.kernel.packer.names
    before = fused_update.launches + fused_update.segments_launches
    tr.run()
    # the CPU runs the plain versions
    assert fused_update.launches + fused_update.segments_launches == before
    keys = {k for k in jrec.rows if not k[0].startswith("timings/")}
    assert keys == {k for k in trec.rows if not k[0].startswith("timings/")}
    names = {k[0] for k in keys}
    assert {"potential", "delta_energy", "acceptance/rejected", "test/acc",
            "test/loss"} <= names
    if name == "densenet":
        assert "preconditioner/noise_std.p" in names
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
    assert set(ts) == set(js)
    np.testing.assert_array_equal(ts["steps"], js["steps"])
    for k in js:
        assert ts[k].shape[0] == 2
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", ["densenet", "linear"])
def test_evaluate_regression_matches_jax(name, monkeypatch):
    """lp_ensemble, lp_last and the squared errors acc_ensemble and
    acc_last of a 3-sample bank (the port in groups of 2 samples, with a
    ragged last test batch); calibration refuses a regression model"""
    from bnn_priors_tpu_torch.evaluate import metrics
    monkeypatch.setattr(metrics, "SAMPLE_GROUP", 2)
    x, y = _data(name, n=30, seed=5)
    jm, tm, _ = _pair(name, x, y)
    bank = {}
    for s in range(3):
        tm.init(torch.Generator().manual_seed(10 + s))
        for k, v in tm.state_dict().items():
            bank.setdefault(k, []).append(v.numpy().copy())
    bank = {k: np.stack(v) for k, v in bank.items()}
    ours = evaluate_model(tm, (torch.as_tensor(x), torch.as_tensor(y)), bank,
                          batch_size=8)
    theirs = jax_evaluate(jm, (jnp.asarray(x), jnp.asarray(y)), bank,
                          batch_size=8)
    assert set(ours) == set(theirs) == {"lp_ensemble", "lp_last",
                                        "acc_ensemble", "acc_last"}
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-9, err_msg=k)
    with pytest.raises(ValueError, match="classification"):
        evaluate_model(tm, (torch.as_tensor(x), torch.as_tensor(y)), bank,
                       calibration_eval=True)
