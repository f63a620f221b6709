"""The port's posterior-predictive evaluation (`bnn_priors_tpu_torch/
evaluate`) against the JAX package's: the calibration family on seeded
probabilities, `evaluate_model` over a bank of depth-8 ResNet samples in
float64 (each sample with its own weights and batchnorm buffers, a test set
with a ragged last batch, sample groups with a ragged last group), and the
post-hoc `reject_samples_`."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.evaluate import calibration as jax_calibration
from bnn_priors_tpu.evaluate import metrics as jax_metrics
from bnn_priors_tpu.models import google_resnet as jax_gr
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.evaluate import calibration, metrics

from test_torch_models import torch_threads_per_worker  # noqa: F401

E, N_TEST, BATCH = 3, 25, 8


def seeded_probs(n=600, c=10, seed=0):
    rng = np.random.RandomState(seed)
    logits = 2.0 * rng.randn(n, c)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    return rng.randint(0, c, n), probs / probs.sum(1, keepdims=True)


@pytest.mark.parametrize("name", ["ece", "ace", "rmsce", "sce", "tace"])
@pytest.mark.parametrize("seed", [0, 1])
def test_calibration_matches_jax(name, seed):
    labels, probs = seeded_probs(seed=seed)
    port = getattr(calibration, name)(labels, probs)
    ref = getattr(jax_calibration, name)(labels, probs)
    np.testing.assert_allclose(port, ref, rtol=1e-12)
    assert 0.0 <= port <= 1.0


@pytest.mark.parametrize("kw", [
    dict(binning_scheme="even", max_prob=True, class_conditional=True,
         norm="l2", num_bins=7),
    dict(binning_scheme="adaptive", max_prob=False, class_conditional=False,
         norm="l1", threshold=0.05),
    dict(binning_scheme="adaptive", max_prob=True, class_conditional=False,
         norm="l2", datapoints_per_bin=40)])
def test_gce_matches_jax(kw):
    labels, probs = seeded_probs(seed=2)
    np.testing.assert_allclose(calibration.gce(labels, probs, **kw),
                               jax_calibration.gce(labels, probs, **kw),
                               rtol=1e-12)
    # the binary case: one probability a point
    p1 = probs[:, 0]
    np.testing.assert_allclose(calibration.gce(labels == 0, p1, **kw),
                               jax_calibration.gce(labels == 0, p1, **kw),
                               rtol=1e-12)


@pytest.fixture(scope="module")
def bank():
    """E samples of a depth-8 ResNet in f64: the JAX init with He weights
    plus seeded perturbations, and batchnorm buffers varied a sample"""
    params, state = jax_gr.ResNet(depth=8).init(jax.random.key(0),
                                                dtype=jnp.float64)
    params = jax_exp.he_initialize(params, jax.random.key(1))
    rng = np.random.RandomState(3)
    out = {}
    for k, v in {**params, **state}.items():
        v = np.asarray(v)
        if k.endswith("num_batches_tracked"):
            out[k] = np.stack([v + 10 * e for e in range(E)])
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, (E,) + v.shape)
        elif k.endswith("running_mean"):
            out[k] = 0.3 * rng.randn(E, *v.shape)
        else:
            scale = max(float(np.abs(v).std()), 0.05)
            out[k] = v + 0.3 * scale * rng.randn(E, *v.shape)
    out["steps"] = np.asarray([5, 9, 13])
    return out


@pytest.fixture(scope="module")
def test_set():
    data = FakeCIFAR10(dtype="float64", n_train=10, n_test=N_TEST, seed=4,
                       device="cpu")
    x, y = data.norm.test
    return x.numpy(), y.numpy()


@pytest.mark.parametrize("calibration_eval", [False, True])
def test_evaluate_model_matches_jax(bank, test_set, calibration_eval,
                                    monkeypatch):
    x, y = test_set
    ref = jax_metrics.evaluate_model(
        jax_gr.ResNet(depth=8), (jnp.asarray(x), jnp.asarray(y)),
        {k: v for k, v in bank.items() if k != "steps"}, batch_size=BATCH,
        calibration_eval=calibration_eval)
    model = models.ResNet(depth=8).to(torch.float64)
    own = metrics.SAMPLE_GROUP

    def evaluate(group):
        monkeypatch.setattr(metrics, "SAMPLE_GROUP", group)
        return metrics.evaluate_model(
            model, (torch.as_tensor(x), torch.as_tensor(y)), bank,
            batch_size=BATCH, calibration_eval=calibration_eval)
    # groups of 2 samples: the last group is ragged too
    out = evaluate(2)
    assert set(out) == set(ref)
    assert ({"ece", "ace", "rmsce"} <= set(out)) == calibration_eval
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-9, err_msg=k)
    # one sample a group, one group, and the module's own group size: the
    # same numbers
    for group in (1, E, own):
        again = evaluate(group)
        for k in ref:
            np.testing.assert_allclose(again[k], out[k], rtol=1e-12)


def test_evaluate_model_needs_the_whole_state(bank, test_set):
    x, y = test_set
    partial = {k: v for k, v in bank.items() if "running_var" not in k}
    with pytest.raises(KeyError, match="running_var"):
        metrics.evaluate_model(models.ResNet(depth=8).to(torch.float64),
                               (torch.as_tensor(x), torch.as_tensor(y)),
                               partial)


def test_split_sample_bank_matches_jax(bank):
    port = metrics.split_sample_bank(models.ResNet(depth=8), bank)
    ref = jax_metrics.split_sample_bank(jax_gr.ResNet(depth=8), bank)
    for p, r in zip(port, ref):
        assert sorted(p) == sorted(r)


@pytest.mark.parametrize("rejected", [[0, 1, 1], [1, 0, 1], [0, 0, 0]])
def test_reject_samples_matches_jax(bank, rejected):
    # boundaries at steps 5, 9 and 13 (the samples' steps) among other rows
    steps = np.arange(15)
    is_sample = np.isin(steps, bank["steps"]).astype(np.int64)
    rej = np.zeros(15, np.int64)
    rej[bank["steps"]] = rejected
    m = {"steps": steps, "acceptance/is_sample": is_sample,
         "acceptance/rejected": rej}
    port = metrics.reject_samples_(copy.deepcopy(bank), m)
    ref = jax_metrics.reject_samples_(copy.deepcopy(bank), m)
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    # a rejected sample (not the first) is its predecessor
    w = "net.0.weight_prior.p"
    for i, r in enumerate(rejected):
        src = i - 1 if r and i > 0 else i
        if not (r and i > 0):
            np.testing.assert_array_equal(port[w][i], bank[w][i])
        else:
            np.testing.assert_array_equal(port[w][i], port[w][src])
    # without the acceptance series the bank is left as it is
    same = metrics.reject_samples_(copy.deepcopy(bank), {"steps": steps})
    np.testing.assert_array_equal(same[w], bank[w])
