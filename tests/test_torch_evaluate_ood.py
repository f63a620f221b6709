"""OOD detection and the simple marginal likelihood: the port's numpy
`roc_auc_score` and `average_precision_score` against sklearn's (which the
JAX package calls; the port does without sklearn) to 1e-12, ties included;
`evaluate_ood` and `evaluate_marglik` against the JAX package's on a bank
of four depth-8 ResNet samples in float64 at rtol 1e-9. The bank is one
dict of numpy arrays under the names both packages share (a JAX-written
sample file reads into the port unchanged), and a case whose
`simple_marglik` overflows to inf in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics
import torch

from bnn_priors_tpu.evaluate import metrics as jax_metrics
from bnn_priors_tpu.models import google_resnet as jax_gr
from bnn_priors_tpu_torch import evaluate, exp_utils, models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.evaluate import metrics

from test_torch_models import torch_threads_per_worker  # noqa: F401

E, BATCH = 4, 8
RTOL = 1e-9


def _scores(kind, rng):
    "(labels, scores) of a kind of ranking problem"
    if kind == "random":
        y = rng.randint(0, 2, 300)
        return y, rng.rand(300)
    if kind == "heavy_ties":  # five score values, a saturated softmax's 1.0
        y = rng.randint(0, 2, 400)
        return y, np.where(rng.rand(400) < 0.4, 1.0,
                           rng.randint(0, 4, 400) / 4.0)
    if kind == "all_equal":
        return rng.randint(0, 2, 50), np.full(50, 0.7)
    if kind == "unequal_classes":  # 10 positives against 500 negatives
        y = np.r_[np.ones(10, int), np.zeros(500, int)]
        s = np.r_[rng.rand(10) + 0.3, rng.rand(500)]
        return y, np.round(s, 2)  # with ties across the classes
    raise ValueError(kind)


KINDS = ("random", "heavy_ties", "all_equal", "unequal_classes")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["roc_auc_score", "average_precision_score"])
def test_ranking_scores_match_sklearn(name, kind):
    """AUROC with tied pairs at ½, AP as Σ (Rₙ − Rₙ₋₁)·Pₙ over distinct
    thresholds with no interpolation: equal to sklearn's to 1e-12"""
    rng = np.random.RandomState(KINDS.index(kind))
    for _ in range(5):
        y, s = _scores(kind, rng)
        ours = getattr(evaluate, name)(y, s)
        theirs = getattr(sklearn.metrics, name)(y, s)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)
    if kind == "all_equal":
        assert evaluate.roc_auc_score(y, s) == 0.5


def test_ranking_scores_need_both_classes():
    with pytest.raises(ValueError, match="both classes"):
        evaluate.roc_auc_score(np.ones(5), np.arange(5.0))
    with pytest.raises(ValueError, match="positive"):
        evaluate.average_precision_score(np.zeros(5), np.arange(5.0))


def _bank(scale=1.0, seed=3):
    """E samples of a depth-8 ResNet in f64: He weights (times `scale`)
    plus seeded perturbations, batchnorm buffers varied a sample, and the
    sample file's `steps`. The port draws the He init (a JAX init costs
    seconds of eager dispatch); the names are both packages'."""
    model = exp_utils.he_initialize(models.ResNet(depth=8).to(torch.float64),
                                    torch.Generator().manual_seed(1))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        v = v.numpy()
        if k.endswith("num_batches_tracked"):
            out[k] = np.stack([v + 10 * e for e in range(E)])
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, (E,) + v.shape)
        elif k.endswith("running_mean"):
            out[k] = 0.3 * rng.randn(E, *v.shape)
        else:
            sd = max(float(np.abs(v).std()), 0.05)
            out[k] = scale * (v + 0.3 * sd * rng.randn(E, *v.shape))
    out["steps"] = np.asarray([5, 9, 13, 17])
    return out


@pytest.fixture(scope="module")
def bank():
    return _bank()


def _sets():
    """in-distribution: FakeCIFAR10's test points; OOD: another draw's,
    brightened (19 points: a ragged last batch)"""
    ind = FakeCIFAR10(dtype="float64", n_train=10, n_test=25, seed=4,
                      device="cpu").norm.test
    ood = FakeCIFAR10(dtype="float64", n_train=10, n_test=19, seed=9,
                      device="cpu").norm.test
    return (ind[0].numpy(), ind[1].numpy()), (ood[0].numpy() + 0.7,
                                              ood[1].numpy())


def _jax_scores(model, x, samples):
    "the JAX package's max-probability score a point (metrics.py:208-212)"
    _, preds, _ = jax_metrics._predict_all(
        model, jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32), samples,
        BATCH)
    return np.exp(np.asarray(preds, np.float64)).mean(0).max(-1)


@pytest.mark.parametrize("ood_labels", ["classes", "none", "float"])
def test_evaluate_ood_matches_jax(bank, ood_labels):
    """the scores a point and AUROC/AUPRC at rtol 1e-9; OOD labels that
    are missing or not class labels are read as zeros by both"""
    (xi, yi), (xo, yo) = _sets()
    yo = {"classes": yo, "none": None,
          "float": np.linspace(-1, 1, len(yo))}[ood_labels]
    jax_bank = {k: v for k, v in bank.items() if k != "steps"}
    jm = jax_gr.ResNet(depth=8)
    ref = jax_metrics.evaluate_ood(
        jm, (jnp.asarray(xi), jnp.asarray(yi)),
        (jnp.asarray(xo), None if yo is None else jnp.asarray(yo)), jax_bank,
        batch_size=BATCH)
    model = models.ResNet(depth=8).to(torch.float64)
    t = lambda a: None if a is None else torch.as_tensor(a)
    out = evaluate.evaluate_ood(model, (t(xi), t(yi)), (t(xo), t(yo)), bank,
                                batch_size=BATCH)
    assert set(out) == set(ref) == {"auroc", "auprc"}
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, err_msg=k)
        assert 0.0 <= out[k] <= 1.0
    for x in (xi, xo):
        np.testing.assert_allclose(
            evaluate.ood_scores(model, torch.as_tensor(x), bank, BATCH),
            _jax_scores(jm, x, jax_bank), rtol=RTOL)


def test_evaluate_ood_refuses_regression():
    model = models.DenseNet(4, 1, 8, 2).to(torch.float64)
    x = torch.zeros(3, 4, dtype=torch.float64)
    bank = {k: v.detach().numpy()[None] for k, v in model.params().items()}
    with pytest.raises(ValueError, match="classification"):
        evaluate.evaluate_ood(model, (x, None), (x, None), bank)


@pytest.mark.parametrize("case", ["underflow", "overflow"])
def test_evaluate_marglik_matches_jax(case):
    """the simple log-marginal-likelihood, the mean log prior (named
    `mean_loglik`, as in the reference) and the mean of exp(log prior) at
    rtol 1e-9. 'underflow': a prior of std 20 gives log priors of ~-3e5,
    whose exp is 0; 'overflow': samples near zero under a prior of std 0.01
    give ~+2.9e5, whose exp overflows to inf in both packages"""
    std = 0.01 if case == "overflow" else 20.0
    b = _bank(scale=1e-3 if case == "overflow" else 1.0)
    jm = jax_gr.ResNet(depth=8, std_w=std, std_b=std)
    with np.errstate(over="ignore"):
        ref = jax_metrics.evaluate_marglik(jm, b, b)
    model = models.ResNet(depth=8, std_w=std, std_b=std).to(torch.float64)
    out = evaluate.evaluate_marglik(model, b, b)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, err_msg=k)
    assert np.isfinite(out["simple_logmarglik"])
    if case == "overflow":
        assert out["mean_loglik"] > 1e5 and out["simple_marglik"] == np.inf
    else:
        assert out["mean_loglik"] < -1e5 and out["simple_marglik"] == 0.0


def test_marglik_eval_bank_overrides_train_bank():
    """sample i's eval-bank entries replace its train-bank entries before
    the log prior (metrics.py:228-231): the result is the eval bank's"""
    a, b = _bank(seed=3), _bank(seed=4)
    model = models.ResNet(depth=8).to(torch.float64)
    ours = evaluate.evaluate_marglik(model, a, b)
    np.testing.assert_allclose(ours["mean_loglik"],
                               evaluate.evaluate_marglik(model, b, b)[
                                   "mean_loglik"], rtol=RTOL)
    assert ours["mean_loglik"] != evaluate.evaluate_marglik(
        model, a, a)["mean_loglik"]
    with np.errstate(over="ignore"):
        ref = jax_metrics.evaluate_marglik(jax_gr.ResNet(depth=8), a, b)
    np.testing.assert_allclose(ours["mean_loglik"], ref["mean_loglik"],
                               rtol=RTOL)


def test_the_module_keeps_its_names():
    "the metrics module and the package export the same functions"
    for name in ("evaluate_ood", "evaluate_marglik", "ood_scores",
                 "roc_auc_score", "average_precision_score"):
        assert getattr(evaluate, name) is getattr(metrics, name)
