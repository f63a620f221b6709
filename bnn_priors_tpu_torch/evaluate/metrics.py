"""Posterior-predictive evaluation over a sample bank, for classification
and regression models (counterpart of `bnn_priors_tpu/evaluate/metrics.py`).

The JAX package runs one jitted scan over the samples (and, inside, over
the test batches). Here the bank goes through the chain forward
(`Model.net_apply_chains`) in groups of `SAMPLE_GROUP` samples: a group is
one network pass a test batch, each sample with its own parameters and
batchnorm buffers, in eval mode. Test batches are `batch_size` points with
a ragged last batch of its true size. A group's log-probs and predictions
come back to the host once, not once a sample and batch.

Metric semantics match the reference exactly:
  * ensemble log-prob  = mean_n [ logsumexp_e lps[e,n] − log E ]
  * ensemble prediction: classification — logsumexp of *normalized*
    logits over samples − log E (the mean predictive distribution);
    regression — the mean of the samples' means, whose squared error
    `acc_ensemble` holds, as `acc_last` the last sample's
    (exp_utils.py:300-321)
  * ece/ace/rmsce on the ensemble probabilities (classification only)
  * OOD score = max class probability of the sample-averaged softmax
    (exp_utils.py:343-380): AUROC/AUPRC of in-distribution (label 1)
    against OOD (label 0), computed here in numpy with sklearn's semantics
    (`roc_auc_score`, `average_precision_score`), which the JAX package
    calls, so the port does not need sklearn
  * simple log-marginal-likelihood from the samples' log priors
    (exp_utils.py:383-406)
"""
from __future__ import annotations

import copy
import math
from typing import Dict

import numpy as np
import torch

from ..models.base import ClassificationModel
from .calibration import ace, ece, rmsce

# samples a network pass. On an H100 in f32 the pass is the convolutions'
# work whatever the group: over 300 ResNet-20 samples and 10,000 points
# one sample a pass took 42 s, 8 to 32 took 44-45 s and 4 took 94 s
# (eval_group_sweep.py; PERF.md §5)
SAMPLE_GROUP = 1


def _n_samples(samples: Dict[str, np.ndarray]) -> int:
    return min(len(v) for v in samples.values())


def split_sample_bank(model, samples):
    """split a stacked state_dict bank into (params_bank, state_bank): the
    model's parameters, and the rest but `steps`/`timestamps` (its
    buffers)"""
    param_keys = set(dict(model.named_parameters()))
    params_bank = {k: v for k, v in samples.items() if k in param_keys}
    state_bank = {k: v for k, v in samples.items()
                  if k not in param_keys and k not in ("steps", "timestamps")}
    return params_bank, state_bank


@torch.no_grad()
def _predict_all(model, x, y, samples, batch_size=512, mesh=None):
    """Per-sample predictions over the full test set, as host float64
    arrays (lps[E, N], preds[E, N, C]); preds are normalized log-probs for
    classification, the means for regression (any model but a
    classification one is scored as a regression, as in the JAX package:
    a prior-only model's predictions are its inputs, its log-probs 0).
    Every bank entry takes the dtype of the model's own tensor of that
    name (the JAX package keeps `num_batches_tracked` as int32).

    `mesh` (a one-axis `parallel.distributed.DeviceMesh` of this process's
    devices) splits the bank over its positions: the bank is padded with
    its last sample to a multiple of the positions, each position predicts
    its own contiguous share on its device (with a copy of the model), in
    `SAMPLE_GROUP` passes, the positions' passes one after another before
    their results come to the host, and the padding is trimmed
    (metrics.py:56-150)."""
    regression = not isinstance(model, ClassificationModel)
    E = _n_samples(samples)
    params_bank, state_bank = split_sample_bank(model, samples)
    ours = model.state_dict()
    missing = set(ours) - set(params_bank) - set(state_bank)
    if missing:
        raise KeyError(f"the sample bank lacks {sorted(missing)}")
    here = next(model.parameters()).device
    devices = [here] if mesh is None else mesh.devices
    per = -(-E // len(devices))
    # each position's model and its share of the (padded) bank
    shares = []
    for i, dev in enumerate(devices):
        m = model if dev == here else copy.deepcopy(model).to(dev)
        shares.append((m, dev, [min(s, E - 1) for s in
                                range(i * per, (i + 1) * per)]))
    xs = {dev: torch.as_tensor(x, device=dev) for dev in devices}
    ys = {dev: torch.as_tensor(y, device=dev) for dev in devices}
    n = int(next(iter(xs.values())).shape[0])
    B = min(int(batch_size), n)

    def predict(m, dev, idx):
        "the samples `idx`' (lps, preds) on `dev`, one pass a test batch"
        take = lambda bank: {
            k: torch.as_tensor(np.ascontiguousarray(v[idx])).to(
                dev, ours[k].dtype) for k, v in bank.items() if k in ours}
        params, buffers = take(params_bank), take(state_bank)
        G = len(idx)
        lps, preds = [], []
        for b0 in range(0, n, B):
            xb, yb = xs[dev][b0:b0 + B], ys[dev][b0:b0 + B]
            f = m.net_apply_chains(params, buffers, xb.expand(G, *xb.shape),
                                   train=False)
            yg = yb.expand(G, *yb.shape)
            if regression:
                lps.append(m.likelihood_log_prob(f, yg, params))
                preds.append(f)
                continue
            logp = torch.log_softmax(m._logits(f), dim=-1)
            lps.append(torch.gather(logp, -1, yg[..., None])[..., 0])
            preds.append(logp)
        return torch.cat(lps, dim=1), torch.cat(preds, dim=1)

    out = [([], []) for _ in shares]
    for s0 in range(0, per, SAMPLE_GROUP):
        parts = [predict(m, dev, idx[s0:s0 + SAMPLE_GROUP])
                 for m, dev, idx in shares]
        for (lps_all, preds_all), (lps, preds) in zip(out, parts):
            lps_all.append(lps.double().cpu().numpy())
            preds_all.append(preds.double().cpu().numpy())
    lps = np.concatenate([a for lps_all, _ in out for a in lps_all])
    preds = np.concatenate([a for _, preds_all in out for a in preds_all])
    return lps[:E], preds[:E]


def evaluate_model(model, test_data, samples, likelihood_eval=True,
                   accuracy_eval=True, calibration_eval=False,
                   batch_size=512, mesh=None):
    """Reference `evaluate_model` (exp_utils.py:250-340) over a sample bank
    ({name: (E, ...)} numpy arrays, e.g. `load_samples`); runs on the
    model's device, or with `mesh` split over its devices (`_predict_all`)"""
    x, y = test_data
    lps, preds = _predict_all(model, x, y, samples, batch_size, mesh=mesh)
    E = lps.shape[0]
    labels = (y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y))

    lps_each_model = lps.mean(axis=1)
    lp_ensemble = float(
        (np.logaddexp.reduce(lps, axis=0) - math.log(E)).mean())
    regression = not isinstance(model, ClassificationModel)
    if regression:
        diff = preds.mean(axis=0) - labels
        acc_ensemble = float(np.einsum("nd,nd->n", diff, diff).mean())
        diff = preds[-1] - labels
        acc_last = float(np.einsum("nd,nd->n", diff, diff).mean())
    else:
        ens_logits = np.logaddexp.reduce(preds, axis=0) - math.log(E)
        ens_logp = ens_logits - np.logaddexp.reduce(ens_logits, axis=-1,
                                                    keepdims=True)
        acc_ensemble = float((np.argmax(ens_logp, -1) == labels).mean())
        acc_last = float((np.argmax(preds[-1], -1) == labels).mean())
        probs_mean = np.exp(ens_logp)

    results = {}
    if likelihood_eval:
        results["lp_ensemble"] = lp_ensemble
        results["lp_last"] = float(lps_each_model[-1])
    if accuracy_eval:
        results["acc_ensemble"] = acc_ensemble
        results["acc_last"] = acc_last
    if calibration_eval:
        if regression:
            raise ValueError("calibration metrics need classification")
        results["ece"] = float(ece(labels, probs_mean))
        results["ace"] = float(ace(labels, probs_mean))
        results["rmsce"] = float(rmsce(labels, probs_mean))
    return results


def _ranked_counts(y_true, y_score):
    """(true positives, false positives) at each distinct score, highest
    first: a threshold at each distinct score counts every point at or
    above it (sklearn's `_binary_clf_curve`)"""
    y_true = np.asarray(y_true).ravel() == 1
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    last = np.r_[np.flatnonzero(np.diff(y_score)), y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[last]
    return tps, 1.0 + last - tps


def roc_auc_score(y_true, y_score):
    """area under the ROC curve of binary labels (1 positive) by a score:
    the trapezoid over the curve's points at each distinct score, so a
    positive and a negative of equal score count ½ (as sklearn's)"""
    tps, fps = _ranked_counts(y_true, y_score)
    if tps[-1] == 0 or fps[-1] == 0:
        raise ValueError("AUROC needs both classes among the labels")
    tpr = np.r_[0.0, tps / tps[-1]]
    fpr = np.r_[0.0, fps / fps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def average_precision_score(y_true, y_score):
    """average precision of binary labels by a score: Σₙ (Rₙ − Rₙ₋₁)·Pₙ
    over the distinct scores from the highest, recall R and precision P at
    each, stepwise with no interpolation (as sklearn's)"""
    tps, fps = _ranked_counts(y_true, y_score)
    if tps[-1] == 0:
        raise ValueError("average precision needs a positive label")
    recall = np.r_[0.0, tps / tps[-1]]
    return float(np.sum(np.diff(recall) * (tps / (tps + fps))))


def ood_scores(model, x, samples, batch_size=512, mesh=None):
    """each point's max class probability of the sample-averaged softmax,
    float64 on the host (the OOD score, exp_utils.py:343-380)"""
    if not isinstance(model, ClassificationModel):
        raise ValueError("OOD eval needs a classification model")
    # the score reads no label: zeros stand in (the JAX package's for
    # missing or non-class targets)
    y = torch.zeros(x.shape[0], dtype=torch.int64)
    _, preds = _predict_all(model, x, y, samples, batch_size, mesh=mesh)
    return np.exp(preds).mean(axis=0).max(axis=-1)


def evaluate_ood(model, train_data, ood_data, samples, batch_size=512,
                 mesh=None):
    """AUROC/AUPRC of in-distribution (`train_data` = (x, y), label 1)
    against OOD (`ood_data`, label 0) by `ood_scores` (reference
    exp_utils.py:343-380); the sets' labels go unused"""
    ind = ood_scores(model, train_data[0], samples, batch_size, mesh)
    ood = ood_scores(model, ood_data[0], samples, batch_size, mesh)
    labels = np.r_[np.ones_like(ind), np.zeros_like(ood)]
    joint = np.r_[ind, ood]
    return {"auroc": roc_auc_score(labels, joint),
            "auprc": average_precision_score(labels, joint)}


@torch.no_grad()
def evaluate_marglik(model, train_samples, eval_samples):
    """simple log-marginal-likelihood estimate from the samples' log priors
    (reference exp_utils.py:383-406): sample i's entries of both banks (the
    eval bank's over the train bank's) give the model's log prior, read as
    a double. `simple_logmarglik` = logsumexp − log E; `mean_loglik` is the
    mean log *prior*, as the reference names it; `simple_marglik` the mean
    of exp(log prior), which overflows to inf as the reference's does"""
    E = _n_samples(train_samples)
    assert E == _n_samples(eval_samples)
    ours = model.params()
    log_priors = []
    for i in range(E):
        sd = {k: v[i] for k, v in train_samples.items() if k in ours}
        sd.update({k: v[i] for k, v in eval_samples.items() if k in ours})
        params = {k: torch.as_tensor(np.asarray(v)).to(ours[k])
                  for k, v in sd.items()}
        log_priors.append(float(model.log_prior(params)))
    log_priors = np.asarray(log_priors)
    with np.errstate(over="ignore"):
        simple_marglik = float(np.exp(log_priors).mean())
    return {
        "simple_logmarglik": float(
            np.logaddexp.reduce(log_priors) - math.log(E)),
        "mean_loglik": float(log_priors.mean()),
        "simple_marglik": simple_marglik,
    }


def reject_samples_(samples: Dict[str, np.ndarray], metrics) -> Dict:
    """Post-hoc rejected-sample resolution: replace each rejected sample
    with its predecessor, keyed by step index, using the `acceptance/*`
    metrics time series (reference exp_utils.py:565-580, with its
    use-before-assign bug fixed)."""
    if "acceptance/rejected" not in metrics or "steps" not in samples:
        return samples
    is_sample = np.asarray(metrics["acceptance/is_sample"]) == 1
    rejected_arr = np.asarray(metrics["acceptance/rejected"])[is_sample]
    metric_steps = np.asarray(metrics["steps"])[is_sample]
    rejected = {int(s): bool(r) for s, r in zip(metric_steps, rejected_arr)}
    for i in range(_n_samples(samples)):
        step = int(np.asarray(samples["steps"])[i])
        if rejected.get(step, False) and i > 0:
            for k in samples:
                samples[k][i] = samples[k][i - 1]
    return samples
