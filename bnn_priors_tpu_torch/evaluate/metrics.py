"""Posterior-predictive evaluation over a sample bank (counterpart of
`bnn_priors_tpu/evaluate/metrics.py`; OOD and the marginal likelihood are
not ported yet).

The JAX package runs one jitted scan over the samples (and, inside, over
the test batches). Here the bank goes through the chain forward
(`Model.net_apply_chains`) in groups of `SAMPLE_GROUP` samples: a group is
one network pass a test batch, each sample with its own parameters and
batchnorm buffers, in eval mode. Test batches are `batch_size` points with
a ragged last batch of its true size. A group's log-probs and predictions
come back to the host once, not once a sample and batch.

Metric semantics match the reference exactly:
  * ensemble log-prob  = mean_n [ logsumexp_e lps[e,n] − log E ]
  * ensemble prediction: logsumexp of *normalized* logits over samples −
    log E (the mean predictive distribution), exp_utils.py:300-321
  * ece/ace/rmsce on the ensemble probabilities
"""
from __future__ import annotations

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
def _predict_all(model, x, y, samples, batch_size=512):
    """Per-sample predictions over the full test set, as host float64
    arrays (lps[E, N], preds[E, N, C]); preds are normalized log-probs.
    Every bank entry takes the dtype of the model's own tensor of that
    name (the JAX package keeps `num_batches_tracked` as int32)."""
    if not isinstance(model, ClassificationModel):
        raise NotImplementedError("only classification models are ported")
    E = _n_samples(samples)
    params_bank, state_bank = split_sample_bank(model, samples)
    ours = model.state_dict()
    missing = set(ours) - set(params_bank) - set(state_bank)
    if missing:
        raise KeyError(f"the sample bank lacks {sorted(missing)}")
    dev = next(model.parameters()).device
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    n = int(x.shape[0])
    B = min(int(batch_size), n)
    lps_all, preds_all = [], []
    for s0 in range(0, E, SAMPLE_GROUP):
        s1 = min(s0 + SAMPLE_GROUP, E)
        G = s1 - s0
        take = lambda bank: {
            k: torch.as_tensor(np.ascontiguousarray(v[s0:s1])).to(
                dev, ours[k].dtype) for k, v in bank.items() if k in ours}
        params, buffers = take(params_bank), take(state_bank)
        lps, preds = [], []
        for b0 in range(0, n, B):
            xb, yb = x[b0:b0 + B], y[b0:b0 + B]
            f = model.net_apply_chains(params, buffers,
                                       xb.expand(G, *xb.shape), train=False)
            logp = torch.log_softmax(model._logits(f), dim=-1)
            lps.append(torch.gather(
                logp, -1, yb.expand(G, *yb.shape)[..., None])[..., 0])
            preds.append(logp)
        lps_all.append(torch.cat(lps, dim=1).double().cpu().numpy())
        preds_all.append(torch.cat(preds, dim=1).double().cpu().numpy())
    return np.concatenate(lps_all), np.concatenate(preds_all)


def evaluate_model(model, test_data, samples, likelihood_eval=True,
                   accuracy_eval=True, calibration_eval=False,
                   batch_size=512):
    """Reference `evaluate_model` (exp_utils.py:250-340) over a sample bank
    ({name: (E, ...)} numpy arrays, e.g. `load_samples`); runs on the
    model's device"""
    x, y = test_data
    lps, preds = _predict_all(model, x, y, samples, batch_size)
    E = lps.shape[0]
    labels = (y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y))

    lps_each_model = lps.mean(axis=1)
    lp_ensemble = float(
        (np.logaddexp.reduce(lps, axis=0) - math.log(E)).mean())
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
        results["ece"] = float(ece(labels, probs_mean))
        results["ace"] = float(ace(labels, probs_mean))
        results["rmsce"] = float(rmsce(labels, probs_mean))
    return results


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
