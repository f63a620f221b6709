"""General Calibration Error family: ece / sce / rmsce / ace / tace
(counterpart of `bnn_priors_tpu/evaluate/calibration.py`, a numpy copy of
its own).

Clean-room implementation of the calibration-error space of Nixon et al.
2019 ("Measuring Calibration in Deep Learning", arXiv:1904.01685), matching
the metric definitions used by the reference
(`bnn_priors/third_party/calibration_error.py`, from
google/uncertainty-metrics): even or adaptive (equal-count) binning,
optionally class-conditional, optionally max-prob only, thresholded, with
l1 or l2 norms. Host-side NumPy — these run once per evaluation on small
arrays.
"""
from __future__ import annotations

import numpy as np

__all__ = ("gce", "ece", "ace", "tace", "sce", "rmsce")


def _one_hot(labels, num_classes):
    return np.eye(num_classes)[np.asarray(labels, dtype=np.int64)]


def _adaptive_upper_edges(probs, num_bins):
    "upper bin edges giving (approximately) equal datapoint counts per bin"
    if probs.size == 0:
        return np.linspace(0, 1, num_bins + 1)[1:-1] if num_bins > 1 else np.array([])
    idx = np.linspace(0, len(probs), num_bins, endpoint=False)
    idx = np.minimum(np.round(idx).astype(int), len(probs) - 1)
    return np.sort(probs)[idx][1:]


def _binned_error(probs, hits, upper_edges, norm, num_bins):
    "Σ_bins weight·(acc-conf), under l1 or squared-l2"
    if probs.size == 0:
        return 0.0
    bins = np.digitize(probs, upper_edges)
    counts = np.bincount(bins, minlength=num_bins).astype(np.float64)
    conf = np.bincount(bins, weights=probs, minlength=num_bins) / (
        counts + np.finfo(np.float64).eps)
    acc = np.bincount(bins, weights=hits, minlength=num_bins) / (
        counts + np.finfo(np.float64).eps)
    weighted = (acc - conf) * (counts / probs.size)
    if norm == "l1":
        return float(np.sum(np.abs(weighted)))
    return float(np.sum(np.square(weighted)))


def gce(labels, probs, binning_scheme, max_prob, class_conditional, norm,
        num_bins=30, threshold=0.0, datapoints_per_bin=None):
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels)
    if probs.ndim == 2 and probs.shape[1] == 1:
        probs = probs[:, 0]
    if probs.ndim == 1:  # binary case
        probs = np.stack([1 - probs, probs], axis=1)
    if probs.ndim != 2:
        raise ValueError("probs must have 1 or 2 dimensions")
    num_classes = probs.shape[1]
    labels_matrix = _one_hot(labels, num_classes)

    if datapoints_per_bin is not None:
        if binning_scheme != "adaptive":
            raise ValueError("datapoints_per_bin requires adaptive binning")
        num_bins = int(len(probs) / datapoints_per_bin)

    if binning_scheme == "even":
        upper_edges = np.histogram_bin_edges([], bins=num_bins,
                                             range=(0.0, 1.0))[1:]

    def edges_for(p):
        if binning_scheme == "adaptive":
            return _adaptive_upper_edges(p, num_bins)
        return upper_edges

    if not class_conditional:
        if max_prob:
            top = np.argmax(probs, axis=1)
            hits = labels_matrix[np.arange(len(probs)), top]
            p = probs[np.arange(len(probs)), top]
        else:
            p = probs.flatten()
            hits = labels_matrix.flatten()
        hits = hits[p > threshold]
        p = p[p > threshold]
        error = _binned_error(p, hits, edges_for(p), norm, num_bins)
    else:
        error = 0.0
        for j in range(num_classes):
            if max_prob:
                sel = np.argmax(probs, axis=1) == j
                p = probs[sel, j]
                hits = labels_matrix[sel, j]
            else:
                p = probs[:, j]
                hits = labels_matrix[:, j]
            hits = hits[p > threshold]
            p = p[p > threshold]
            error += _binned_error(p, hits, edges_for(p), norm,
                                   num_bins) / num_classes

    if norm == "l2":
        error = float(np.sqrt(error))
    return error


def ece(labels, probs, num_bins=30):
    "Expected Calibration Error (Naeini et al. 2015)"
    return gce(labels, probs, binning_scheme="even", max_prob=True,
               class_conditional=False, norm="l1", num_bins=num_bins)


def rmsce(labels, probs, num_bins=30, datapoints_per_bin=100):
    "Root Mean Squared Calibration Error (Hendrycks et al. 2018)"
    return gce(labels, probs, binning_scheme="adaptive", max_prob=True,
               class_conditional=False, norm="l2", num_bins=num_bins,
               datapoints_per_bin=datapoints_per_bin)


def sce(labels, probs, num_bins=30):
    "Static Calibration Error"
    return gce(labels, probs, binning_scheme="even", max_prob=False,
               class_conditional=True, norm="l1", num_bins=num_bins)


def ace(labels, probs, num_bins=30):
    "Adaptive Calibration Error"
    return gce(labels, probs, binning_scheme="adaptive", max_prob=False,
               class_conditional=True, norm="l1", num_bins=num_bins)


def tace(labels, probs, num_bins=30, threshold=0.01):
    "Thresholded Adaptive Calibration Error"
    return gce(labels, probs, binning_scheme="adaptive", max_prob=False,
               class_conditional=True, norm="l1", num_bins=num_bins,
               threshold=threshold)
