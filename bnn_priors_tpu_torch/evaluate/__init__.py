"""Posterior-predictive evaluation: ensembles, calibration, OOD detection
and the simple marginal likelihood."""
from .calibration import ace, ece, gce, rmsce, sce, tace
from .metrics import (average_precision_score, evaluate_marglik,
                      evaluate_model, evaluate_ood, ood_scores,
                      reject_samples_, roc_auc_score, split_sample_bank)

__all__ = ("ace", "ece", "gce", "rmsce", "sce", "tace",
           "average_precision_score", "evaluate_marglik", "evaluate_model",
           "evaluate_ood", "ood_scores", "reject_samples_", "roc_auc_score",
           "split_sample_bank")
