"""Posterior-predictive evaluation: ensembles and calibration (OOD and
the marginal likelihood are not ported yet)."""
from .calibration import ace, ece, gce, rmsce, sce, tace
from .metrics import evaluate_model, reject_samples_, split_sample_bank

__all__ = ("ace", "ece", "gce", "rmsce", "sce", "tace", "evaluate_model",
           "reject_samples_", "split_sample_bank")
