"""Empirical-Bayes priors: the hyperparameters get flat (PositiveImproper)
priors and are sampled by the MCMC kernel itself (counterpart of
`bnn_priors_tpu/priors/empirical_bayes.py`)."""
from __future__ import annotations

from .. import distributions as D
from .base import Prior
from .hierarchical import pinned
from .loc_scale import (ConvCorrelatedNormal, GenNorm, Laplace, Normal,
                        PositiveImproper, StudentT)

__all__ = (
    "NormalEmpirical", "LaplaceEmpirical", "StudentTEmpirical",
    "GenNormEmpirical", "ConvCorrNormalEmpirical", "flat_positive",
)


def flat_positive(value) -> Prior:
    "a flat positive hyper leaf, pinned at `value`"
    return pinned(PositiveImproper(shape=[], loc=value, scale=1.0),
                  D.inv_softplus(float(value)))


class ConvCorrNormalEmpirical(ConvCorrelatedNormal):
    def __init__(self, shape, loc, scale, lengthscale=1.0):
        super().__init__(shape, loc, scale=flat_positive(scale),
                         lengthscale=flat_positive(lengthscale))


class NormalEmpirical(Normal):
    def __init__(self, shape, loc, scale):
        super().__init__(shape, loc, flat_positive(scale))


class LaplaceEmpirical(Laplace):
    def __init__(self, shape, loc, scale):
        super().__init__(shape, loc, flat_positive(scale))


class StudentTEmpirical(StudentT):
    def __init__(self, shape, loc, scale, df=2.0):
        super().__init__(shape, loc, flat_positive(scale),
                         df=flat_positive(df))


class GenNormEmpirical(GenNorm):
    def __init__(self, shape, loc, scale, beta=0.5):
        super().__init__(shape, loc, flat_positive(scale),
                         beta=flat_positive(beta))
