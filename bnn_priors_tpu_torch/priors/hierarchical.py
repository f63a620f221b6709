"""Hierarchical priors: the scale (and sometimes shape) hyperparameter is
itself a prior leaf (counterpart of `bnn_priors_tpu/priors/hierarchical.py`).

Each constructor pins the hyper-leaf's initial value so chains start at the
nominal scale, like the reference's `p.data = inv_softplus(scale)`.
"""
from __future__ import annotations

import numpy as np

from .. import distributions as D
from .base import Prior
from .loc_scale import ConvCorrelatedNormal, GenNorm, Laplace, Normal, StudentT
from .transformed import Gamma, HalfCauchy, Uniform

__all__ = (
    "NormalGamma", "NormalUniform", "Horseshoe", "LaplaceGamma",
    "LaplaceUniform", "StudentTGamma", "StudentTUniform", "GenNormUniform",
    "ConvCorrNormalGamma",
)


def pinned(prior: Prior, value) -> Prior:
    prior.pinned_init = np.asarray(value, dtype=np.float64)
    return prior


def _gamma_scale(scale, rate):
    return pinned(Gamma(shape=[], concentration=scale, rate=rate),
                  D.inv_softplus(float(scale)))


def _uniform_scale(scale):
    return pinned(Uniform(shape=[], low=0.0, high=scale * 2.0), 0.0)


class NormalGamma(Normal):
    def __init__(self, shape, loc, scale, rate=1.0, gradient_clip=1.0):
        super().__init__(shape, loc, _gamma_scale(scale, rate))


class NormalUniform(Normal):
    def __init__(self, shape, loc, scale, gradient_clip=1.0):
        super().__init__(shape, loc, _uniform_scale(scale))


class ConvCorrNormalGamma(ConvCorrelatedNormal):
    def __init__(self, shape, loc, scale, lengthscale=1.0, rate=1.0):
        super().__init__(shape, loc, scale=_gamma_scale(scale, rate),
                         lengthscale=_gamma_scale(lengthscale, rate))


class LaplaceGamma(Laplace):
    def __init__(self, shape, loc, scale, rate=1.0, gradient_clip=1.0):
        super().__init__(shape, loc, _gamma_scale(scale, rate))


class LaplaceUniform(Laplace):
    def __init__(self, shape, loc, scale, gradient_clip=1.0):
        super().__init__(shape, loc, _uniform_scale(scale))


class StudentTGamma(StudentT):
    def __init__(self, shape, loc, scale, rate=1.0, df=2, gradient_clip=1.0):
        super().__init__(shape, loc, _gamma_scale(scale, rate), df=df)


class StudentTUniform(StudentT):
    def __init__(self, shape, loc, scale, df=2, gradient_clip=1.0):
        super().__init__(shape, loc, _uniform_scale(scale), df=df)


class GenNormUniform(GenNorm):
    def __init__(self, shape, loc, scale, beta=1.0, gradient_clip=1.0):
        super().__init__(shape, loc, scale, beta=pinned(
            Uniform(shape=[], low=0.0, high=beta * 2.0), 0.0))


class Horseshoe(Normal):
    def __init__(self, shape, loc, scale, hyperscale=1.0, gradient_clip=1.0):
        super().__init__(shape, loc, pinned(
            HalfCauchy(shape=[], scale=hyperscale, multiplier=scale),
            D.inv_softplus(1.0)))
