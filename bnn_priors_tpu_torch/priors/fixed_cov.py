"""Fixed-covariance multivariate priors for conv kernels, through PCA
whitening (counterpart of `bnn_priors_tpu/priors/fixed_cov.py`).

The covariance is a constant; its eigendecomposition is done once, in
float64 numpy, and the density is two small matrix products a kernel:
    x = (flat(p) - loc) @ inv_scale
    log_prob(p) = Σ base.log_prob(x) - log_det,  per kernel slice,
with scale = diag(sqrt(vals)) @ vecsᵀ, inv_scale = vecs @ diag(1/sqrt(vals))
and log_det = ½ Σ log vals (reference conv_loc_scale.py:56-62).
"""
from __future__ import annotations

import math
from numbers import Number

import numpy as np

from .. import distributions as D
from .base import Prior, host_like

__all__ = ("ConvCovariance", "FixedCovNormal", "FixedCovLaplace",
           "FixedCovDoubleGamma", "FixedCovGenNorm")


def _break_down_cov(cov):
    vals, vecs = np.linalg.eigh(np.asarray(cov, dtype=np.float64))
    sqrt_vals = np.sqrt(vals)
    scale = sqrt_vals[:, None] * vecs.T        # PCA whitening
    inv_scale = vecs / sqrt_vals
    log_det = np.sum(np.log(vals)) / 2.0
    return scale, inv_scale, log_det


class ConvCovariance(Prior):
    def __init__(self, shape, loc, cov, **kwargs):
        if isinstance(cov, Number) or np.ndim(cov) == 0:
            # the covariance given as a standard deviation
            cov = np.eye(shape[-2] * shape[-1]) * float(cov) ** 2
            loc = np.zeros(shape[-2] * shape[-1]) + loc
        scale, inv_scale, log_det = _break_down_cov(cov)
        super().__init__(shape, loc=np.asarray(loc, dtype=np.float64),
                         scale=scale, inv_scale=inv_scale, log_det=log_det,
                         **kwargs)
        self.event_shape = tuple(shape[-2:])

    def assign_cov(self, cov):
        "replace the fitted covariance (before `init`)"
        for name, value in zip(("scale", "inv_scale", "log_det"),
                               _break_down_cov(cov)):
            self.set_hyper(name, value)

    def _base_dist(self, params, prefix, like):
        "the distribution of the whitened event, defined by subclasses"
        raise NotImplementedError

    def log_prob_value(self, params, prefix, value):
        flat = value.reshape(value.shape[:value.ndim - 2] + (-1,))
        x = (flat - self.const("loc", value)) @ self.const("inv_scale", value)
        base_lp = self._base_dist(params, prefix, value).log_prob(x)
        n_kernels = math.prod(self.shape[:-2])
        return (self.chain_sum(base_lp, value)
                - self.resolve(params, prefix, "log_det", value) * n_kernels)

    @property
    def drawable(self) -> bool:
        """False once a fit set `scale` to a number (the data-driven
        ResNet-18's 1x1 shortcuts): the density keeps the constructor's
        whitening, and the sampler has no matrix to draw with"""
        return not isinstance(self.hypers["scale"], float)

    def _sample_p(self, generator, params, prefix):
        if not self.drawable:
            raise NotImplementedError(
                "a FixedCov prior whose fitted std was set as a number has no "
                "sampler, as in the reference (ROADMAP §3)")
        like = host_like(self.shape)
        x = self._base_dist(params, prefix, like).sample(
            tuple(self.shape[:-2]) + (math.prod(self.event_shape),),
            generator)
        y = x @ self.const("scale", like) + self.const("loc", like)
        return y.reshape(self.shape)


class FixedCovNormal(ConvCovariance):
    def __init__(self, shape, loc, cov):
        super().__init__(shape, loc, cov)

    def _base_dist(self, params, prefix, like):
        return D.Normal(0.0, 1.0)


class FixedCovLaplace(ConvCovariance):
    def __init__(self, shape, loc, cov, base_scale=math.sqrt(1 / 2)):
        # base_scale = sqrt(1/2) gives the base unit variance
        super().__init__(shape, loc, cov, base_scale=base_scale)

    def _base_dist(self, params, prefix, like):
        return D.Laplace(0.0, self.resolve(params, prefix, "base_scale",
                                           like))


class FixedCovDoubleGamma(ConvCovariance):
    def __init__(self, shape, loc, cov, concentration, base_scale=None):
        # the stddev of DoubleGamma(rate=1) is sqrt(c(1+c)): a unit variance
        if base_scale is None:
            base_rate = (concentration * (1 + concentration)) ** 0.5
        else:
            base_rate = 1.0 / base_scale
        super().__init__(shape, loc, cov, concentration=concentration,
                         base_rate=base_rate)

    def _base_dist(self, params, prefix, like):
        return D.DoubleGamma(
            self.resolve(params, prefix, "concentration", like),
            self.resolve(params, prefix, "base_rate", like))


class FixedCovGenNorm(ConvCovariance):
    def __init__(self, shape, loc, cov, beta, base_scale=None):
        if base_scale is None:
            b = float(beta)
            base_scale = math.exp((math.lgamma(1 / b) - math.lgamma(3 / b)) / 2)
        super().__init__(shape, loc, cov, beta=beta, base_scale=base_scale)

    def _base_dist(self, params, prefix, like):
        return D.GeneralizedNormal(
            0.0, self.resolve(params, prefix, "base_scale", like),
            self.resolve(params, prefix, "beta", like))
