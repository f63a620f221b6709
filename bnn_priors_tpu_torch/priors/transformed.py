"""Reparameterised priors on constrained domains (counterpart of
`bnn_priors_tpu/priors/transformed.py`). As in the reference, Gamma and
HalfCauchy take the density at softplus(p) with no Jacobian term, and
Uniform's log-density is the analytic -log(high - low) an element."""
from __future__ import annotations

import math

from .. import distributions as D
from .base import Prior

__all__ = ("Uniform", "Gamma", "HalfCauchy", "DoubleGamma")


class Uniform(Prior):
    """Uniform prior through a Gaussian reparameterisation: p ~ N(0, 1),
    forward = low + (high-low)·Φ(p) (reference transformed.py:12-47)"""

    def __init__(self, shape, low, high):
        super().__init__(shape, low=low, high=high)

    def _dist(self, low, high):
        return D.Uniform(low, high)

    def forward(self, params=None, prefix=""):
        p = self.leaf(params, prefix)
        low = self.resolve(params, prefix, "low", p)
        high = self.resolve(params, prefix, "high", p)
        return low + (high - low) * D.Normal(0.0, 1.0).cdf(p)

    def log_prob_value(self, params, prefix, value):
        """-log(high-low) times the elements of ONE chain's value over the
        bounds' own elements (the bounds broadcast across the parameter)"""
        low = self.resolve(params, prefix, "low", value)
        high = self.resolve(params, prefix, "high", value)
        lead = self.n_lead(value)
        log_prob = -D._log(high - low)
        numel = math.prod(self.shape)
        if not hasattr(log_prob, "shape"):
            return value.new_zeros(value.shape[:lead]) + log_prob * numel
        own = math.prod(log_prob.shape[lead:])
        return (value.new_zeros(value.shape[:lead])
                + self.chain_sum(log_prob, value) * (numel / max(own, 1)))

    def _sample_p(self, generator, params, prefix):
        return D.Normal(0.0, 1.0).sample(self.shape, generator)


class Gamma(Prior):
    """Gamma prior with softplus reparameterisation; the log-prob is the
    Gamma density at softplus(p) with no Jacobian (transformed.py:50-63)"""

    def __init__(self, shape, concentration, rate):
        super().__init__(shape, concentration=concentration, rate=rate)

    def _dist(self, concentration, rate):
        return D.Gamma(concentration, rate)

    def forward(self, params=None, prefix=""):
        return D.softplus(self.leaf(params, prefix))

    def log_prob_value(self, params, prefix, value):
        return self.chain_sum(self._dist_obj(params, prefix, value).log_prob(
            D.softplus(value)), value)

    def _sample_p(self, generator, params, prefix):
        return D.inv_softplus(super()._sample_p(generator, params, prefix))


class HalfCauchy(Prior):
    """Half-Cauchy with softplus reparameterisation and a fixed multiplier
    (transformed.py:66-80)"""

    def __init__(self, shape, scale=1.0, multiplier=1.0):
        super().__init__(shape, scale=scale)
        self.multiplier = multiplier

    def _dist(self, scale):
        return D.HalfCauchy(scale)

    def forward(self, params=None, prefix=""):
        return D.softplus(self.leaf(params, prefix)) * self.multiplier

    def log_prob_value(self, params, prefix, value):
        return self.chain_sum(self._dist_obj(params, prefix, value).log_prob(
            D.softplus(value) * self.multiplier), value)

    def _sample_p(self, generator, params, prefix):
        return D.inv_softplus(super()._sample_p(generator, params, prefix))


class DoubleGamma(Prior):
    "symmetrised Gamma with a location shift (transformed.py:83-95)"

    def __init__(self, shape, loc, scale, concentration):
        super().__init__(shape, loc=loc, scale=scale,
                         concentration=concentration)

    def _dist(self, loc, scale, concentration):
        return D.DoubleGamma(concentration=concentration, rate=1.0 / scale)

    def log_prob_value(self, params, prefix, value):
        loc = self.resolve(params, prefix, "loc", value)
        return self.chain_sum(self._dist_obj(params, prefix, value).log_prob(
            value - loc), value)

    def _sample_p(self, generator, params, prefix):
        x = super()._sample_p(generator, params, prefix)
        return x + D._host(self.resolve(params, prefix, "loc", x))
