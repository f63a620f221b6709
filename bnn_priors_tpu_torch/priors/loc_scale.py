"""Loc-scale prior families (counterpart of
`bnn_priors_tpu/priors/loc_scale.py`)."""
from __future__ import annotations

import numpy as np
import torch

from .. import distributions as D
from .base import Prior, host_like

__all__ = (
    "LocScale", "Normal", "Laplace", "Cauchy", "StudentT", "GenNorm",
    "LogNormal", "Improper", "PositiveImproper", "ConvCorrelatedNormal",
)


class LocScale(Prior):
    def __init__(self, shape, loc, scale):
        super().__init__(shape, loc=loc, scale=scale)


class Normal(LocScale):
    def _dist(self, loc, scale):
        return D.Normal(loc, scale)


class Laplace(LocScale):
    def _dist(self, loc, scale):
        return D.Laplace(loc, scale)


class Cauchy(LocScale):
    def _dist(self, loc, scale):
        return D.Cauchy(loc, scale)


class StudentT(LocScale):
    def __init__(self, shape, loc, scale, df=3):
        Prior.__init__(self, shape, df=df, loc=loc, scale=scale)

    def _dist(self, df, loc, scale):
        return D.StudentT(df, loc, scale)


class GenNorm(LocScale):
    def __init__(self, shape, loc, scale, beta=0.5):
        Prior.__init__(self, shape, loc=loc, scale=scale, beta=beta)

    def _dist(self, loc, scale, beta):
        return D.GeneralizedNormal(loc, scale, beta)


class LogNormal(LocScale):
    """Gaussian over p, `forward` = exp(p); the log-det correction `-Σp` of
    the reference (`loc_scale.py:86-91`)"""

    def _dist(self, loc, scale):
        return D.Normal(loc, scale)

    def forward(self, params=None, prefix=""):
        return torch.exp(self.leaf(params, prefix))

    def log_prob_value(self, params, prefix, value):
        return (super().log_prob_value(params, prefix, value)
                - self.chain_sum(value, value))


class Improper(Normal):
    "improper flat prior that samples like a Normal (loc_scale.py:94-97)"

    def log_prob_value(self, params, prefix, value):
        return value.new_zeros(value.shape[:self.n_lead(value)])


class PositiveImproper(Improper):
    "improper prior for positive quantities: forward = softplus(p)"

    def forward(self, params=None, prefix=""):
        return D.softplus(self.leaf(params, prefix))


class ConvCorrelatedNormal(Prior):
    """MVN over the flattened k×k spatial dims with covariance
    exp(-dist/lengthscale)·scale² (reference loc_scale.py:38-63).

    The distance matrix is a constant. When the lengthscale and scale are
    numbers the Cholesky factor is computed once, at construction, in
    float64, and cast to the value's dtype; when either is a sub-prior it
    is computed at every evaluation in the value's dtype, one factor a
    chain, `(K, D, D)`, for chain values.
    """

    def __init__(self, shape, loc, scale, *, lengthscale=1.0):
        if np.ndim(loc) == 0:
            loc = np.asarray([loc], dtype=np.float64)
        distance_matrix = D.grid_distance_matrix(shape[-2], shape[-1])
        super().__init__(shape, loc=loc, scale=scale,
                         distance_matrix=distance_matrix,
                         lengthscale=lengthscale)
        self._hypers_changed()

    def _hypers_changed(self):
        self.fixed_scale_tril = None
        if all(isinstance(self.hypers[k], float)
               for k in ("scale", "lengthscale")):
            self.fixed_scale_tril = D.squared_exponential_scale_tril(
                torch.as_tensor(self.hypers["distance_matrix"]),
                self.hypers["lengthscale"], self.hypers["scale"]).numpy()

    def _scale_tril(self, params, prefix, like):
        "(D, D), or (*lead, D, D) for chain values with a sub-prior hyper"
        if self.fixed_scale_tril is not None:
            return self.const("fixed_scale_tril", like, self.fixed_scale_tril)
        scale, ls = (self.resolve(params, prefix, k, like, broadcast=False)
                     for k in ("scale", "lengthscale"))
        return D.squared_exponential_scale_tril(
            self.const("distance_matrix", like), ls, scale)

    def log_prob_value(self, params, prefix, value):
        lead = self.n_lead(value)
        L = self._scale_tril(params, prefix, value)
        flat = value.reshape(value.shape[:value.ndim - 2] + (-1,))
        if L.ndim > 2:  # one factor a chain: (*lead, kernels, D)
            flat = flat.reshape(tuple(value.shape[:lead]) + (-1,
                                                              flat.shape[-1]))
        lp = D.MultivariateNormal(self.const("loc", value), L).log_prob(flat)
        return self.chain_sum(lp, value)

    def _sample_p(self, generator, params, prefix):
        like = host_like(self.shape)
        dist = D.MultivariateNormal(self.const("loc", like),
                                    self._scale_tril(params, prefix, like))
        return dist.sample(self.shape[:-2], generator).reshape(self.shape)
