"""Probability distributions used by the priors (counterpart of
`bnn_priors_tpu/distributions.py`).

Parameters are Python floats or tensors. `log_prob(x)` is elementwise (or
per event, for the multivariate ones) and differentiable, on any leading
shape of `x`: float parameters stay host numbers, so a density on the card
makes no host-to-device copy. `sample(shape, generator)` draws from an
explicit CPU `torch.Generator` in float64 and returns a float64 CPU tensor:
the same values for every dtype and device the caller casts them to.

Semantics follow the JAX package (and its reference): GeneralizedNormal's
analytic form, DoubleGamma as a Gamma reflected around 0, MultivariateT in
the Shah et al. 2014 parameterisation (the covariance IS the covariance)
with the broadcast half-log-det rule for events larger than the covariance,
and the squared-exponential Cholesky with its dtype-dependent jitter.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ("Normal", "Laplace", "Cauchy", "StudentT", "GeneralizedNormal",
           "Uniform", "Gamma", "HalfCauchy", "DoubleGamma", "LogNormal",
           "MultivariateNormal", "MultivariateT", "Improper",
           "squared_exponential_scale_tril", "grid_distance_matrix",
           "softplus", "inv_softplus", "rademacher_like", "standard_gamma")

_F64 = torch.float64
_LOG_2PI = math.log(2 * math.pi)


# -- float-or-tensor arithmetic --------------------------------------------
def _log(v):
    return torch.log(v) if torch.is_tensor(v) else math.log(v)


def _lgamma(v):
    return torch.lgamma(v) if torch.is_tensor(v) else math.lgamma(v)


def _host(v) -> torch.Tensor:
    "a parameter as a float64 CPU tensor (the sampling side)"
    if torch.is_tensor(v):
        return v.detach().to("cpu", _F64)
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def _shape(shape, *params) -> tuple:
    "`shape` broadcast with the parameters' shapes"
    return tuple(torch.broadcast_shapes(tuple(shape),
                                        *(_host(p).shape for p in params)))


def _uniform(shape, generator) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, dtype=_F64)


def _normal(shape, generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, dtype=_F64)


def standard_gamma(alpha, shape, generator=None) -> torch.Tensor:
    """Gamma(alpha, rate 1) draws of `shape` (alpha broadcast to it), by
    Marsaglia and Tsang's method on the generator's stream; alpha < 1 draws
    at alpha + 1 and scales by U^(1/alpha)"""
    alpha = _host(alpha).expand(shape)
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=_F64)
    done = torch.zeros(shape, dtype=torch.bool)
    while not bool(done.all()):
        x = _normal(shape, generator)
        v = (1 + c * x) ** 3
        u = _uniform(shape, generator)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        new = ok & ~done
        out = torch.where(new, d * v, out)
        done = done | ok
    if bool(boost.any()):
        u = _uniform(shape, generator)
        out = torch.where(boost, out * u ** (1.0 / alpha), out)
    return out


def rademacher_like(x, generator=None) -> torch.Tensor:
    "±1 with equal odds, of x's shape, in float64"
    return (torch.randint(0, 2, tuple(x.shape), generator=generator)
            .to(_F64) * 2 - 1)


def softplus(x):
    "log(1 + e^x), exact for every x (`jax.nn.softplus`)"
    if not torch.is_tensor(x):
        return float(np.logaddexp(x, 0.0))
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def inv_softplus(y):
    "the inverse of softplus, log(e^y - 1), for a float, array or tensor"
    if torch.is_tensor(y):
        return y + torch.log(-torch.expm1(-y))
    y = np.asarray(y, dtype=np.float64)
    return y + np.log(-np.expm1(-y))


def grid_distance_matrix(h: int, w: int) -> np.ndarray:
    "Euclidean distances between all points of an h×w grid (numpy)"
    p = np.mgrid[:h, :w].reshape(2, -1).T
    return np.sqrt(np.sum((p[:, None, :] - p[None, :, :]) ** 2.0, axis=2))


def squared_exponential_scale_tril(distance_matrix, lengthscale, scale):
    """Cholesky of cov = exp(-d/lengthscale)·scale² plus a jitter of
    (1e-6 in float64, else 1e-5)·scale² on the diagonal. Tensors of leading
    shape (...) give (..., D, D); the factorisation is `cholesky_ex`, so
    the card does not wait on its status."""
    d = distance_matrix
    if torch.is_tensor(lengthscale) and lengthscale.ndim:
        lengthscale = lengthscale[..., None, None]
    if torch.is_tensor(scale) and scale.ndim:
        scale = scale[..., None, None]
    cov = torch.exp(-d / lengthscale) * scale ** 2
    jitter = (1e-6 if cov.dtype == _F64 else 1e-5) * scale ** 2
    cov = cov + jitter * torch.eye(d.shape[-1], dtype=cov.dtype,
                                   device=cov.device)
    return torch.linalg.cholesky_ex(cov)[0]


# -- the scalar families ---------------------------------------------------
class Normal:
    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - 0.5 * _LOG_2PI

    def sample(self, shape, generator=None) -> torch.Tensor:
        loc, scale = _host(self.loc), _host(self.scale)
        return loc + scale * _normal(_shape(shape, loc, scale), generator)

    def cdf(self, x):
        return torch.special.ndtr((x - self.loc) / self.scale)


class Laplace:
    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def log_prob(self, x):
        return -torch.abs(x - self.loc) / self.scale - _log(2 * self.scale)

    def sample(self, shape, generator=None):
        loc, scale = _host(self.loc), _host(self.scale)
        shape = _shape(shape, loc, scale)
        # the difference of two unit exponentials; -log1p(-U) is finite
        e = -torch.log1p(-_uniform(shape, generator))
        e2 = -torch.log1p(-_uniform(shape, generator))
        return loc + scale * (e - e2)


class Cauchy:
    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -torch.log1p(z * z) - _log(math.pi * self.scale)

    def sample(self, shape, generator=None):
        loc, scale = _host(self.loc), _host(self.scale)
        u = _uniform(_shape(shape, loc, scale), generator)
        return loc + scale * torch.tan(math.pi * (u - 0.5))


class StudentT:
    def __init__(self, df, loc, scale):
        self.df, self.loc, self.scale = df, loc, scale

    def log_prob(self, x):
        df = self.df
        z = (x - self.loc) / self.scale
        return (_lgamma((df + 1) / 2) - _lgamma(df / 2)
                - 0.5 * _log(df * math.pi) - _log(self.scale)
                - (df + 1) / 2 * torch.log1p(z * z / df))

    def sample(self, shape, generator=None):
        df, loc, scale = (_host(v) for v in (self.df, self.loc, self.scale))
        shape = _shape(shape, df, loc, scale)
        z = _normal(shape, generator)
        chi2 = 2.0 * standard_gamma(df / 2, shape, generator)
        return loc + scale * z / torch.sqrt(chi2 / df)


class GeneralizedNormal:
    "p(x) ∝ exp(-(|x-loc|/scale)^beta)"

    def __init__(self, loc, scale, beta):
        self.loc, self.scale, self.beta = loc, scale, beta

    def log_prob(self, x):
        beta = self.beta
        return (-_log(2 * self.scale) - _lgamma(1 / beta) + _log(beta)
                - (torch.abs(x - self.loc) / self.scale) ** beta)

    def sample(self, shape, generator=None):
        # |X|^beta ~ Gamma(1/beta)  =>  X = sign · G^(1/beta) · scale
        loc, scale, beta = (_host(v) for v in (self.loc, self.scale,
                                                self.beta))
        shape = _shape(shape, loc, scale, beta)
        g = standard_gamma(1 / beta, shape, generator)
        sign = rademacher_like(g, generator)
        return loc + scale * sign * g ** (1 / beta)


class Uniform:
    def __init__(self, low, high):
        self.low, self.high = low, high

    def log_prob(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return (torch.zeros_like(x).masked_fill(~inside, -math.inf)
                - _log(self.high - self.low))

    def sample(self, shape, generator=None):
        low, high = _host(self.low), _host(self.high)
        return low + (high - low) * _uniform(_shape(shape, low, high),
                                             generator)


class Gamma:
    def __init__(self, concentration, rate):
        self.concentration, self.rate = concentration, rate

    def log_prob(self, x):
        conc, rate = self.concentration, self.rate
        return (conc * _log(rate) + (conc - 1) * torch.log(x) - rate * x
                - _lgamma(conc))

    def sample(self, shape, generator=None):
        conc, rate = _host(self.concentration), _host(self.rate)
        return standard_gamma(conc, _shape(shape, conc, rate),
                              generator) / rate


class HalfCauchy:
    def __init__(self, scale):
        self.scale = scale

    def log_prob(self, x):
        z = x / self.scale
        lp = math.log(2 / math.pi) - _log(self.scale) - torch.log1p(z * z)
        return torch.where(x >= 0, lp, -math.inf)

    def sample(self, shape, generator=None):
        return torch.abs(Cauchy(0.0, self.scale).sample(shape, generator))


class DoubleGamma:
    "a Gamma reflected around zero"

    def __init__(self, concentration, rate):
        self.concentration, self.rate = concentration, rate

    def log_prob(self, x):
        return (Gamma(self.concentration, self.rate).log_prob(torch.abs(x))
                - math.log(2))

    def sample(self, shape, generator=None):
        x = Gamma(self.concentration, self.rate).sample(shape, generator)
        return x * rademacher_like(x, generator)


class LogNormal:
    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def log_prob(self, x):
        log_x = torch.log(x)
        return Normal(self.loc, self.scale).log_prob(log_x) - log_x

    def sample(self, shape, generator=None):
        return torch.exp(Normal(self.loc, self.scale).sample(shape, generator))


class Improper:
    "improper flat density (log_prob 0) that samples like a Normal"

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def log_prob(self, x):
        return torch.zeros_like(x)

    def sample(self, shape, generator=None):
        return Normal(self.loc, self.scale).sample(shape, generator)


# -- the multivariate ones -------------------------------------------------
def mahalanobis(L, diff):
    """Σ_j z_j² for L z = diff, per event: diff (..., n, D) holds n events
    a batch, L (D, D) or (..., D, D) (one factor a batch). One triangular
    solve with n right-hand sides a batch. Returns (..., n)."""
    z = torch.linalg.solve_triangular(L, diff.transpose(-1, -2), upper=False)
    return (z * z).sum(-2)


def _half_log_det(L):
    return torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


class MultivariateNormal:
    "MVN over the last axis, by loc (..., D) and scale_tril (..., D, D)"

    def __init__(self, loc, scale_tril):
        self.loc, self.scale_tril = loc, scale_tril

    def log_prob(self, x):
        """x (..., D); with a batched scale_tril (B..., D, D), x is
        (B..., n, D): n events a factor"""
        L = self.scale_tril
        diff = x - self.loc
        D = x.shape[-1]
        if L.ndim == 2:
            flat = diff.reshape(1, -1, D)
            M = mahalanobis(L, flat).reshape(diff.shape[:-1])
        else:
            M = mahalanobis(L, diff)
            L = L[..., None, :, :]
        return -0.5 * M - _half_log_det(L) - 0.5 * D * _LOG_2PI

    def sample(self, shape, generator=None):
        loc, L = _host(self.loc), _host(self.scale_tril)
        eps = _normal(tuple(shape) + (L.shape[-1],), generator)
        return loc + eps @ L.transpose(-1, -2)


class MultivariateT:
    """Multivariate Student-t, Shah et al. 2014 parameterisation: scale_tril
    (D, D) is the Cholesky of the covariance. `log_prob(x, event_ndim)`
    takes `event_ndim` trailing event dims whose total size p may exceed D;
    the half-log-det is then scaled by p / D (the reference's broadcast
    rule)."""

    def __init__(self, df, loc, scale_tril):
        self.df, self.loc, self.scale_tril = df, loc, scale_tril

    def log_prob(self, x, event_ndim: int = 1):
        df, L = self.df, self.scale_tril
        diff = x - self.loc
        D = L.shape[-1]
        M = mahalanobis(L, diff.reshape(1, -1, D)).reshape(diff.shape[:-1])
        if event_ndim > 1:
            M = M.sum(tuple(range(-event_ndim + 1, 0)))
        p = int(np.prod(x.shape[x.ndim - event_ndim:]))
        half_log_det = _half_log_det(L) * (p / D)
        lam = df - 2.0
        return (_lgamma((p + df) / 2.0) - (p / 2.0) * _log(math.pi * lam)
                - _lgamma(df / 2.0) - half_log_det
                - ((df + p) / 2.0) * torch.log1p(M / lam))

    def sample(self, shape, generator=None,
               event_shape: Optional[Sequence[int]] = None):
        df, loc, L = (_host(v) for v in (self.df, self.loc, self.scale_tril))
        D = L.shape[-1]
        event_shape = (D,) if event_shape is None else tuple(event_shape)
        assert event_shape[-1] == D
        shape = tuple(shape)
        eps = _normal(shape + event_shape, generator)
        # one gamma an event
        r_inv = 2.0 * standard_gamma(df / 2.0, shape, generator)
        r = torch.sqrt((df - 2.0) / r_inv).reshape(
            shape + (1,) * len(event_shape))
        return loc + r * (eps @ L.transpose(-1, -2))
