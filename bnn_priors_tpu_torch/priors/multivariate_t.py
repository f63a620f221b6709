"""Multivariate Student-t prior with event reshaping and permutation
(counterpart of `bnn_priors_tpu/priors/multivariate_t.py`).

The parameter is permuted by `permute`, its trailing `event_dim` dims form
the event, and trailing event dims are grouped until they match the
covariance dimension D, so one (D×D) covariance can correlate, e.g., the
per-input-channel slices of a conv kernel.
"""
from __future__ import annotations

from numbers import Number
from typing import Optional, Sequence

import numpy as np

from .. import distributions as D
from .base import Prior, host_like

__all__ = ("MultivariateT",)


class MultivariateT(Prior):
    def __init__(self, shape, loc, scale_tril, df=3, event_dim=None,
                 permute: Optional[Sequence[int]] = None):
        shape = tuple(shape)
        if event_dim is None:
            event_dim = len(shape)
        if permute is None:
            permuted_shape = shape
            permute = list(range(len(shape)))
        else:
            permuted_shape = tuple(shape[i] for i in permute)

        assert event_dim >= 1
        out_event_shape = permuted_shape[len(permuted_shape) - event_dim:]
        batch_shape = permuted_shape[:len(permuted_shape) - event_dim]

        if isinstance(scale_tril, Number) or isinstance(loc, Number):
            scale_tril = np.ones([1, 1]) * scale_tril
            loc = np.zeros([1]) + loc
        scale_tril = np.asarray(scale_tril, dtype=np.float64)
        loc = np.asarray(loc, dtype=np.float64)
        correlation_size = scale_tril.shape[-1]

        # group trailing event dims until they match the covariance's
        if correlation_size == 1:
            if out_event_shape[-1] == 1:
                event_shape = out_event_shape
            else:
                event_shape = tuple(out_event_shape) + (1,)
        else:
            size = 1
            coincides = False
            for i in reversed(range(len(out_event_shape))):
                size *= out_event_shape[i]
                if size == correlation_size:
                    coincides = True
                    last_idx = i
                    break
            assert coincides, "event dims cannot be grouped to match covariance"
            event_shape = tuple(out_event_shape[:last_idx]) + (
                correlation_size,)

        super().__init__(shape, loc=loc, scale_tril=scale_tril, df=df)
        self.event_shape = tuple(event_shape)
        self.out_event_shape = tuple(out_event_shape)
        self.batch_shape = tuple(batch_shape)
        self.permute = list(permute)
        # the inverse permutation maps samples back to the parameter layout
        self.inv_permute = [int(i) for i in np.argsort(self.permute)]

    def _dist(self, loc, scale_tril, df):
        return D.MultivariateT(df, loc, scale_tril)

    def log_prob_value(self, params, prefix, value):
        lead = self.n_lead(value)
        x = value.permute(list(range(lead))
                          + [lead + i for i in self.permute]).reshape(
            tuple(value.shape[:lead]) + self.batch_shape + self.event_shape)
        lp = self._dist_obj(params, prefix, value).log_prob(
            x, event_ndim=len(self.event_shape))
        return lp.reshape(tuple(lp.shape[:lead]) + (-1,)).sum(-1)

    def _sample_p(self, generator, params, prefix):
        dist = self._dist_obj(params, prefix, host_like(self.shape))
        x = dist.sample(self.batch_shape, generator,
                        event_shape=self.event_shape)
        x = x.reshape(self.batch_shape + self.out_event_shape)
        return x.permute(self.inv_permute)
