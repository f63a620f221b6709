"""Loc-scale prior families (counterpart of
`bnn_priors_tpu/priors/loc_scale.py:16-23`; only `Normal` so far)."""
from __future__ import annotations

from .. import distributions as D
from .base import Prior


class LocScale(Prior):
    def __init__(self, shape, loc, scale):
        super().__init__(shape, loc=loc, scale=scale)


class Normal(LocScale):
    def _dist(self, loc, scale):
        return D.Normal(loc, scale)
