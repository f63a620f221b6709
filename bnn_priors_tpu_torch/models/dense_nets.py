"""Dense layers with priors (counterpart of
`bnn_priors_tpu/models/dense_nets.py:17-27`; `LinearPrior` only)."""
from __future__ import annotations

from .. import priors as prior
from .layers import Linear


def LinearPrior(in_dim, out_dim, prior_w=prior.Normal, loc_w=0.0, std_w=1.0,
                prior_b=prior.Normal, loc_b=0.0, std_b=1.0, scaling_fn=None,
                weight_prior_params={}, bias_prior_params={}):
    if scaling_fn is None:
        def scaling_fn(std, dim):
            return std / dim ** 0.5
    return Linear(prior_w((out_dim, in_dim), loc_w, scaling_fn(std_w, in_dim),
                          **weight_prior_params),
                  prior_b((out_dim,), 0.0, std_b, **bias_prior_params))
