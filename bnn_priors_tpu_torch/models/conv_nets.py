"""Convolution layers with priors (counterpart of
`bnn_priors_tpu/models/conv_nets.py:24-41`; `Conv2dPrior` only)."""
from __future__ import annotations

from .. import priors as prior
from .layers import Conv2d


def Conv2dPrior(in_channels, out_channels, kernel_size=3, stride=1, padding=0,
                dilation=1, groups=1, prior_w=prior.Normal, loc_w=0.0,
                std_w=1.0, prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                scaling_fn=None, weight_prior_params={}, bias_prior_params={}):
    """Conv layer whose weight std scales as std_w/sqrt(in_channels)
    (the reference scales by channels, not fan-in)."""
    if scaling_fn is None:
        def scaling_fn(std, dim):
            return std / dim ** 0.5
    ks = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
          else tuple(kernel_size))
    bias_prior = (prior_b((out_channels,), 0.0, std_b, **bias_prior_params)
                  if prior_b is not None else None)
    return Conv2d(
        weight_prior=prior_w((out_channels, in_channels // groups, ks[0], ks[1]),
                             loc_w, scaling_fn(std_w, in_channels),
                             **weight_prior_params),
        bias_prior=bias_prior, stride=stride, padding=padding,
        dilation=dilation, groups=groups)
