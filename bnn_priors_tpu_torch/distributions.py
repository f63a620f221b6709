"""Probability distributions used by the priors (counterpart of
`bnn_priors_tpu/distributions.py`; only `Normal` is ported so far)."""
from __future__ import annotations

import math

import torch


class Normal:
    "Normal(loc, scale) with float or tensor parameters"

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        log_scale = (math.log(self.scale) if isinstance(self.scale, (int, float))
                     else torch.log(self.scale))
        return -0.5 * z * z - log_scale - 0.5 * math.log(2 * math.pi)

    def sample(self, shape, generator=None, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
        "draws in float64, then casts: the same values for every dtype"
        xi = torch.randn(tuple(shape), generator=generator,
                         dtype=torch.float64, device=device)
        return (self.loc + self.scale * xi).to(dtype)
