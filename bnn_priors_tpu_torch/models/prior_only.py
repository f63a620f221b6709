"""Prior-only models with zero likelihood (counterpart of
`bnn_priors_tpu/models/prior_only.py:18-60`; `PriorOnlyModel` and
`GaussianModel` only). `GaussianModel`'s exact posterior is known, which
makes it the fixture for the samplers' distribution-preservation tests.
"""
from __future__ import annotations

import torch

from .. import priors as prior
from .base import Model
from .layers import Identity

__all__ = ("PriorOnlyModel", "GaussianModel")


class PriorOnlyModel(Model):
    "the priors' leaves are the parameters (`0.p`, `1.p`, ...); no data term"

    def __init__(self, priors_list):
        super().__init__(Identity())
        for i, p in enumerate(priors_list):
            self.add_module(str(i), p)

    def log_likelihood(self, params, x, y, eff_num_data, train=False,
                       mask=None, compute_dtype=None, buffers=None):
        """0, one a chain with `buffers` (y then is (K, B)); f is zeros of
        shape (..., B, 1)"""
        dtype = next(iter(params.values())).dtype
        f = torch.zeros(*y.shape, 1, dtype=dtype, device=y.device)
        return f.sum((-2, -1)), f

    def acc_fn(self, f, y):
        return torch.zeros(y.shape, dtype=f.dtype, device=f.device)


class GaussianModel(PriorOnlyModel):
    "N independent D-dim Gaussian parameters (prior_only.py:55-59)"

    def __init__(self, N, D, mean=0.0, std=1.0):
        super().__init__([prior.Normal((D,), mean, std) for _ in range(N)])
