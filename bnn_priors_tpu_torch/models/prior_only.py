"""Prior-only models with zero likelihood (counterpart of
`bnn_priors_tpu/models/prior_only.py`). `GaussianModel`'s exact posterior
is known, which makes it the fixture for the samplers'
distribution-preservation tests; Neal's funnels (a Normal and a Student-t
of 100 scales from 0.01 to 1) are the fixture of the ΔE identity test.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import priors as prior
from .base import Model
from .layers import Identity

__all__ = ("PriorOnlyModel", "GaussianModel", "NealFunnel", "NealFunnelT")


class PriorOnlyModel(Model):
    """the priors' leaves are the parameters (`0.p`, `1.p`, ...); no data
    term. Its network is the identity, so its predictions are its inputs,
    scored as a regression's (`evaluate_model`), as in the JAX package."""

    def __init__(self, priors_list):
        super().__init__(Identity())
        for i, p in enumerate(priors_list):
            self.add_module(str(i), p)

    def log_likelihood(self, params, x, y, eff_num_data, train=False,
                       mask=None, compute_dtype=None, buffers=None):
        """0, one a chain with `buffers` (y then is (K, B, ...)); f is
        zeros of shape (B, 1), or (K, B, 1)"""
        dtype = next(iter(params.values())).dtype
        lead = y.shape[:1] if buffers is None else y.shape[:2]
        f = torch.zeros(*lead, 1, dtype=dtype, device=y.device)
        return f.sum((-2, -1)), f

    def likelihood_log_prob(self, f, y, params=None):
        return torch.zeros(f.shape[:-1], dtype=f.dtype, device=f.device)

    def acc_fn(self, f, y):
        return torch.zeros(f.shape[:-1], dtype=f.dtype, device=f.device)

    def potential_avg_closure(self, eff_num_data=1.0):
        """params -> -log prior / eff_num_data, a scalar function for
        kernel-level tests (prior_only.py:48-53)"""
        return lambda params: -self.log_prior(params) / eff_num_data


class GaussianModel(PriorOnlyModel):
    "N independent D-dim Gaussian parameters (prior_only.py:55-59)"

    def __init__(self, N, D, mean=0.0, std=1.0):
        super().__init__([prior.Normal((D,), mean, std) for _ in range(N)])


class NealFunnel(PriorOnlyModel):
    "100 Normal coordinates of scales 0.01 .. 1 (prior_only.py:62-65)"

    def __init__(self):
        super().__init__([prior.Normal((100,), 0.0,
                                       np.linspace(0.01, 1, 100))])


class NealFunnelT(PriorOnlyModel):
    "100 Student-t(3) coordinates of scales 0.01 .. 1 (prior_only.py:68-71)"

    def __init__(self):
        super().__init__([prior.StudentT((100,), 0.0,
                                         np.linspace(0.01, 1, 100), df=3)])
