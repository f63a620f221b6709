"""Priors as `nn.Module`s (counterpart of `bnn_priors_tpu/priors/base.py`).

A `Prior` holds its leaf as the `nn.Parameter` `p`, so `state_dict()` names
come out as the JAX package's param-store names and the reference torch
library's (`net.0.weight_prior.p`). `forward()` is the effective value of
the parameter carrying the prior; `log_prob(value)` its density term.
Hyperparameters are fixed floats: hierarchical priors, whose hypers are
sub-priors, are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn


def join(prefix: str, name: str) -> str:
    return name if prefix == "" else prefix + "." + name


class Prior(nn.Module):
    """Base class. Subclasses define `_dist(**hypers)` returning a
    distribution from `bnn_priors_tpu_torch.distributions`."""

    def __init__(self, shape, **hypers):
        super().__init__()
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        assert "p" not in hypers, "repeated name of parameter"
        self.hypers: Dict[str, float] = {k: float(v) for k, v in hypers.items()}
        self.p = nn.Parameter(torch.zeros(self.shape))

    def _dist(self, **hypers):
        raise NotImplementedError

    def forward(self) -> torch.Tensor:
        "effective value of the parameter carrying this prior"
        return self.p

    def log_prob(self, value: Optional[torch.Tensor] = None) -> torch.Tensor:
        """density term at `value` (default: the current leaf). A value with
        leading chain dims, (K, *shape), gives one term a chain, (K,)."""
        value = self.p if value is None else value
        lp = self._dist(**self.hypers).log_prob(value)
        lead = lp.ndim - len(self.shape)
        if lead == 0:
            return lp.sum()
        return lp.reshape(*lp.shape[:lead], -1).sum(-1)

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None) -> None:
        """fresh draw of the leaf, in place; the draw is made on the CPU
        (`generator` is a CPU generator) and copied to the leaf's device"""
        value = self._dist(**self.hypers).sample(self.shape, generator,
                                                 dtype=self.p.dtype)
        self.p.copy_(value)

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        "initial value of the leaf: a draw from the prior"
        self.sample(generator)
