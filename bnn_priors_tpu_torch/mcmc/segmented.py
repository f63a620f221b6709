"""Representation-generic vector helpers (counterpart of
`bnn_priors_tpu/mcmc/segmented.py:104-129`), flat form only: the segmented
and hybrid chain states are not ported yet.

Every helper works along the last axis, so a `(K, T)` bank of K chains gets
one result a chain. `vwhere` is the chain axis's rollback: one chain's M-H
decision selects that chain's row. (A single chain decides on the host, and
`VerletSGLD.maybe_reject` copies only on rejection.)"""
from __future__ import annotations

import torch


def vsum(v: torch.Tensor) -> torch.Tensor:
    "Σ over the last axis: a scalar for one chain, (K,) for a (K, T) bank"
    return v.sum(-1)


def vclip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(v, lo, hi)


def vwhere(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    "row k of a where cond[k] else row k of b; cond (K,), a and b (K, T)"
    return torch.where(cond[:, None], a, b)
