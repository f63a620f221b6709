"""Representation-generic vector helpers (counterpart of
`bnn_priors_tpu/mcmc/segmented.py:104-129`), flat form only: the segmented
and hybrid chain states are not ported yet.

There is no `vwhere`: the M-H decision is a host bool here, so the rollback
in `VerletSGLD.maybe_reject` is an `if` with in-place copies, where a
vector select would also copy the state on acceptance."""
from __future__ import annotations

import torch


def vsum(v: torch.Tensor) -> torch.Tensor:
    "Σ over all elements"
    return v.sum()


def vclip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(v, lo, hi)
