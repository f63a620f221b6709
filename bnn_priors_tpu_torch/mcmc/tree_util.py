"""Parameter-dict helpers for the samplers: whole-tree and per-leaf
reductions (counterpart of `bnn_priors_tpu/mcmc/tree_util.py`).

A tree is a dict of tensors; its leaves go in sorted-name order, the order
of `jax.tree_util` over a dict. Every reduction stays on the device; per-leaf
diagnostics come back as dicts of 0-d tensors. Where the JAX version takes
a PRNG key, this one takes an explicit `torch.Generator`.
"""
from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    "Σ over leaves of <a_leaf, b_leaf> (flat inner product)"
    total = None
    for k in sorted(a):
        s = torch.sum(a[k] * b[k])
        total = s if total is None else total + s
    return torch.zeros(()) if total is None else total


def tree_leaf_dot(a: Tree, b: Tree) -> Tree:
    "per-leaf flat inner products, as a dict of 0-d tensors"
    return {k: torch.sum(a[k] * b[k]) for k in sorted(a)}


def tree_scale_add(a: Tree, b: Tree, alpha) -> Tree:
    "a + alpha * b, leafwise (alpha a scalar, a tensor or a per-leaf dict)"
    if isinstance(alpha, dict):
        return {k: a[k] + alpha[k] * b[k] for k in sorted(a)}
    return {k: a[k] + alpha * b[k] for k in sorted(a)}


def tree_randn_like(generator: torch.Generator, tree: Tree) -> Tree:
    """standard normal noise with the tree's shapes and dtypes, leaf after
    leaf from `generator` (on the leaves' device)"""
    return {k: torch.randn(v.shape, generator=generator, dtype=v.dtype,
                           device=v.device) for k, v in sorted(tree.items())}


def tree_zeros_like(tree: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in sorted(tree.items())}


def tree_ones_scalar_like(tree: Tree) -> Tree:
    "a 0-d 1.0 a leaf, of the leaf's dtype (a per-leaf preconditioner)"
    return {k: torch.ones((), dtype=v.dtype, device=v.device)
            for k, v in sorted(tree.items())}


def tree_select(pred, a: Tree, b: Tree) -> Tree:
    "leafwise where(pred, a, b): the rollback of a rejected proposal"
    pred = torch.as_tensor(pred)
    return {k: torch.where(pred, a[k], b[k]) for k in sorted(a)}


def tree_numel(tree: Tree) -> int:
    return sum(int(v.numel()) for v in tree.values())


def tree_clip(tree: Tree, bound) -> Tree:
    return {k: torch.clamp(v, -bound, bound) for k, v in sorted(tree.items())}
