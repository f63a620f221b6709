"""Flat-vector packing of parameter dicts for the sampler hot path
(counterpart of `bnn_priors_tpu/mcmc/packing.py`, flat form only).

The sampler updates are elementwise over all parameters; per-tensor
structure only enters through the scalar-per-tensor preconditioner and the
per-tensor temperature diagnostics. So the chain state is one packed vector
and one fused update kernel (`ops.fused_update`) walks it.

Leaf order is the JAX package's `jax.tree_util.tree_flatten` order of a
dict, i.e. SORTED names (`net.10.*` before `net.2.*`, `bias` before
`weight`), not module order, so packed vectors, per-leaf preconditioners
and per-leaf diagnostics line up with the JAX package element for element.

`unpack` returns views of the packed vector (one `torch.split`), so a
gradient taken with respect to the packed vector through those views comes
back already packed, padding tail included (as zeros).

Chain-batched forms: every method also takes K chains' state as a `(K, T)`
bank, packed along the last axis (the counterpart of `jax.vmap(
packer.unpack)` / `packer.pack` in `parallel/multichain.py:285-286,982`):
`unpack` gives per-parameter `(K, ...)` views, `pack` of `(K, ...)` leaves
gives a `(K, T)` bank, and the reductions and `expand` work along the last
axis, one result row a chain.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# pad packed vectors to a multiple of this; the fused kernel's blocks tile
# the padded length exactly
PACK_ALIGN = 1024


class Packer:
    def __init__(self, tree: Dict[str, torch.Tensor]):
        self.names: List[str] = sorted(tree)
        self.shapes: List[Tuple[int, ...]] = [tuple(tree[k].shape)
                                              for k in self.names]
        self.sizes: List[int] = [int(np.prod(s)) if s else 1
                                 for s in self.shapes]
        self.n_leaves = len(self.names)
        self.total = int(sum(self.sizes))
        # elements in [total, total_padded) are identically zero everywhere
        # (the kernel masks them), so dot products over packed vectors are
        # exact
        self.total_padded = -(-self.total // PACK_ALIGN) * PACK_ALIGN
        self.n_pad = self.total_padded - self.total
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)
        self.device = next(iter(tree.values())).device if tree else torch.device("cpu")
        # padding elements map to a dummy segment that reductions drop
        self.segment_ids = torch.as_tensor(np.concatenate([
            np.repeat(np.arange(self.n_leaves), self.sizes),
            np.full((self.n_pad,), self.n_leaves)]), device=self.device)
        self.lengths = torch.as_tensor(self.sizes, device=self.device)
        self._firsts = torch.as_tensor(self.offsets[:-1], device=self.device)

    def pack(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        "leaves (each with the same leading chain dims, if any) -> (..., T)"
        first = self.names[0]
        lead = tuple(tree[first].shape[:tree[first].ndim
                                       - len(self.shapes[0])])
        flat = [tree[k].reshape(*lead, -1) for k in self.names]
        if self.n_pad:
            flat.append(flat[0].new_zeros(*lead, self.n_pad))
        return torch.cat(flat, dim=-1)

    def unpack(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """dict of views into `vec` (differentiable w.r.t. `vec`); a (K, T)
        bank gives (K, *shape) views"""
        lead = tuple(vec.shape[:-1])
        parts = torch.split(vec, self.sizes + [self.n_pad], dim=-1)
        return {k: p.view(lead + s)
                for k, p, s in zip(self.names, parts, self.shapes)}

    def valid_mask(self, dtype=torch.bool) -> torch.Tensor:
        "(total_padded,) mask, False/0 on the padding tail"
        m = torch.arange(self.total_padded, device=self.device) < self.total
        return m if dtype is torch.bool else m.to(dtype)

    def mask_pad(self, vec: torch.Tensor) -> torch.Tensor:
        "zero the padding tail of a packed vector"
        if not self.n_pad:
            return vec
        return torch.where(self.valid_mask(), vec, vec.new_zeros(()))

    def normal_like(self, generator: torch.Generator,
                    like: torch.Tensor) -> torch.Tensor:
        "standard-normal noise in packed form (padding tail zeroed)"
        return self.mask_pad(torch.randn(like.shape, generator=generator,
                                         dtype=like.dtype, device=like.device))

    # per-leaf scalar helpers -------------------------------------------------
    def pack_leaf_scalars(self, tree_of_scalars: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
        "dict of per-leaf scalars (or (...,) rows) -> (..., n_leaves)"
        return torch.stack([torch.as_tensor(tree_of_scalars[k])
                            for k in self.names], dim=-1)

    def unpack_leaf_scalars(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        "(..., n_leaves) -> {name: (...)}"
        return {k: vec[..., i] for i, k in enumerate(self.names)}

    def expand(self, leaf_scalars: torch.Tensor) -> torch.Tensor:
        """(..., n_leaves) -> (..., total_padded) by repeating each scalar
        over its leaf; the padding tail gets 1.0 (it multiplies exact
        zeros)."""
        ext = torch.cat([leaf_scalars,
                         leaf_scalars.new_ones(*leaf_scalars.shape[:-1], 1)],
                        dim=-1)
        return ext[..., self.segment_ids]

    def segment_sum(self, vec: torch.Tensor) -> torch.Tensor:
        """(..., total_padded) -> (..., n_leaves) sums; the padding is
        dropped. Each leaf is summed in index order (deterministic on the
        card too)."""
        lengths = self.lengths.expand(*vec.shape[:-1],
                                      self.n_leaves).contiguous()
        return torch.segment_reduce(vec[..., :self.total], "sum",
                                    lengths=lengths, axis=vec.ndim - 1)

    def leaf_means(self, vec: torch.Tensor) -> torch.Tensor:
        return self.segment_sum(vec) / self.lengths.to(vec.dtype)

    def leaf_firsts(self, vec: torch.Tensor) -> torch.Tensor:
        """(..., total_padded) -> (..., n_leaves) first element of each leaf
        — the inverse of `expand` for leaf-constant vectors
        (preconditioner)."""
        return vec[..., self._firsts]
