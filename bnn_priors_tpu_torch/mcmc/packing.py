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
        flat = [tree[k].reshape(-1) for k in self.names]
        if self.n_pad:
            flat.append(flat[0].new_zeros(self.n_pad))
        return torch.cat(flat)

    def unpack(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        "dict of views into `vec` (differentiable w.r.t. `vec`)"
        parts = torch.split(vec, self.sizes + [self.n_pad])
        return {k: p.view(s) for k, p, s in zip(self.names, parts, self.shapes)}

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
        "dict of per-leaf scalars -> (n_leaves,) vector"
        return torch.stack([torch.as_tensor(tree_of_scalars[k])
                            for k in self.names])

    def unpack_leaf_scalars(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: vec[i] for i, k in enumerate(self.names)}

    def expand(self, leaf_scalars: torch.Tensor) -> torch.Tensor:
        """(n_leaves,) -> (total_padded,) by repeating each scalar over its
        leaf; the padding tail gets 1.0 (it multiplies exact zeros)."""
        ext = torch.cat([leaf_scalars, leaf_scalars.new_ones(1)])
        return ext[self.segment_ids]

    def segment_sum(self, vec: torch.Tensor) -> torch.Tensor:
        """(total_padded,) -> (n_leaves,) sums; the padding is dropped.
        Each leaf is summed in index order (deterministic on the card too)."""
        return torch.segment_reduce(vec[:self.total], "sum",
                                    lengths=self.lengths)

    def leaf_means(self, vec: torch.Tensor) -> torch.Tensor:
        return self.segment_sum(vec) / self.lengths.to(vec.dtype)

    def leaf_firsts(self, vec: torch.Tensor) -> torch.Tensor:
        """(total_padded,) -> (n_leaves,) first element of each leaf — the
        inverse of `expand` for leaf-constant vectors (preconditioner)."""
        return vec[self._firsts]
