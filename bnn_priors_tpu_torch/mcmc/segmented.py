"""Segmented and hybrid chain states, and the representation-generic vector
helpers (counterpart of `bnn_priors_tpu/mcmc/segmented.py`).

A flat state (`packing.Packer`) is one packed vector. A segmented state
keeps the chain state as the parameter leaves (`SegPacker`: one segment a
leaf); a hybrid state keeps the leaves of `native_ndim` or more dims (the
convolutions) as their own segments and concatenates all the small leaves
(batchnorm scale and shift, the dense head and its bias) into one flat
segment (`HybridPacker`). Both are a `SegVec`: a tuple of segment tensors
with leaf-wise arithmetic, so the samplers' update rules are written once.

Storage. The segments of one state vector live in ONE 1-D buffer, the
`SegVec`'s `base`, laid out by an `Arena`: segment s is a contiguous
`(*lead, *shape_s)` block (lead = `()` for one chain, `(K,)` for K chains)
starting 16-byte aligned; the gaps between blocks are never read.
So a leaf is a contiguous tensor in the layout its consumer wants (a K-chain
convolution weight reshapes to the grouped convolution's `(K·O, I, kH, kW)`
without a copy), while the whole state is still one allocation:
elementwise work of two `SegVec`s of one arena is one op on their bases,
the gradient with respect to the base comes back as a base (`differentiable`
and `wrap_grad`), and the multi-tensor update kernel
(`ops.fused_update.fused_langevin_update_segments`) finds every segment at
a fixed offset from the buffer's address, from a table built once per
packer and chain count (`kernel_table`: one row a piece of a leaf, in the
flat packing's order).

The preconditioner M^{-1/2} is leaf-constant: in a segmented state it is one
scalar a leaf (`()`, or `(K,)` for K chains), in a hybrid state one scalar a
native leaf and a vector over the small segment, as in the JAX package.

Noise. The port's flat kernel draws element e of a chain's packed vector
from Philox at counter e >> 2. The segments kernel draws each element by
its index in the FLAT packing, and `normal_like` and `from_flat` place a
flat draw into the segments: a segmented or hybrid run draws the same noise
as a flat run with the same seeds, and packing is a choice of layout only.
(The JAX package draws one threefry stream a segment, which no port can
match anyway.)

Every helper works along the chain axis too: `vsum` gives `(K,)` for K
chains, and `vwhere` takes a `(K,)` condition and selects whole chains.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .packing import Packer

__all__ = ("SegVec", "SegPacker", "HybridPacker", "Arena", "SegmentTable",
           "vsum", "vdot", "vclip", "vwhere", "vapply", "named_arrays",
           "from_named_arrays")

SEG_ALIGN = 4  # elements: every segment block starts 16-byte aligned


def _aligned(a: torch.Tensor, b: torch.Tensor):
    """a and b broadcast from the LEADING axis: a per-chain scalar (K,)
    against a (K, ...) leaf becomes (K, 1, ...)"""
    if torch.is_tensor(a) and torch.is_tensor(b) and a.ndim != b.ndim:
        if a.ndim < b.ndim:
            a = a.reshape(a.shape + (1,) * (b.ndim - a.ndim))
        else:
            b = b.reshape(b.shape + (1,) * (a.ndim - b.ndim))
    return a, b


class Arena:
    """The layout of a `SegVec`'s base: segment s is a contiguous block of
    `prod(lead) * prod(shapes[s])` elements at `offsets[s]`, viewed as
    `(*lead, *shapes[s])`. `tag` names the packing in checkpoints."""

    def __init__(self, shapes: Sequence[tuple], lead: tuple, tag: str):
        self.shapes = [tuple(s) for s in shapes]
        self.lead = tuple(lead)
        self.tag = tag
        self.n_chains = math.prod(self.lead)
        self.sizes = [math.prod(s) for s in self.shapes]
        offsets, at = [], 0
        for n in self.sizes:
            offsets.append(at)
            at = -(-(at + self.n_chains * n) // SEG_ALIGN) * SEG_ALIGN
        self.offsets = offsets
        self.length = at
        # torch.split's pieces: each block, and the gap after it where there
        # is one; `_blocks` are the blocks' indices among them
        self._pieces, self._blocks = [], []
        for s, n in enumerate(self.sizes):
            end = (self.offsets[s + 1] if s + 1 < len(self.sizes)
                   else self.length)
            self._blocks.append(len(self._pieces))
            self._pieces.append(self.n_chains * n)
            gap = end - self.offsets[s] - self.n_chains * n
            if gap:
                self._pieces.append(gap)
        self._chain_index: Dict = {}

    def views(self, base: torch.Tensor) -> List[torch.Tensor]:
        "the segments of `base` as views (differentiable w.r.t. base)"
        parts = torch.split(base, self._pieces)
        return [parts[i].view(self.lead + shape)
                for i, shape in zip(self._blocks, self.shapes)]

    def wrap(self, base: torch.Tensor) -> "SegVec":
        "a SegVec of `base`; its segments are made when first read"
        return SegVec(None, self.lead, base, self)

    def pack(self, parts: Sequence[torch.Tensor]) -> "SegVec":
        "a new base holding `parts` (each (*lead, *shape)), gaps zero"
        flat = []
        for s, p in enumerate(parts):
            flat.append(torch.as_tensor(p).reshape(-1))
            end = (self.offsets[s + 1] if s + 1 < len(self.sizes)
                   else self.length)
            gap = end - self.offsets[s] - flat[-1].numel()
            if gap:
                flat.append(flat[-1].new_zeros(gap))
        return self.wrap(torch.cat(flat))

    def chain_index(self, device) -> torch.Tensor:
        "(length,) the chain of each element of the base (gaps: chain 0)"
        key = torch.device(device)
        hit = self._chain_index.get(key)
        if hit is None:
            idx = np.zeros(self.length, np.int64)
            for o, n in zip(self.offsets, self.sizes):
                idx[o:o + self.n_chains * n] = np.repeat(
                    np.arange(self.n_chains), n)
            hit = self._chain_index[key] = torch.as_tensor(idx, device=key)
        return hit


class SegVec:
    """A packed vector that is the tuple of its segments. Leaf-wise
    arithmetic with scalars and other SegVecs (a per-chain scalar leaf
    broadcasts from the leading axis); two SegVecs of one arena combine as
    one op on their bases, and the result keeps the arena."""

    __slots__ = ("_leaves", "lead", "base", "arena")

    def __init__(self, leaves, lead: tuple = (), base=None, arena=None):
        self._leaves = None if leaves is None else tuple(leaves)
        self.lead = tuple(lead)
        self.base = base
        self.arena = arena

    @property
    def leaves(self):
        """the segment tensors; a SegVec of a buffer makes its views at the
        first read (a step that only hands the buffer to the kernel makes
        none)"""
        if self._leaves is None:
            self._leaves = tuple(self.arena.views(self.base))
        return self._leaves

    # -- tensor-like attributes -------------------------------------------
    @property
    def dtype(self):
        return (self.base if self.base is not None else self.leaves[0]).dtype

    @property
    def device(self):
        return (self.base if self.base is not None else self.leaves[0]).device

    def astype(self, dtype) -> "SegVec":
        return vapply(lambda t: t.to(dtype), self)

    def clone(self) -> "SegVec":
        return vapply(torch.clone, self)

    def copy_(self, src: "SegVec") -> "SegVec":
        """`src`'s values into this buffer, in place: the buffer keeps its
        address; both are SegVecs of one arena"""
        if src.arena is not self.arena or src.base is None:
            raise ValueError("copy_ takes a SegVec of the same arena")
        self.base.copy_(src.base)
        return self

    # -- elementwise algebra ------------------------------------------------
    def _bin(self, other, op):
        if isinstance(other, SegVec):
            if self.base is not None and other.arena is self.arena \
                    and other.base is not None:
                return self.arena.wrap(op(self.base, other.base))
            return SegVec((op(*_aligned(a, b))
                           for a, b in zip(self.leaves, other.leaves)),
                          self.lead or other.lead)
        if self.base is not None:  # a scalar
            return self.arena.wrap(op(self.base, other))
        return SegVec((op(a, other) for a in self.leaves), self.lead)

    def __add__(self, o):
        return self._bin(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._bin(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._bin(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._bin(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._bin(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._bin(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._bin(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._bin(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._bin(o, lambda a, b: a ** b)

    def __neg__(self):
        return vapply(torch.neg, self)


# -- representation-generic vector helpers ---------------------------------
def vapply(fn, *vs):
    """fn on tensors; on SegVecs of one arena, fn on their bases (one op),
    else leaf by leaf"""
    v0 = vs[0]
    if not isinstance(v0, SegVec):
        return fn(*vs)
    if v0.base is not None and all(v.base is not None and v.arena is v0.arena
                                   for v in vs):
        return v0.arena.wrap(fn(*(v.base for v in vs)))
    return SegVec((fn(*ls) for ls in zip(*(v.leaves for v in vs))), v0.lead)


def vsum(v):
    "Σ over one chain's elements: a scalar for one chain, (K,) for K chains"
    if isinstance(v, SegVec):
        total = None
        for t in v.leaves:
            s = t.reshape(*v.lead, -1).sum(-1)
            total = s if total is None else total + s
        return total
    return v.sum(-1)


def vdot(a, b):
    "<a, b> over one chain's elements"
    return vsum(a * b)


def vclip(v, lo: float, hi: float):
    return vapply(lambda t: torch.clamp(t, lo, hi), v)


def vwhere(cond: torch.Tensor, a, b):
    """chain k of a where cond[k] else chain k of b; cond (K,), a and b
    K chains' vectors ((K, T) banks or SegVecs of one arena)"""
    if isinstance(a, SegVec):
        sel = cond[a.arena.chain_index(cond.device)]
        return vapply(lambda x, y: torch.where(sel, x, y), a, b)
    return torch.where(cond[:, None], a, b)


def named_arrays(name: str, v) -> Dict[str, torch.Tensor]:
    """a state field's checkpoint entries: the tensor under `name`, or a
    SegVec's segments as `<name>.<packing>.<i>`"""
    if isinstance(v, SegVec):
        return {f"{name}.{v.arena.tag}.{i}": t for i, t in enumerate(v.leaves)}
    return {name: v}


def from_named_arrays(arrays: dict, name: str, like, to_tensor):
    """pop `name`'s entries from `arrays` and rebuild the field in the form
    of the live value `like` (`to_tensor` makes a numpy array a tensor on
    the state's device)"""
    if isinstance(like, SegVec):
        parts = [to_tensor(arrays.pop(f"{name}.{like.arena.tag}.{i}"))
                 for i in range(len(like.leaves))]
        return like.arena.pack(parts)
    return to_tensor(arrays.pop(name))


class SegmentTable:
    """What the segments kernel and its plain version need of one (packer,
    chain count, device).

    `pieces` (n_pieces, 8) int64 on the device, one row a piece in the flat
    packing's order (see `csrc/fused_update_segments.cu`): a piece is the
    part of one run of elements (a leaf: consecutive in the flat packing
    and in its segment) that lies in one chunk of `chunk` flat elements.
    Its columns: flat start, count, the buffer position of its first
    element for chain 0 and the state buffers' chain stride, the same for
    the preconditioner (its scalar for a native leaf) and M's element
    stride (0 or 1), and its leaf. `x_index` and `p_index`, for the plain
    version, are the (K, total) indices of each flat element in the
    state's base and in the preconditioner's, made at first use."""

    COLUMNS = ("flat", "count", "x", "x_stride", "p", "p_stride", "p_elem",
               "leaf")

    def __init__(self, packer: "SegPacker", lead: tuple, device, chunk: int):
        x_arena, p_arena = packer.arena(lead), packer.pre_arena(lead)
        self.n_chains = x_arena.n_chains
        self.length, self.pre_length = x_arena.length, p_arena.length
        self.total = packer.total
        self.flat_padded = packer.flat_padded
        self.device = torch.device(device)
        rows = []
        for s, seg_runs in enumerate(packer.seg_runs):
            p_elem = int(len(p_arena.shapes[s]) > 0)  # 0: one M a leaf
            for leaf, start, n in seg_runs:
                f0 = int(packer.offsets[leaf])
                cuts = np.arange(-(-(f0 + 1) // chunk) * chunk, f0 + n,
                                 chunk, dtype=np.int64)
                flat = np.concatenate([[f0], cuts])
                count = np.diff(np.concatenate([flat, [f0 + n]]))
                pos = start + flat - f0  # in the segment
                rows.append(np.stack([
                    flat, count, x_arena.offsets[s] + pos,
                    np.full_like(flat, x_arena.sizes[s]),
                    p_arena.offsets[s] + p_elem * pos,
                    np.full_like(flat, p_arena.sizes[s]),
                    np.full_like(flat, p_elem),
                    np.full_like(flat, leaf)], 1))
        rows = np.concatenate(rows) if rows else np.zeros((0, 8), np.int64)
        rows = rows[np.argsort(rows[:, 0], kind="stable")]
        self.n_pieces = len(rows)
        self.pieces = torch.as_tensor(rows, device=self.device)
        self._rows = rows
        self._index = None

    def _indices(self):
        if self._index is None:
            K, rows = self.n_chains, self._rows
            x_index = np.zeros((K, self.total), np.int64)
            p_index = np.zeros((K, self.total), np.int64)
            chains = np.arange(K)[:, None]
            for flat, count, x, xs, p, ps, pe, _ in rows:
                at = np.arange(count)
                x_index[:, flat:flat + count] = x + chains * xs + at
                p_index[:, flat:flat + count] = p + chains * ps + pe * at
            self._index = (torch.as_tensor(x_index, device=self.device),
                           torch.as_tensor(p_index, device=self.device))
        return self._index

    @property
    def x_index(self) -> torch.Tensor:
        return self._indices()[0]

    @property
    def p_index(self) -> torch.Tensor:
        return self._indices()[1]


class SegPacker(Packer):
    """Packer whose packed form is a `SegVec` with one segment a leaf.
    Interface-compatible with `Packer` for everything the runners use
    (names, sizes, pack_leaf_scalars, segment_sum, expand, leaf_firsts,
    ...). `total_padded` is `total` (no padding), and `flat_padded` the
    flat packing's padded length (the noise's index space)."""

    tag = "segmented"

    def __init__(self, tree):
        super().__init__(tree)
        self.flat_padded = self.total_padded
        self.total_padded = self.total
        self.n_pad = 0
        self._set_segments(
            [self.shapes[i] for i in range(self.n_leaves)],
            [[(i, 0, self.sizes[i])] for i in range(self.n_leaves)],
            [()] * self.n_leaves)

    def _set_segments(self, shapes, runs, pre_shapes):
        """segment shapes (per chain), each segment's element runs (leaf,
        start in the segment, length) and its preconditioner's shape"""
        self.seg_shapes = [tuple(s) for s in shapes]
        self.seg_runs = runs
        self.pre_shapes = [tuple(s) for s in pre_shapes]
        self.n_segments = len(shapes)
        self._arenas: Dict = {}
        self._tables: Dict = {}
        self._flat_maps: Dict = {}

    # -- layouts -------------------------------------------------------------
    def arena(self, lead=()) -> Arena:
        "the state vectors' layout for `lead` chain axes (one object each)"
        key = ("x", tuple(lead))
        if key not in self._arenas:
            self._arenas[key] = Arena(self.seg_shapes, lead, self.tag)
        return self._arenas[key]

    def pre_arena(self, lead=()) -> Arena:
        "the preconditioner's layout"
        key = ("p", tuple(lead))
        if key not in self._arenas:
            self._arenas[key] = Arena(self.pre_shapes, lead, self.tag)
        return self._arenas[key]

    def kernel_table(self, lead, device, chunk: int) -> SegmentTable:
        "the segments kernel's table, built once per (lead, device, chunk)"
        key = (tuple(lead), torch.device(device), chunk)
        hit = self._tables.get(key)
        if hit is None:
            hit = self._tables[key] = SegmentTable(self, lead, device, chunk)
        return hit

    def _lead_of_tree(self, tree) -> tuple:
        first = tree[self.names[0]]
        return tuple(first.shape[:first.ndim - len(self.shapes[0])])

    # -- pack/unpack --------------------------------------------------------
    def _segments_of(self, tree, lead) -> List[torch.Tensor]:
        return [tree[self.names[i]] for i in range(self.n_leaves)]

    def pack(self, tree) -> SegVec:
        "leaves (each with the same leading chain dims) -> a SegVec"
        if isinstance(tree, SegVec):
            return tree
        lead = self._lead_of_tree(tree)
        return self.arena(lead).pack(self._segments_of(tree, lead))

    def unpack(self, vec: SegVec) -> Dict[str, torch.Tensor]:
        """the segments by name, each already (*lead, *shape): views of a
        SegVec's buffer"""
        return dict(zip(self.names, vec.leaves))

    def lead_of(self, vec) -> tuple:
        return vec.lead

    # -- gradients with respect to the base ---------------------------------
    def differentiable(self, vec: SegVec):
        """(input, parameter dict): a detached copy of the base that
        requires grad, and the leaves as views of it"""
        base = vec.base.detach().requires_grad_()
        return base, self.unpack(vec.arena.wrap(base))

    def wrap_grad(self, g: torch.Tensor, like: SegVec) -> SegVec:
        "the gradient with respect to `differentiable`'s input, as a SegVec"
        return like.arena.wrap(g)

    # -- rows of a K-chain state (dispatch groups) --------------------------
    def rows(self, vec: SegVec, start: int, stop: int) -> SegVec:
        "chains start..stop-1 as a state of their own (one copy)"
        return self.arena((stop - start,)).pack(
            [t[start:stop] for t in vec.leaves])

    def cat_rows(self, vecs) -> SegVec:
        "states of consecutive chains as one state (one copy)"
        vecs = list(vecs)
        return self.arena((sum(v.lead[0] for v in vecs),)).pack(
            [torch.cat(ts) for ts in zip(*(v.leaves for v in vecs))])

    # -- the flat packing's order -------------------------------------------
    def _flat_map(self, lead, device):
        """(index of each base element in the flat (*lead, flat_padded)
        bank, or the bank's size for a gap; mask of the base's real
        elements)"""
        key = (tuple(lead), torch.device(device))
        hit = self._flat_maps.get(key)
        if hit is None:
            arena = self.arena(lead)
            K, P = arena.n_chains, self.flat_padded
            idx = np.full(arena.length, K * P, np.int64)
            for s, runs in enumerate(self.seg_runs):
                block = arena.offsets[s]
                size = arena.sizes[s]
                for leaf, start, n in runs:
                    f0 = int(self.offsets[leaf])
                    for k in range(K):
                        o = block + k * size + start
                        idx[o:o + n] = k * P + f0 + np.arange(n)
            real = idx < K * P
            hit = (torch.as_tensor(idx, device=device),
                   torch.as_tensor(real, device=device))
            self._flat_maps[key] = hit
        return hit

    def from_flat(self, flat: torch.Tensor) -> SegVec:
        """a flat (*lead, flat_padded) packed vector (the flat Packer's
        order) as a SegVec: one gather"""
        lead = tuple(flat.shape[:-1])
        idx, _ = self._flat_map(lead, flat.device)
        src = torch.cat([flat.reshape(-1), flat.new_zeros(1)])
        return self.arena(lead).wrap(src[idx])

    def to_flat(self, vec: SegVec) -> torch.Tensor:
        """a SegVec of state vectors as the flat packing's (*lead,
        flat_padded) vector, padding zero"""
        idx, real = self._flat_map(vec.lead, vec.device)
        K = math.prod(vec.lead)
        out = vec.base.new_zeros(K * self.flat_padded)
        out[idx[real]] = vec.base[real]
        return out.view(*vec.lead, self.flat_padded)

    # -- elementwise helpers -------------------------------------------------
    def mask_pad(self, vec):
        return vec  # no padding tail

    def valid_mask(self, dtype=torch.bool) -> torch.Tensor:
        m = torch.ones(self.total, dtype=torch.bool, device=self.device)
        return m if dtype is torch.bool else m.to(dtype)

    def normal_like(self, generator: torch.Generator, like: SegVec) -> SegVec:
        """standard normals: the flat packing's draw (`Packer.normal_like`
        of one chain) placed into the segments, so the same generator state
        gives a flat and a segmented state the same values"""
        flat = torch.randn((*like.lead, self.flat_padded), generator=generator,
                           dtype=like.dtype, device=like.device)
        return self.from_flat(flat)

    # -- per-leaf reductions --------------------------------------------------
    def segment_sum(self, vec: SegVec) -> torch.Tensor:
        "(*lead, n_leaves) per-leaf sums"
        return torch.stack([t.reshape(*vec.lead, -1).sum(-1)
                            for t in vec.leaves], -1)

    def leaf_means(self, vec: SegVec) -> torch.Tensor:
        return self.segment_sum(vec) / self.lengths.to(vec.dtype)

    def leaf_firsts(self, vec: SegVec) -> torch.Tensor:
        """(*lead, n_leaves) first element of each leaf: the inverse of
        `expand` for leaf-constant vectors (the preconditioner)"""
        return torch.stack([t.reshape(*vec.lead, -1)[..., 0]
                            for t in vec.leaves], -1)

    def expand(self, leaf_scalars: torch.Tensor) -> SegVec:
        "(*lead, n_leaves) per-leaf scalars -> one scalar a leaf"
        lead = tuple(leaf_scalars.shape[:-1])
        return self.pre_arena(lead).pack(
            [leaf_scalars[..., i] for i in range(self.n_leaves)])


class HybridPacker(SegPacker):
    """Grouped-segment chain state: leaves of `native_ndim` or more dims
    (the convolutions) stay native segments, all the small leaves are
    concatenated into one flat segment, last. The preconditioner is one
    scalar a native leaf and a vector over the small segment
    (`bnn_priors_tpu/mcmc/segmented.py:181-280`)."""

    tag = "hybrid"

    def __init__(self, tree, native_ndim: int = 3):
        Packer.__init__(self, tree)
        self.flat_padded = self.total_padded
        self.total_padded = self.total
        self.n_pad = 0
        self.native_ndim = int(native_ndim)
        self.native_idx = [i for i, s in enumerate(self.shapes)
                           if len(s) >= self.native_ndim]
        native = set(self.native_idx)
        self.small_idx = [i for i in range(self.n_leaves) if i not in native]
        small_sizes = [self.sizes[i] for i in self.small_idx]
        self.small_offsets = np.concatenate(
            [[0], np.cumsum(small_sizes)]).astype(np.int64)
        self._small_seg_ids = torch.as_tensor(np.repeat(
            np.arange(len(self.small_idx)), small_sizes), device=self.device)
        self._small_lengths = torch.as_tensor(small_sizes, device=self.device)
        shapes = [self.shapes[i] for i in self.native_idx]
        runs = [[(i, 0, self.sizes[i])] for i in self.native_idx]
        pre = [()] * len(self.native_idx)
        if self.small_idx:
            n_small = int(self.small_offsets[-1])
            shapes.append((n_small,))
            runs.append([(i, int(self.small_offsets[k]), self.sizes[i])
                         for k, i in enumerate(self.small_idx)])
            pre.append((n_small,))
        self._set_segments(shapes, runs, pre)

    def _segments_of(self, tree, lead) -> List[torch.Tensor]:
        parts = [tree[self.names[i]] for i in self.native_idx]
        if self.small_idx:
            parts.append(torch.cat([tree[self.names[i]].reshape(*lead, -1)
                                    for i in self.small_idx], -1))
        return parts

    def unpack(self, vec: SegVec) -> Dict[str, torch.Tensor]:
        out = {}
        for j, i in enumerate(self.native_idx):
            out[self.names[i]] = vec.leaves[j]
        if self.small_idx:
            flat = vec.leaves[len(self.native_idx)]
            pieces = torch.split(flat, [self.sizes[i] for i in self.small_idx],
                                 dim=-1)
            for i, p in zip(self.small_idx, pieces):
                out[self.names[i]] = p.reshape(vec.lead + self.shapes[i])
        return {k: out[k] for k in self.names}

    # -- per-ORIGINAL-leaf reductions (diagnostics stay leaf-granular) ------
    def _by_leaf(self, native: List[torch.Tensor],
                 small: Optional[torch.Tensor]) -> torch.Tensor:
        out = [None] * self.n_leaves
        for j, i in enumerate(self.native_idx):
            out[i] = native[j]
        for k, i in enumerate(self.small_idx):
            out[i] = small[..., k]
        return torch.stack(out, -1)

    def segment_sum(self, vec: SegVec) -> torch.Tensor:
        native = [t.reshape(*vec.lead, -1).sum(-1)
                  for t in vec.leaves[:len(self.native_idx)]]
        small = None
        if self.small_idx:
            flat = vec.leaves[len(self.native_idx)]
            lengths = self._small_lengths.to(flat.device).expand(
                *vec.lead, len(self.small_idx)).contiguous()
            small = torch.segment_reduce(flat, "sum", lengths=lengths,
                                         axis=flat.ndim - 1)
        return self._by_leaf(native, small)

    def leaf_firsts(self, vec: SegVec) -> torch.Tensor:
        native = [t.reshape(*vec.lead, -1)[..., 0]
                  for t in vec.leaves[:len(self.native_idx)]]
        small = None
        if self.small_idx:
            flat = vec.leaves[len(self.native_idx)]
            small = flat[..., torch.as_tensor(self.small_offsets[:-1],
                                              device=flat.device)]
        return self._by_leaf(native, small)

    def expand(self, leaf_scalars: torch.Tensor) -> SegVec:
        """(*lead, n_leaves) per-ORIGINAL-leaf scalars -> hybrid form: one
        scalar a native leaf, the small segment's vector"""
        lead = tuple(leaf_scalars.shape[:-1])
        parts = [leaf_scalars[..., i] for i in self.native_idx]
        if self.small_idx:
            small = leaf_scalars[..., torch.as_tensor(
                self.small_idx, device=leaf_scalars.device)]
            parts.append(small[..., self._small_seg_ids.to(small.device)])
        return self.pre_arena(lead).pack(parts)


PACKERS = {"flat": Packer, "segmented": SegPacker, "hybrid": HybridPacker}


def make_packer(packing: str, tree) -> Packer:
    "the packer of a packing name, for a parameter dict"
    if packing not in PACKERS:
        raise ValueError(f"packing {packing!r}: one of {sorted(PACKERS)}")
    return PACKERS[packing](tree)
