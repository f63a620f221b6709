"""Carrying weights and state across from the JAX package.

The JAX package keeps the reference torch library's state_dict names in its
param and state stores (`net.0.weight_prior.p`, `net.1.running_mean`, ...),
stores convolution weights OIHW and packs leaves in sorted-name order, as
this package does. So a JAX model's params and state load by name, a JAX
packed vector is this package's packed vector, and a JAX checkpoint of a
flat, segmented or hybrid run loads into the port's runner
(`load_jax_checkpoint`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .mcmc.packing import Packer
from .mcmc.segmented import SegVec, from_named_arrays, make_packer
from .mcmc.sgld import VECTORS
from .mcmc.verlet_sgld import SAVED


@torch.no_grad()
def load_jax_state(model: torch.nn.Module, params: Dict[str, np.ndarray],
                   state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Load a JAX model's `params` and `state` stores (numpy arrays) into
    `model`'s state_dict, in place. Both sides must have exactly the same
    key set and shapes; values take the port model's dtypes (this converts
    `num_batches_tracked` from JAX's int32 to torch's int64)."""
    theirs = {**params, **state}
    if len(theirs) != len(params) + len(state):
        raise ValueError("params and state share keys: "
                         f"{sorted(set(params) & set(state))}")
    ours = model.state_dict()
    if set(theirs) != set(ours):
        raise KeyError(f"only in JAX: {sorted(set(theirs) - set(ours))}; "
                       f"only in the port: {sorted(set(ours) - set(theirs))}")
    for k, v in theirs.items():
        v = np.array(v)  # a writable copy
        if tuple(v.shape) != tuple(ours[k].shape):
            raise ValueError(f"{k}: JAX shape {v.shape}, port shape "
                             f"{tuple(ours[k].shape)}")
        ours[k].copy_(torch.as_tensor(v).to(ours[k].dtype))
    return model


def packed_from_jax(packer: Packer, vec) -> torch.Tensor:
    """A JAX `Packer.pack` vector as this package's packed vector: the
    identity, since both pack the same leaves in the same (sorted) order
    with the same zero padding to PACK_ALIGN."""
    vec = np.asarray(vec)
    if vec.shape != (packer.total_padded,):
        raise ValueError(f"expected ({packer.total_padded},), got {vec.shape}")
    return torch.as_tensor(vec.copy(), device=packer.device)


_KEY_PREFIX = "__prngkey__"  # the JAX checkpoint's tag of a typed key


def _jax_group(data, group):
    "a JAX checkpoint group's untagged leaves, in leaf order"
    out, i = [], 0
    while True:
        if f"{group}_{i}" in data.files:
            out.append(data[f"{group}_{i}"])
        elif _KEY_PREFIX + f"{group}_{i}" not in data.files:
            return out
        i += 1


def _file_packing(pk, lead, leaves, own):
    """(packing, its packer) of a JAX checkpoint's chain leaves: the
    packing whose position segments have the leading leaves' shapes, the
    runner's own packing tried first (hybrid and segmented coincide when
    every leaf is native); None if none does"""
    shapes = {n: torch.empty(s) for n, s in zip(pk.names, pk.shapes)}
    for packing in (own,) + tuple(p for p in ("flat", "segmented", "hybrid")
                                  if p != own):
        cand = make_packer(packing, shapes)
        seg = ([(cand.total_padded,)] if packing == "flat"
               else cand.seg_shapes)
        got = [tuple(v.shape) for v in leaves[:len(seg)]]
        if got == [lead + s for s in seg]:
            return packing, cand
    return None, None


def _jax_fields(path, leaves, n_seg, live):
    """the JAX state's fields, in its leaf order: the five vectors (n_seg
    leaves each), then, for a GGMC state, the two energy accumulators and
    the rollback slots where the port's state keeps them"""
    scalars = [k for k in ("delta_energy_acc", "prev_nmd") if k in live]
    saved = SAVED[0] in live or any(k.startswith(SAVED[0] + ".")
                                    for k in live)
    n = n_seg * (len(VECTORS) + (len(SAVED) if saved else 0)) + len(scalars)
    if len(leaves) != n:
        raise KeyError(f"{path}: {len(leaves)} chain leaves, the port's "
                       f"state takes {n} ({sorted(live)}; structure "
                       "mismatch)")
    it = iter(leaves)
    take = lambda: [next(it) for _ in range(n_seg)]
    fields = {k: take() for k in VECTORS}
    fields.update({k: [next(it)] for k in scalars})
    if saved:
        fields.update({k: take() for k in SAVED})
    return fields


def _to_port(path, fields, src, src_packing, dst, dst_packing, lead):
    """{entry name: numpy array} of the port's state from the JAX fields:
    leaf for leaf in the runner's own packing, reordered into a flat one
    (`HybridPacker`'s native_idx, small_idx and small_offsets, through the
    parameter leaves); any other pair raises"""
    out = {}
    if src_packing == dst_packing:
        for k, parts in fields.items():
            if len(parts) == 1 and dst_packing == "flat" or k not in VECTORS \
                    and k not in SAVED:
                out[k] = parts[0]
            else:
                out.update({f"{k}.{dst.tag}.{i}": p
                            for i, p in enumerate(parts)})
        return out
    if dst_packing != "flat":
        raise ValueError(
            f"{path}: a {src_packing} JAX checkpoint; the port's runner "
            f"packs its state {dst_packing}: a JAX file loads into a flat "
            "runner or a runner of the file's own packing")
    for k, parts in fields.items():
        if k not in VECTORS and k not in SAVED:
            out[k] = parts[0]
            continue
        vec = SegVec([torch.as_tensor(np.asarray(p)) for p in parts], lead)
        if k == "precond":  # leaf-constant: one scalar a leaf
            flat = dst.expand(src.leaf_firsts(vec))
        else:
            flat = dst.pack(src.unpack(vec))
        out[k] = flat.numpy()
    return out


def load_jax_checkpoint(path, runner):
    """Load a JAX `chain.ckpt.npz` (a single-chain runner's) or
    `chains.ckpt.npz` (a `MultiChainRunner`'s or `MultiChainRunnerReject`'s,
    of any kernel, with or without rollback slots) into the port's `runner`
    of the same model and configuration: the chain state, the model
    buffers, the loop metadata and the base potentials. Returns the
    (next_epoch_index, step) to pass as `runner.run(resume_from=...)`.

    The file's packing ("flat", "segmented" or "hybrid": the JAX runners'
    default, so every file the JAX CLI writes) is read from its leaf
    shapes. A file loads leaf for leaf into a runner of its own packing,
    and into a flat runner by reordering its segments into the packed
    order; any other pair raises, as does a file of another model.

    The JAX file's leaves are its `VerletSGLDState` (or `SGLDState`) fields
    in order (position, momentum, grads, square_avg, precond,
    delta_energy_acc, prev_nmd, saved..., key), each `SegVec` field one
    leaf a segment (`bnn_priors_tpu/io/checkpoint.py:38-39`), and its model
    state sorted by name. Its random state is NOT carried across: threefry
    keys cannot become Philox streams, so the port's runner keeps its own
    generators, keys and fixed-order seeds (re-seeded from the port's own
    seed), and a run resumed from a JAX file continues the JAX run exactly
    only where no noise enters (temperature 0, a fixed minibatch order)."""
    chains = getattr(runner, "chains", None)
    state = chains if chains is not None else runner.chain
    pk = runner.kernel.packer
    lead = pk.lead_of(state.position)
    live = {k: v for k, v in state.state_arrays().items()
            if k not in ("key", "keys", "n_updates")}
    buffers = (runner.buffers if chains is not None
               else dict(runner.model.named_buffers()))
    with np.load(path) as data:
        leaves = _jax_group(data, "chain")
        mstate = _jax_group(data, "mstate")
        meta = {k[len("meta_"):]: data[k][()] for k in data.files
                if k.startswith("meta_")}
    packing, src = _file_packing(pk, lead, leaves, runner.kernel.packing)
    if packing is None:
        raise ValueError(
            f"{path}: its first chain leaf has shape "
            f"{leaves[0].shape if leaves else None}: not a flat, segmented "
            f"or hybrid state of the runner's model (a flat position is "
            f"{lead + (pk.flat_padded,)})")
    n_seg = 1 if packing == "flat" else src.n_segments
    fields = _jax_fields(path, leaves, n_seg, live)
    if len(mstate) != len(buffers):
        raise KeyError(f"{path}: {len(mstate)} model-state leaves, the "
                       f"port's model has {len(buffers)} buffers")
    ported = _to_port(path, fields, src, packing, pk, runner.kernel.packing,
                      lead)
    if set(ported) != set(live):
        raise KeyError(f"{path}: entries {sorted(ported)}, the port's state "
                       f"takes {sorted(live)} (structure mismatch)")
    arrays = {}
    for k, t in live.items():
        v = np.asarray(ported[k])
        if v.shape != tuple(t.shape):
            raise ValueError(f"{path}: {k} has shape {v.shape}, the port's "
                             f"{tuple(t.shape)}")
        arrays[k] = v.astype(torch.empty(0, dtype=t.dtype).numpy().dtype)
    with torch.no_grad():
        for k, v in zip(sorted(buffers), mstate):
            if v.shape != tuple(buffers[k].shape):
                raise ValueError(f"{path}: model state {k} has shape "
                                 f"{v.shape}, the port's "
                                 f"{tuple(buffers[k].shape)}")
            buffers[k].copy_(torch.as_tensor(np.array(v)).to(
                buffers[k].dtype))
    own = {"n_updates": state.n_updates}
    if chains is None:
        own["key"] = state.key
    state.load_state_arrays({**arrays, **own})
    finite = np.ones(lead, bool)
    for p in fields["position"]:
        finite &= np.isfinite(p).reshape(*lead, -1).all(-1)
    return runner._restore_meta(_port_meta(runner, meta, finite))


def _port_meta(runner, meta, finite):
    """the port's loop metadata from a JAX checkpoint's: the JAX file's
    counters and potentials, the port runner's own seeds; `finite`: which
    chains' positions are finite"""
    meta = dict(meta)
    meta.pop("perm_key", None)  # the port's orders keep their own seeds
    if hasattr(runner, "chains"):
        meta["nan_chains"] = np.flatnonzero(~finite)
    if hasattr(runner, "_perm_seeds"):  # a chain runner with M-H records
        des = np.asarray(meta.get("delta_energies",
                                  np.zeros((0, runner.n_chains))))
        total = np.zeros(runner.n_chains)
        for d in des:  # the runner's running sum, in its order
            total = total + d
        meta.update(total_energies=total,
                    perm_seeds=np.asarray(runner._perm_seeds))
    return meta


@torch.no_grad()
def load_jax_chains(runner, positions, model_states):
    """Start a chain runner (`parallel.MultiChainRunner`) from a JAX chain
    runner's stacked state, given as numpy arrays: `positions`, the JAX
    `states.position` (a (K, T) packed bank, identical to the port's flat
    one, see `packed_from_jax`; or a hybrid or segmented state's list of
    (K, ...) segments), and `model_states` {name: (K, ...)}, each chain's
    batchnorm state. The positions go into the runner's packing as
    `load_jax_checkpoint` carries a file's. Overwrites the chains' positions
    (and their rollback copies) and batchnorm state in place; returns the
    runner."""
    chains = runner.chains
    pk = runner.kernel.packer
    lead = pk.lead_of(chains.position)
    parts = ([np.asarray(p) for p in positions]
             if isinstance(positions, (list, tuple))
             else [np.asarray(positions)])
    packing, src = _file_packing(pk, lead, parts, runner.kernel.packing)
    if packing is None or len(parts) != (1 if packing == "flat"
                                         else src.n_segments):
        raise ValueError(f"positions of shapes {[p.shape for p in parts]}: "
                         f"not a flat, segmented or hybrid state of the "
                         f"runner's {lead[0]} chains (a flat bank is "
                         f"{lead + (pk.flat_padded,)})")
    ported = _to_port("positions", {"position": parts}, src, packing, pk,
                      runner.kernel.packing, lead)
    dtype = chains.position.dtype
    chains.position.copy_(from_named_arrays(
        ported, "position", chains.position,
        lambda v: torch.as_tensor(np.array(v)).to(chains.position.device,
                                                  dtype)))
    if getattr(chains, "saved", None) is not None:
        chains.saved[0].copy_(chains.position)
    ours = runner.buffers
    if set(model_states) != set(ours):
        raise KeyError(f"only in JAX: {sorted(set(model_states) - set(ours))}"
                       f"; only in the port: "
                       f"{sorted(set(ours) - set(model_states))}")
    for k, v in model_states.items():
        v = np.array(v)  # a writable copy
        if tuple(v.shape) != tuple(ours[k].shape):
            raise ValueError(f"{k}: JAX shape {v.shape}, port shape "
                             f"{tuple(ours[k].shape)}")
        ours[k].copy_(torch.as_tensor(v).to(ours[k].dtype))
    return runner
