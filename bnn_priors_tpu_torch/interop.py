"""Carrying weights and state across from the JAX package.

The JAX package keeps the reference torch library's state_dict names in its
param and state stores (`net.0.weight_prior.p`, `net.1.running_mean`, ...),
stores convolution weights OIHW and packs leaves in sorted-name order, as
this package does. So a JAX model's params and state load by name, a JAX
packed vector is this package's packed vector, and a JAX checkpoint of a
flat-packed run loads into the port's runner (`load_jax_checkpoint`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .mcmc.packing import Packer


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


def load_jax_checkpoint(path, runner):
    """Load a JAX `chain.ckpt.npz` (a single-chain runner's) or
    `chains.ckpt.npz` (`MultiChainRunnerReject`'s), written with
    `packing="flat"`, into the port's `runner` of the same model and
    configuration: the chain state, the model buffers, the loop metadata
    and the base potentials. Returns the (next_epoch_index, step) to pass
    as `runner.run(resume_from=...)`.

    The JAX file's leaves are its `VerletSGLDState` (or `SGLDState`) fields
    in order (position, momentum, grads, square_avg, precond,
    delta_energy_acc, prev_nmd, saved..., key), and its model state sorted
    by name. Its random state is NOT carried across: threefry keys cannot
    become Philox streams, so the port's runner keeps its own generators,
    keys and fixed-order seeds (re-seeded from the port's own seed), and a
    run resumed from a JAX file continues the JAX run exactly only where no
    noise enters (temperature 0, a fixed minibatch order)."""
    chains = getattr(runner, "chains", None)
    state = chains if chains is not None else runner.chain
    live = {k: v for k, v in state.state_arrays().items()
            if k not in ("key", "keys", "n_updates")}
    buffers = (runner.buffers if chains is not None
               else dict(runner.model.named_buffers()))
    with np.load(path) as data:
        leaves = _jax_group(data, "chain")
        mstate = _jax_group(data, "mstate")
        meta = {k[len("meta_"):]: data[k][()] for k in data.files
                if k.startswith("meta_")}
    pos_shape = tuple(state.position.shape)
    if not leaves or leaves[0].shape != pos_shape:
        raise ValueError(
            f"{path}: its first chain leaf has shape "
            f"{leaves[0].shape if leaves else None}, a flat-packed position "
            f"{pos_shape}: a hybrid or segmented JAX checkpoint, which the "
            "port cannot read (ROADMAP item 1, the segmented and hybrid "
            "packers)")
    if len(leaves) != len(live):
        raise KeyError(f"{path}: {len(leaves)} chain leaves, the port's "
                       f"state has {len(live)} ({sorted(live)}; structure "
                       "mismatch)")
    if len(mstate) != len(buffers):
        raise KeyError(f"{path}: {len(mstate)} model-state leaves, the "
                       f"port's model has {len(buffers)} buffers")
    arrays = {}
    for (k, t), v in zip(live.items(), leaves):
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
    return runner._restore_meta(_port_meta(runner, meta, arrays))


def _port_meta(runner, meta, arrays):
    """the port's loop metadata from a JAX checkpoint's: the JAX file's
    counters and potentials, the port runner's own seeds"""
    meta = dict(meta)
    meta.pop("perm_key", None)  # the port's orders keep their own seeds
    if hasattr(runner, "chains"):
        des = np.asarray(meta.get("delta_energies",
                                  np.zeros((0, runner.n_chains))))
        total = np.zeros(runner.n_chains)
        for d in des:  # the runner's running sum, in its order
            total = total + d
        meta.update(total_energies=total,
                    perm_seeds=np.asarray(runner._perm_seeds),
                    nan_chains=np.flatnonzero(
                        ~np.isfinite(arrays["position"]).all(-1)))
    return meta


@torch.no_grad()
def load_jax_chains(runner, positions, model_states):
    """Start a chain runner (`parallel.MultiChainRunner`) from a JAX chain
    runner's stacked state, given as numpy arrays: `positions` (K, T), the
    JAX `states.position` packed vectors (identical to the port's, see
    `packed_from_jax`), and `model_states` {name: (K, ...)}, each chain's
    batchnorm state. Overwrites the chains' positions (and their rollback
    copies) and batchnorm state in place; returns the runner."""
    chains = runner.chains
    pos = np.asarray(positions)
    if pos.shape != tuple(chains.position.shape):
        raise ValueError(f"expected {tuple(chains.position.shape)}, got "
                         f"{pos.shape}")
    chains.position.copy_(torch.as_tensor(pos))
    if chains.saved is not None:
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
