"""Carrying weights and state across from the JAX package.

The JAX package keeps the reference torch library's state_dict names in its
param and state stores (`net.0.weight_prior.p`, `net.1.running_mean`, ...),
stores convolution weights OIHW and packs leaves in sorted-name order, as
this package does. So a JAX model's params and state load by name, and a
JAX packed vector is this package's packed vector.
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
