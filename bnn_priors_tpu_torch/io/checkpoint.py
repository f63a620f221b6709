"""Full chain-state checkpoints (counterpart of
`bnn_priors_tpu/io/checkpoint.py`).

A checkpoint is the complete state of a run: resuming from it continues
the same trajectory bit for bit, where the reference's only resume is a
warm start from the last saved sample.

Format: one `.npz` of named entries. `chain.<name>` holds the chain
state's tensors (`position`, `momentum`, `saved_position`, ...; the
states' `state_arrays()`), `buffers.<name>` the model's buffers (the
batchnorm statistics), `gen.<device type>.<name>` each `torch.Generator`'s
`get_state()` as uint8 (the runner's host generator, the chain's host and
device generators; K chains keep one of each a chain, `gens.<k>`), and
`meta.<name>` the loop metadata. A generator's state restores only onto a
generator of the same device type. Files are written atomically (a
temporary file, then `os.replace`), so a crash mid-write leaves the
previous checkpoint as it was.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ("save_chain_checkpoint", "load_chain_checkpoint",
           "restore_chain_checkpoint")


def _host(value) -> np.ndarray:
    "a tensor, numpy array or Python scalar as a numpy array"
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _spec(value) -> Tuple[tuple, np.dtype]:
    "(shape, numpy dtype) of a live value, without copying a tensor"
    if torch.is_tensor(value):
        return (tuple(value.shape),
                torch.empty(0, dtype=value.dtype).numpy().dtype)
    value = np.asarray(value)
    return value.shape, value.dtype


def save_chain_checkpoint(path, chain: Dict[str, Any],
                          buffers: Dict[str, torch.Tensor],
                          generators: Dict[str, torch.Generator],
                          meta: Dict[str, Any]) -> None:
    """Write the chain state, the model buffers, the generators' states and
    the loop metadata (numbers or arrays) to `path`, atomically. A
    generator is a `torch.Generator` or its (device type, `get_state()`)
    pair, as another rank sends it for the gathered write."""
    arrays: Dict[str, np.ndarray] = {}
    for k, v in chain.items():
        arrays["chain." + k] = _host(v)
    for k, v in buffers.items():
        arrays["buffers." + k] = _host(v)
    for k, g in generators.items():
        if isinstance(g, torch.Generator):
            g = (g.device.type, g.get_state().numpy())
        arrays[f"gen.{g[0]}.{k}"] = np.asarray(g[1])
    for k, v in meta.items():
        arrays["meta." + k] = _host(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _restore_group(data, group, template) -> Dict[str, np.ndarray]:
    """the group's arrays, each checked against the live tensor of the same
    name: the same names, shapes and dtypes"""
    out = {}
    for k, t in template.items():
        name = f"{group}.{k}"
        if name not in data.files:
            raise KeyError(f"checkpoint missing leaf {name} "
                           "(structure mismatch)")
        arr = data[name]
        shape, dtype = _spec(t)
        if arr.shape != shape:
            raise ValueError(
                f"checkpoint leaf {name} has shape {arr.shape} but the "
                f"current model expects {shape} — resume requires the "
                "identical model/config")
        if arr.dtype != dtype:
            raise ValueError(
                f"checkpoint leaf {name} has dtype {arr.dtype} but the "
                f"current model expects {dtype} — resume requires the "
                "identical model/config")
        out[k] = arr
    extra = sorted(n for n in data.files if n.startswith(group + ".")
                   and n[len(group) + 1:] not in template)
    if extra:
        raise KeyError(f"checkpoint has leaves {extra} that the runner does "
                       "not (structure mismatch)")
    return out


def _restore_generators(data, generators) -> Dict[str, torch.Tensor]:
    "each generator's saved state, from a generator of its device type"
    out = {}
    for k, g in generators.items():
        name = f"gen.{g.device.type}.{k}"
        if name not in data.files:
            other = [n for n in data.files
                     if n.startswith("gen.") and n.split(".", 2)[2] == k]
            if other:
                raise ValueError(
                    f"checkpoint generator {k} was saved on "
                    f"{other[0].split('.')[1]}, the runner's is on "
                    f"{g.device.type}: a generator's state restores only on "
                    "its own device type")
            raise KeyError(f"checkpoint missing generator {k} "
                           "(structure mismatch)")
        out[k] = torch.from_numpy(data[name].copy())
    return out


def load_chain_checkpoint(path, chain, buffers, generators
                          ) -> Tuple[Dict[str, np.ndarray],
                                     Dict[str, np.ndarray],
                                     Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read `path` against the live runner's chain tensors, buffers and
    generators (the same names as at save). Returns (chain arrays, buffer
    arrays, generator states, meta); every entry is checked before any is
    returned, so a mismatch leaves the runner as it was."""
    with np.load(path, allow_pickle=False) as data:
        chain_arrays = _restore_group(data, "chain", chain)
        buffer_arrays = _restore_group(data, "buffers", buffers)
        states = _restore_generators(data, generators)
        meta = {k[len("meta."):]: data[k] for k in data.files
                if k.startswith("meta.")}
    meta = {k: (v[()] if v.ndim == 0 else v) for k, v in meta.items()}
    return chain_arrays, buffer_arrays, states, meta


def restore_chain_checkpoint(path, state, buffers, generators
                             ) -> Dict[str, Any]:
    """`load_chain_checkpoint` into a live runner: the chain `state` (its
    `load_state_arrays`), the model `buffers` (in place) and the
    `generators`; returns the metadata"""
    arrays, bufs, states, meta = load_chain_checkpoint(
        path, state.state_arrays(), buffers, generators)
    state.load_state_arrays(arrays)
    with torch.no_grad():
        for k, v in bufs.items():
            buffers[k].copy_(torch.from_numpy(v))
    for k, s in states.items():
        generators[k].set_state(s)
    return meta
