"""SGLD (SGHMC) kernel: symplectic-Euler underdamped Langevin with RMSProp
preconditioning and temperature diagnostics (counterpart of
`bnn_priors_tpu/mcmc/sgld.py`).

Update rule, elementwise over the packed θ:
    hn = sqrt(lr·N),  h = sqrt(lr/N),  σ = sqrt(2(1-a)T)
    m ← a·m − hn·M^{-1/2}·g + σ·ξ          (ξ ~ N(0,I))
    θ ← θ + h·M^{-1/2}·m
    v ← α·v + (1-α)·g²                       (RMSProp EMA)

`packing` chooses the chain state's layout (`segmented.py`): "flat" (the
default) is one packed vector and every update is one launch of
`ops.fused_update.fused_langevin_update`; "segmented" (one segment a leaf)
and "hybrid" (the convolutions as their own segments, the small leaves as
one) are a `SegVec` over one buffer and every update is one launch of
`fused_langevin_update_segments`. Each is the CUDA kernel for float32
state on the card and its plain version for a CPU tensor; float64 state
(tests) takes the plain version directly, and float64 on the card raises.
The segments kernel draws each element's noise by its index in the flat
packing, so the three packings draw one noise stream from one seed.

The state is mutable: θ, m and v are updated IN PLACE by the kernel.
`lr` and `temperature` are host floats, so a step needs no device sync.
The kernel's noise for the chain's n-th update is keyed by `key + n`: `key`
is drawn once, at `init`, in [0, 2**62), and `n_updates` counts the
updates, so no two updates of a chain (nor of two chains) share a stream,
and both are part of a checkpoint. The other randomness comes from two
explicit generators kept in the state: a host generator for the M-H
uniforms, and one on the state's device for momentum refreshes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

# module import, not names: ops.fused_update imports mcmc.packing, so
# either package may be imported first
from ..ops import fused_update
from .packing import Packer
from .segmented import (SegVec, from_named_arrays, make_packer, named_arrays,
                        vapply)

VECTORS = ("position", "momentum", "grads", "square_avg", "precond")


@dataclass
class SGLDState:
    # packed vectors: (total_padded,) tensors (flat) or SegVecs
    position: torch.Tensor    # θ
    momentum: torch.Tensor    # m
    grads: torch.Tensor       # last-seen gradient
    square_avg: torch.Tensor  # RMSProp EMA
    precond: torch.Tensor     # M^{-1/2}: expanded (flat), a scalar a leaf
    gen: torch.Generator      # host: M-H uniforms
    noise_gen: torch.Generator  # on the state's device: momentum refresh
    key: int                  # the kernel's Philox key, in [0, 2**62)
    n_updates: int = 0        # fused updates so far: the seeds' counter

    # -- checkpoints (io/checkpoint.py) --------------------------------------
    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """the tensors a checkpoint holds, by name (a SegVec field as its
        segments, `<field>.<packing>.<i>`); key and counter as int64"""
        out = {}
        for k in VECTORS:
            out.update(named_arrays(k, getattr(self, k)))
        out["key"] = torch.tensor(self.key, dtype=torch.int64)
        out["n_updates"] = torch.tensor(self.n_updates, dtype=torch.int64)
        return out

    def generators(self) -> Dict[str, torch.Generator]:
        "the generators a checkpoint holds, by name"
        return {"gen": self.gen, "noise_gen": self.noise_gen}

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        "the tensors from a checkpoint's arrays, on the state's device"
        arrays = dict(arrays)
        self.key = int(arrays.pop("key"))
        self.n_updates = int(arrays.pop("n_updates"))
        load_vectors(self, arrays, VECTORS)


def load_vectors(state, arrays: dict, fields) -> None:
    """set the state's vector `fields` from a checkpoint's arrays (popped),
    each in the form of the field it replaces, on the state's device"""
    device = state.position.device
    to_tensor = lambda v: on_device(v, device)
    for k in fields:
        setattr(state, k, from_named_arrays(arrays, k, getattr(state, k),
                                            to_tensor))
    if arrays:
        raise KeyError(f"checkpoint entries {sorted(arrays)} are not the "
                       "state's (structure mismatch)")


def on_device(array, device) -> torch.Tensor:
    "a numpy array as a tensor of its own on `device`"
    return torch.from_numpy(np.array(array)).to(device)


def _bases(*vecs) -> tuple:
    "the buffers of SegVecs, for the segments kernel"
    for v in vecs:
        if v.base is None:
            raise ValueError("a SegVec without a buffer (a leaf-wise result) "
                             "cannot go to the segments kernel")
    return tuple(v.base for v in vecs)


def _generators(seed: int, device) -> tuple:
    "(host generator, device generator, Philox key) of a chain seed"
    gen = torch.Generator().manual_seed(int(seed))
    draw = lambda: int(torch.randint(0, 2 ** 62, (), generator=gen))
    noise_gen = torch.Generator(device=device).manual_seed(draw())
    return gen, noise_gen, draw()


class SGLD:
    """SGLD kernel over a packed state; one fused update per step."""

    def __init__(self, num_data: float, momentum: float = 0.0,
                 rmsprop_alpha: float = 0.99, rmsprop_eps: float = 1e-8,
                 packing: str = "flat"):
        assert num_data >= 0 and momentum >= 0
        assert packing in ("flat", "segmented", "hybrid")
        self.packing = packing
        self.num_data = float(num_data)
        self.momentum = float(momentum)
        self.rmsprop_alpha = float(rmsprop_alpha)
        self.rmsprop_eps = float(rmsprop_eps)
        self.packer: Optional[Packer] = None

    # -- packing ----------------------------------------------------------
    def _ensure_packer(self, params: Dict[str, torch.Tensor]) -> Packer:
        "the packer of the kernel's packing (sgld.py:86-92), made once"
        if self.packer is None:
            self.packer = make_packer(self.packing, params)
        return self.packer

    def pack(self, tree):
        return self.packer.pack(tree)

    def unpack(self, vec):
        return self.packer.unpack(vec)

    def params_of(self, state) -> Dict[str, torch.Tensor]:
        "parameter dict (views) of a chain state"
        return self.packer.unpack(state.position)

    def leaf_precond(self, state) -> torch.Tensor:
        "per-leaf (n_leaves,) preconditioner scalars, for diagnostics"
        return self.packer.leaf_firsts(state.precond)

    @staticmethod
    def _noise_std(c, temperature):
        "σ = sqrt(c·T) for a host-float temperature"
        return math.sqrt(c * temperature)

    @staticmethod
    def _seed(state) -> int:
        "this update's kernel seed, key + n; counts the update"
        seed = state.key + state.n_updates
        state.n_updates += 1
        return seed

    def _update(self, theta, momentum, square_avg, grads, precond, seed,
                coeffs, *, total):
        """the kernel of the state's packing (one launch), or its plain
        version for float64 state on the CPU; returns its partials"""
        plain = theta.dtype == torch.float64 and theta.device.type == "cpu"
        if isinstance(theta, SegVec):
            table = self.packer.kernel_table(theta.lead, theta.device,
                                             fused_update.SEGMENT_CHUNK)
            fn = (fused_update.fused_langevin_update_segments_reference
                  if plain else fused_update.fused_langevin_update_segments)
            *_, partials = fn(*_bases(theta, momentum, square_avg, grads,
                                      precond), seed, coeffs, table=table)
            return partials
        fn = (fused_update.fused_langevin_update_reference if plain
              else fused_update.fused_langevin_update)
        *_, partials = fn(theta, momentum, square_avg, grads, precond, seed,
                          coeffs, total=total)
        return partials

    # -- state ------------------------------------------------------------
    def _init_vectors(self, params, seed):
        packer = self._ensure_packer(params)
        theta = packer.pack({k: v.detach() for k, v in params.items()})
        gen, noise_gen, key = _generators(seed, theta.device)
        precond = packer.expand(torch.ones(packer.n_leaves, dtype=theta.dtype,
                                           device=theta.device))
        return dict(position=theta, momentum=vapply(torch.zeros_like, theta),
                    grads=vapply(torch.zeros_like, theta),
                    square_avg=vapply(torch.ones_like, theta),
                    precond=precond, gen=gen, noise_gen=noise_gen, key=key)

    def init(self, params, seed: int = 0) -> SGLDState:
        return SGLDState(**self._init_vectors(params, seed))

    def sample_momentum(self, state, temperature, keep=0.0):
        "m ← sqrt(keep)·m + sqrt(T(1-keep))·ξ (reference sgld.py:57-69)"
        noise = self.packer.normal_like(state.noise_gen, state.momentum)
        std = math.sqrt(temperature * (1.0 - keep))
        state.momentum = math.sqrt(keep) * state.momentum + std * noise
        return state

    # -- metrics ----------------------------------------------------------
    def _metrics(self, state, grads, momentum_vec):
        """est_temperature = ‖m‖²/d and est_config_temp = ⟨θ,g⟩·N/d per leaf
        (reference sgld.py:127-146), via segment reductions."""
        pk = self.packer
        d = pk.lengths.to(state.position.dtype)
        est_temp = pk.segment_sum(momentum_vec * momentum_vec) / d
        est_conf = pk.segment_sum(state.position * grads) * (self.num_data / d)
        return {
            "est_temperature": pk.unpack_leaf_scalars(est_temp),
            "est_config_temp": pk.unpack_leaf_scalars(est_conf),
        }

    # -- step -------------------------------------------------------------
    def step(self, state: SGLDState, grads, lr, temperature,
             calc_metrics: bool = True, is_final: bool = False):
        """One SGLD transition. `grads` is the packed, already clipped
        gradient. Updates `state` in place and returns (state, metrics)."""
        a = self.momentum
        hn = math.sqrt(lr * self.num_data)
        h = math.sqrt(lr / self.num_data)
        noise_std = self._noise_std(2.0 * (1.0 - a), temperature)
        M = state.precond
        seed = self._seed(state)

        metrics = {}
        if calc_metrics:
            # diagnostics use the momentum of the previous time step
            mom_nominal = state.momentum if a > 0 else -hn * M * grads
            metrics = self._metrics(state, grads, mom_nominal)

        if not is_final:
            self._update(state.position, state.momentum, state.square_avg,
                         grads, M, seed, (a, -hn, noise_std, h,
                                          self.rmsprop_alpha),
                         total=self.packer.total)
        state.grads = grads
        return state, metrics

    def initial_step(self, state, grads, lr, temperature, save_state=False,
                     calc_metrics=True):
        assert not save_state, "SGLD keeps no rejection state (sgld.py:72-74)"
        return self.step(state, grads, lr, temperature, calc_metrics)

    def final_step(self, state, grads, lr, temperature, calc_metrics=True):
        return self.step(state, grads, lr, temperature, calc_metrics,
                         is_final=True)

    def delta_energy(self, state, grads, lr, prev_potential, potential):
        "SGLD never passes M-H (reference sgld.py:54-55)."
        return math.inf

    # -- preconditioner ----------------------------------------------------
    def update_preconditioner(self, state: SGLDState) -> SGLDState:
        """M^{-1/2}_leaf = ((mean(v_leaf)+eps) / min_over_leaves)^(-1/4)
        (reference sgld.py:156-179): segment means + a global min."""
        means = self.packer.leaf_means(state.square_avg) + self.rmsprop_eps
        # min over one chain's leaves: a (K, T) bank gets one row a chain
        state.precond = self.packer.expand(
            (means / means.amin(-1, keepdim=True)) ** (-0.25))
        return state
