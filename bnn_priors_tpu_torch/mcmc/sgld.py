"""SGLD (SGHMC) kernel: symplectic-Euler underdamped Langevin with RMSProp
preconditioning and temperature diagnostics (counterpart of
`bnn_priors_tpu/mcmc/sgld.py`, flat packing only).

Update rule, elementwise over the packed θ:
    hn = sqrt(lr·N),  h = sqrt(lr/N),  σ = sqrt(2(1-a)T)
    m ← a·m − hn·M^{-1/2}·g + σ·ξ          (ξ ~ N(0,I))
    θ ← θ + h·M^{-1/2}·m
    v ← α·v + (1-α)·g²                       (RMSProp EMA)

Every update goes through `ops.fused_update.fused_langevin_update`: the
CUDA kernel for float32 state on the card, its plain version for a CPU
tensor. float64 state (tests) takes the plain version directly; the kernel
is float32-only and float64 on the card raises.

The state is mutable: θ, m and v are updated IN PLACE by the kernel.
`lr` and `temperature` are host floats, so a step needs no device sync.
Randomness comes from two explicit generators kept in the state: a host
generator for the kernel's per-call seeds and the M-H uniforms, and one on
the state's device for momentum refreshes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

# module import, not names: ops.fused_update imports mcmc.packing, so
# either package may be imported first
from ..ops import fused_update
from .packing import Packer


@dataclass
class SGLDState:
    position: torch.Tensor    # packed θ, (total_padded,)
    momentum: torch.Tensor    # packed m
    grads: torch.Tensor       # packed last-seen gradient
    square_avg: torch.Tensor  # packed RMSProp EMA
    precond: torch.Tensor     # M^{-1/2}, expanded to (total_padded,)
    gen: torch.Generator      # host: kernel seeds, M-H uniforms
    noise_gen: torch.Generator  # on the state's device: momentum refresh


def _generators(seed: int, device) -> tuple:
    gen = torch.Generator().manual_seed(int(seed))
    noise_gen = torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2 ** 62, (), generator=gen)))
    return gen, noise_gen


class SGLD:
    """SGLD kernel over a packed state; one fused update per step."""

    def __init__(self, num_data: float, momentum: float = 0.0,
                 rmsprop_alpha: float = 0.99, rmsprop_eps: float = 1e-8):
        assert num_data >= 0 and momentum >= 0
        self.num_data = float(num_data)
        self.momentum = float(momentum)
        self.rmsprop_alpha = float(rmsprop_alpha)
        self.rmsprop_eps = float(rmsprop_eps)
        self.packer: Optional[Packer] = None

    # -- packing ----------------------------------------------------------
    def _ensure_packer(self, params: Dict[str, torch.Tensor]) -> Packer:
        if self.packer is None:
            self.packer = Packer(params)
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
    def _seed(state) -> int:
        "fresh kernel seed from the state's host generator (no device sync)"
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=state.gen))

    @staticmethod
    def _update(theta, *args, **kw):
        "the kernel, or its plain version for float64 state on the CPU"
        if theta.dtype == torch.float64 and theta.device.type == "cpu":
            return fused_update.fused_langevin_update_reference(
                theta, *args, **kw)
        return fused_update.fused_langevin_update(theta, *args, **kw)

    # -- state ------------------------------------------------------------
    def _init_vectors(self, params, seed):
        packer = self._ensure_packer(params)
        theta = packer.pack({k: v.detach() for k, v in params.items()})
        gen, noise_gen = _generators(seed, theta.device)
        precond = packer.expand(theta.new_ones(packer.n_leaves))
        return dict(position=theta, momentum=torch.zeros_like(theta),
                    grads=torch.zeros_like(theta),
                    square_avg=torch.ones_like(theta), precond=precond,
                    gen=gen, noise_gen=noise_gen)

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
        noise_std = math.sqrt(2.0 * (1.0 - a) * temperature)
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
