"""GGMC / VerletSGLD kernel: OBABO symmetric-splitting underdamped Langevin
with incremental energy accounting for an exact Metropolis–Hastings test
(counterpart of `bnn_priors_tpu/mcmc/verlet_sgld.py`, flat packing only).

Three-phase transition protocol:

  initial_step  θ(n),m(n) → θ(n+1),u(n+1)    (mom_decay=√a, grad_v=1,   σ²=(1-a)T)
  step          θ(n),u(n) → θ(n+1),u(n+1)    (mom_decay=a,  grad_v=1+a, σ²=(1-a²)T)
  final_step    θ(n),u(n) → θ(n),m(n)        (mom_decay=√a, grad_v=√a,  σ²=(1-a)T)

Energy bookkeeping with two scalar accumulators (kept on the device, in the
parameter dtype):
    point_energy      = Σ M⁻¹·N²·b²h²/8·g²
    delta_energy_acc += prev_nmd + Σ c_gm·g·m_old
    prev_nmd          = Σ c_gm·g·m_new              (c_gm = -½·bhn·M^{-1/2})
    ΔE(prev_U, U)     = delta_energy_acc + point_energy + (U - prev_U)·N
The three sums come from the fused kernel's partials, so a phase is one
pass over the state.

The kernel updates θ and m IN PLACE, so the rollback state `saved` holds
CLONES of (position, momentum, grads): references would be overwritten by
the next step. The M-H decision is taken on the host from ΔE, which the
runner reads once per boundary anyway.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .segmented import vsum
from .sgld import SGLD, SGLDState


@dataclass
class VerletSGLDState(SGLDState):
    delta_energy_acc: Optional[torch.Tensor] = None  # 0-d, param dtype
    prev_nmd: Optional[torch.Tensor] = None          # 0-d, param dtype
    saved: Optional[Tuple[torch.Tensor, ...]] = None  # (position, momentum, grads)


class VerletSGLD(SGLD):
    """GGMC kernel. `temperature`/`lr` are host floats; `momentum` fixed."""

    def init(self, params, seed: int = 0,
             save_state: bool = False) -> VerletSGLDState:
        vecs = self._init_vectors(params, seed)
        theta = vecs["position"]
        zero = theta.new_zeros(())
        saved = ((theta.clone(), vecs["momentum"].clone(),
                  vecs["grads"].clone()) if save_state else None)
        return VerletSGLDState(**vecs, delta_energy_acc=zero,
                               prev_nmd=zero.clone(), saved=saved)

    # -- phase constants ---------------------------------------------------
    def _constants(self, lr, temperature, kind: str):
        a = self.momentum
        bh = math.sqrt(lr / self.num_data)
        bhn = math.sqrt(lr * self.num_data)
        if kind == "mid":
            mom_decay, grad_v = a, 1.0 + a
            noise_std = math.sqrt((1 - a ** 2) * temperature)
        elif kind == "initial":
            mom_decay, grad_v = a ** 0.5, 1.0
            noise_std = math.sqrt((1 - a) * temperature)
        elif kind == "final":
            mom_decay = grad_v = a ** 0.5
            noise_std = math.sqrt((1 - a) * temperature)
        else:  # pragma: no cover
            raise ValueError(kind)
        return bh, bhn, mom_decay, grad_v, noise_std

    def _point_energy(self, state, grads, lr):
        "Σ M⁻¹·N²·b²h²/8·g² (verlet_sgld.py:44-47)"
        curv_c = self.num_data * lr / 8.0  # N²·(lr/N)/8
        return curv_c * vsum((state.precond * grads) ** 2)

    # -- the shared transition --------------------------------------------
    def _step(self, state: VerletSGLDState, grads, lr, temperature,
              kind: str, save_state: bool = False, calc_metrics: bool = True):
        bh, bhn, mom_decay, grad_v, noise_std = self._constants(
            lr, temperature, kind)
        seed = self._seed(state)
        if save_state:
            assert kind == "initial"
            state.saved = (state.position.clone(), state.momentum.clone(),
                           grads.clone())

        grad_lr = -0.5 * grad_v * bhn
        c_gm = -0.5 * bhn
        is_final = kind == "final"
        pos_c = 0.0 if is_final else bh
        alpha = 1.0 if is_final else self.rmsprop_alpha

        metrics = {}
        if calc_metrics and not is_final:
            # θ and m are about to be overwritten in place: the diagnostics
            # of a moving step read the old ones
            metrics = self._metrics(state, grads, state.momentum)
        _, _, _, partials = self._update(
            state.position, state.momentum, state.square_avg, grads,
            state.precond, seed, (mom_decay, grad_lr, noise_std, pos_c, alpha),
            total=self.packer.total)
        g_mold = c_gm * partials[0]
        g_mnew = c_gm * partials[1]
        pe_initial = (self.num_data * lr / 8.0) * partials[2]
        if calc_metrics and is_final:
            # final_step leaves θ where it was and reads the new momentum
            metrics = self._metrics(state, grads, state.momentum)

        # incremental energy accounting
        if kind == "initial":
            state.delta_energy_acc = -pe_initial
        else:
            state.delta_energy_acc = (state.delta_energy_acc + state.prev_nmd
                                      + g_mold)
        state.prev_nmd = g_mnew
        state.grads = grads
        return state, metrics

    # -- public API (reference protocol) ----------------------------------
    def initial_step(self, state, grads, lr, temperature, save_state=False,
                     calc_metrics=True):
        return self._step(state, grads, lr, temperature, "initial",
                          save_state, calc_metrics)

    def step(self, state, grads, lr, temperature, calc_metrics=True):
        return self._step(state, grads, lr, temperature, "mid", False,
                          calc_metrics)

    def final_step(self, state, grads, lr, temperature, calc_metrics=True):
        return self._step(state, grads, lr, temperature, "final", False,
                          calc_metrics)

    def delta_energy(self, state: VerletSGLDState, grads, lr,
                     prev_potential, potential):
        "ΔE since the last initial_step (verlet_sgld.py:27-42); a 0-d tensor"
        if grads is None:
            grads = state.grads
        pe = self._point_energy(state, grads, lr)
        return (state.delta_energy_acc + pe
                + (potential - prev_potential) * self.num_data)

    def maybe_reject(self, state: VerletSGLDState, delta_energy, temperature,
                     flip_on_reject: bool = False):
        """M-H test; on rejection copy (position, momentum, grads) back from
        `state.saved` (verlet_sgld.py:49-70). `delta_energy` is read on the
        host (one sync). Returns (state, rejected, log_accept_prob).

        `flip_on_reject` negates the restored momentum on rejection, as
        GHMC-style detailed balance over persistent-momentum trajectories
        requires; the default restores it unflipped, like the reference."""
        assert state.saved is not None, "init(..., save_state=True) required"
        de = float(delta_energy)
        if temperature > 0.0:
            log_accept_prob = -de / temperature
        else:  # T=0 never rejects; the ratio is ±inf (or nan at ΔE=0)
            log_accept_prob = -math.copysign(math.inf, de) if de else math.nan
        u = float(torch.rand((), generator=state.gen, dtype=torch.float64))
        reject = temperature > 0.0 and (
            math.log(u) if u > 0 else -math.inf) > log_accept_prob
        if reject:
            saved_pos, saved_mom, saved_grads = state.saved
            state.position.copy_(saved_pos)
            state.momentum.copy_(-saved_mom if flip_on_reject else saved_mom)
            state.grads = saved_grads.clone()
        return state, reject, log_accept_prob
