"""HMC kernel: leapfrog integration with an exact M-H test (counterpart of
`bnn_priors_tpu/mcmc/hmc.py`).

VerletSGLD at momentum 1 and temperature 1 is leapfrog: every phase's
momentum decay is 1 and its noise scale 0, so each HMC transition is the
same fused update as a GGMC phase (`VerletSGLD._step`, one launch of the
CUDA kernel of the state's packing on the card) with σ = 0. Only the energy bookkeeping differs:
ΔE is the exact change of H = N·U + ½‖m‖² (`_point_energy` is the kinetic
energy of the current momentum), so `delta_energy_acc` is set once, at the
initial step, to −½‖m‖² before the kick, and `prev_nmd` stays 0. The
caller refreshes the momentum with `sample_momentum` between trajectories.
"""
from __future__ import annotations

import torch

from .segmented import vsum
from .verlet_sgld import VerletSGLD, VerletSGLDState


class HMC(VerletSGLD):
    def __init__(self, num_data: float, rmsprop_alpha: float = 0.99,
                 rmsprop_eps: float = 1e-8, packing: str = "flat"):
        super().__init__(num_data, momentum=1.0, rmsprop_alpha=rmsprop_alpha,
                         rmsprop_eps=rmsprop_eps, packing=packing)

    def _point_energy(self, state, grads, lr):
        "½‖m‖², the kinetic energy of the current momentum (hmc.py:23-25)"
        return 0.5 * vsum(state.momentum * state.momentum)

    def _step(self, state: VerletSGLDState, grads, lr, temperature, kind,
              save_state=False, calc_metrics=True):
        """a GGMC phase at momentum 1 (σ = 0: no noise, no decay), with
        the kinetic-energy bookkeeping of hmc.py:40-66"""
        # read before the kernel kicks the momentum in place
        acc = (-self._point_energy(state, grads, lr) if kind == "initial"
               else state.delta_energy_acc)
        # every phase's σ² is a multiple of 1 − a = 0: no noise at any T
        # (a chain form passes its (K,) temperatures through, as it must)
        state, metrics = super()._step(state, grads, lr, temperature, kind,
                                       save_state, calc_metrics)
        state.delta_energy_acc = acc
        state.prev_nmd = torch.zeros_like(state.prev_nmd)
        return state, metrics
