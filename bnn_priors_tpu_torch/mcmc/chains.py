"""K independent chains in one `(K, T)` bank: the chain forms of the SGLD,
GGMC and HMC kernels (the counterpart of `jax.vmap` over one JAX kernel
class in `bnn_priors_tpu/parallel/multichain.py`).

`_ChainBank` holds what the chain axis changes, and each chain form is the
mixin over its single-chain kernel, whose step bodies it keeps:

* `init(params, seeds, save_state)`: a bank of K stacked parameter sets,
  with one seed a chain for its generators and its Philox key;
* the seeds: chain k's n-th update draws its noise with `keys[k] + n`,
  added in the kernel (`seed_offset`), so a step makes no host-to-device
  copy, no sync and no launch for its seeds;
* temperatures: a (K,) tensor on the state's device, and each chain's
  noise_std vector σ_k = sqrt(c·T_k) is computed once per (phase,
  temperature tensor) and kept, since a runner passes the same two
  temperature tensors (descent zeros, and the chains' own) for a whole run;
* the update: one launch of `fused_langevin_update_chains` over the bank
  (of `fused_langevin_update_segments_chains` for a segmented or hybrid
  bank, whose segments are (K, ...) blocks); float64 on the CPU takes the
  plain version directly;
* `sample_momentum`: each chain at its own temperature from its own
  device generator;
* `maybe_reject`: each chain's M-H test and rollback on the device.

`lr` is a host float shared by all chains. SGLD chains never pass an M-H
test (ΔE = ∞ a chain) and keep no rollback slots; HMC chains run at σ = 0
whatever the temperature, as the single-chain HMC does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import fused_update
from .hmc import HMC
from .segmented import SegVec, named_arrays, vapply, vwhere
from .sgld import SGLD, VECTORS, _bases, load_vectors
from .verlet_sgld import (VerletSGLD, _scalar_arrays,
                          energy_and_rollback_arrays, load_rollback)


@dataclass
class SGLDChainState:
    """K chains' SGLD state: the vectors are (K, T) banks (or SegVecs of
    (K, ...) segments), all on one device, in the parameter dtype."""
    position: torch.Tensor
    momentum: torch.Tensor
    grads: torch.Tensor
    square_avg: torch.Tensor
    precond: torch.Tensor
    keys: torch.Tensor            # (K,) int64 on the device: Philox keys
    gens: List[torch.Generator]   # host, one a chain: M-H uniforms
    noise_gens: List[torch.Generator]  # state's device: momentum refresh
    n_updates: int = 0            # fused updates so far: the seeds' counter

    # -- checkpoints (io/checkpoint.py) --------------------------------------
    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """the tensors a checkpoint holds, by name (a SegVec field as its
        segments); the counter as a 0-d int64"""
        out = {}
        for k in VECTORS:
            out.update(named_arrays(k, getattr(self, k)))
        out["keys"] = self.keys
        out["n_updates"] = torch.tensor(self.n_updates, dtype=torch.int64)
        return out

    def generators(self) -> Dict[str, torch.Generator]:
        "every chain's two generators, in chain order"
        out = {f"gens.{k}": g for k, g in enumerate(self.gens)}
        out.update({f"noise_gens.{k}": g
                    for k, g in enumerate(self.noise_gens)})
        return out

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        arrays = dict(arrays)
        self.n_updates = int(arrays.pop("n_updates"))
        _scalar_arrays(self, arrays, ("keys",))
        load_vectors(self, arrays, VECTORS)


@dataclass
class VerletSGLDChainState(SGLDChainState):
    """K chains' GGMC (or HMC) state: SGLD's, with the (K,) energy
    accumulators and, for an M-H test, the rollback slots"""
    delta_energy_acc: Optional[torch.Tensor] = None
    prev_nmd: Optional[torch.Tensor] = None
    saved: Optional[Tuple[torch.Tensor, ...]] = None

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        return {**super().state_arrays(), **energy_and_rollback_arrays(self)}

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        arrays = load_rollback(self, arrays)
        _scalar_arrays(self, arrays, ("delta_energy_acc", "prev_nmd"))
        super().load_state_arrays(arrays)


class _ChainBank:
    """What the chain axis changes in a kernel (see the module docstring);
    the chain forms put it before their single-chain kernel class."""

    state_class = VerletSGLDChainState

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._noise_cache: Dict[tuple, tuple] = {}

    def init(self, params, seeds, save_state: bool = False):
        """params: {name: (K, ...)} stacked per-chain parameters; seeds: K
        ints, one a chain (each chain's generators and Philox key)"""
        packer = self._ensure_packer({k: v[0] for k, v in params.items()})
        theta = packer.pack({k: v.detach() for k, v in params.items()})
        K = packer.lead_of(theta)[0]
        if len(seeds) != K:
            raise ValueError(f"{len(seeds)} seeds for {K} chains")
        gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
        draw = lambda g: int(torch.randint(0, 2 ** 62, (), generator=g))
        noise_gens = [torch.Generator(device=theta.device).manual_seed(draw(g))
                      for g in gens]
        keys = torch.tensor([draw(g) for g in gens], dtype=torch.int64,
                            device=theta.device)
        zeros = vapply(torch.zeros_like, theta)
        vecs = dict(
            position=theta, momentum=zeros, grads=zeros.clone(),
            square_avg=vapply(torch.ones_like, theta),
            precond=packer.expand(torch.ones(K, packer.n_leaves,
                                             dtype=theta.dtype,
                                             device=theta.device)),
            keys=keys, gens=gens, noise_gens=noise_gens)
        if self.state_class is SGLDChainState:
            assert not save_state, "SGLD keeps no rejection state"
            return SGLDChainState(**vecs)
        zero = torch.zeros(K, dtype=theta.dtype, device=theta.device)
        saved = ((theta.clone(), zeros.clone(), zeros.clone())
                 if save_state else None)
        return VerletSGLDChainState(**vecs, delta_energy_acc=zero,
                                    prev_nmd=zero.clone(), saved=saved)

    # -- per-chain randomness and temperatures ------------------------------
    @staticmethod
    def _seed(state) -> Tuple[torch.Tensor, int]:
        """this update's seeds as ((K,) keys on the device, host offset n):
        the kernel draws chain k's noise with seed keys[k] + n, so a step
        makes no launch for its seeds"""
        seeds = (state.keys, state.n_updates)
        state.n_updates += 1
        return seeds

    def _noise_std(self, c, temperature):
        "(K,) σ = sqrt(c·T_k), once per (phase, temperature tensor)"
        key = (c, id(temperature))
        hit = self._noise_cache.get(key)
        if hit is None or hit[0] is not temperature:
            hit = (temperature, torch.sqrt(c * temperature))
            self._noise_cache[key] = hit
        return hit[1]

    def _update(self, theta, momentum, square_avg, grads, precond, seeds,
                coeffs, *, total):
        """the (K, T) kernel (the segments kernel for a SegVec state), or
        its plain version for float64 on the CPU; returns the (K, 3)
        partials"""
        mom_decay, grad_lr, noise_std, pos_c, alpha = coeffs
        keys, offset = seeds
        plain = theta.dtype == torch.float64 and theta.device.type == "cpu"
        rest = (keys, noise_std.to(theta.dtype),
                (mom_decay, grad_lr, pos_c, alpha))
        if isinstance(theta, SegVec):
            table = self.packer.kernel_table(theta.lead, theta.device,
                                             fused_update.SEGMENT_CHUNK)
            fn = (fused_update.fused_langevin_update_segments_chains_reference
                  if plain else
                  fused_update.fused_langevin_update_segments_chains)
            *_, partials = fn(*_bases(theta, momentum, square_avg, grads,
                                      precond), *rest, table=table,
                              seed_offset=offset)
            return partials
        fn = (fused_update.fused_langevin_update_chains_reference if plain
              else fused_update.fused_langevin_update_chains)
        *_, partials = fn(theta, momentum, square_avg, grads, precond, *rest,
                          total=total, seed_offset=offset)
        return partials

    def sample_momentum(self, state, temperature):
        """m ← sqrt(T_k)·ξ, each chain at its own temperature from its own
        generator (`_sample_momentum_all`, multichain.py:957-969). Each
        chain draws its flat packing's normals, placed into the state's
        packing."""
        pk = self.packer
        dt, dev = state.position.dtype, state.position.device
        noise = torch.stack([torch.randn(pk.flat_padded, generator=g,
                                         dtype=dt, device=dev)
                             for g in state.noise_gens])
        state.momentum = pk.from_flat(
            pk.mask_pad(torch.sqrt(temperature)[:, None] * noise))
        return state

    def maybe_reject(self, state, delta_energy, temperature,
                     flip_on_reject: bool = False):
        """Each chain's M-H test on the device: a rejected chain gets its
        rows of (position, momentum, grads) back from `state.saved`, the
        others keep theirs (the vmapped rollback, multichain.py:1101-1109).
        delta_energy and temperature are (K,) tensors; a chain at T=0 never
        rejects. Returns (state, rejected (K,) bool, log_accept_prob (K,)),
        all on the device: no sync."""
        assert state.saved is not None, "init(..., save_state=True) required"
        dt, dev = delta_energy.dtype, delta_energy.device
        u = torch.stack([torch.rand((), generator=g, dtype=torch.float64)
                         for g in state.gens])
        if dev.type == "cuda":  # without blocking the host on the card
            u = u.pin_memory().to(dev, non_blocking=True)
        u = u.to(dev, dt)
        log_accept_prob = -delta_energy / temperature
        reject = (temperature > 0.0) & (torch.log(u) > log_accept_prob)
        saved_pos, saved_mom, saved_grads = state.saved
        if flip_on_reject:
            saved_mom = -saved_mom
        state.position.copy_(vwhere(reject, saved_pos, state.position))
        state.momentum.copy_(vwhere(reject, saved_mom, state.momentum))
        state.grads = vwhere(reject, saved_grads, state.grads)
        return state, reject, log_accept_prob


class SGLDChains(_ChainBank, SGLD):
    """SGLD over K chains: σ_k = sqrt(2(1−a)·T_k), so a chain at T = 0 (a
    descent epoch) takes no noise; no M-H test and no rollback slots."""

    state_class = SGLDChainState

    def delta_energy(self, state, grads, lr, prev_potential, potential):
        "SGLD never passes M-H (reference sgld.py:54-55): ∞ for every chain"
        return torch.full(state.keys.shape, float("inf"),
                          dtype=state.position.dtype,
                          device=state.position.device)


class VerletSGLDChains(_ChainBank, VerletSGLD):
    """GGMC over K chains; each chain takes its own M-H decision."""


class HMCChains(_ChainBank, HMC):
    """HMC over K chains: leapfrog at σ = 0 and momentum decay 1; ΔE and
    the kinetic energy ½‖m_k‖² are (K,) vectors."""
