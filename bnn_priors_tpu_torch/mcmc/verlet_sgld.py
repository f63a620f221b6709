"""GGMC / VerletSGLD kernel: OBABO symmetric-splitting underdamped Langevin
with incremental energy accounting for an exact Metropolis–Hastings test
(counterpart of `bnn_priors_tpu/mcmc/verlet_sgld.py`; every packing of
`sgld.py`).

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

`VerletSGLDChains` runs K independent chains over a `(K, T)` bank (the
counterpart of `jax.vmap` over the JAX kernel, `parallel/multichain.py`):
every phase is one launch of the `(K, T)` fused kernel (of the segments
kernel for a segmented or hybrid state, whose segments are (K, ...)
blocks), temperatures are per chain, and each chain takes its own M-H
decision on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import fused_update
from .segmented import (SegVec, from_named_arrays, named_arrays, vapply,
                        vsum, vwhere)
from .sgld import (SGLD, VECTORS, SGLDState, _bases, load_vectors,
                   on_device)


SAVED = ("saved_position", "saved_momentum", "saved_grads")


def energy_and_rollback_arrays(state) -> Dict[str, torch.Tensor]:
    """the energy accumulators and, where the state keeps them, the
    rollback slots, by name (a checkpoint's entries)"""
    out = {"delta_energy_acc": state.delta_energy_acc,
           "prev_nmd": state.prev_nmd}
    if state.saved is not None:
        for k, v in zip(SAVED, state.saved):
            out.update(named_arrays(k, v))
    return out


def load_rollback(state, arrays: Dict[str, np.ndarray]) -> dict:
    """set `state.saved` from a checkpoint's arrays, in the form of the
    state's position; returns the others"""
    arrays = dict(arrays)
    if state.saved is not None:
        to_tensor = lambda v: on_device(v, state.position.device)
        state.saved = tuple(from_named_arrays(arrays, k, state.position,
                                              to_tensor) for k in SAVED)
    return arrays


def _scalar_arrays(state, arrays: dict, names) -> None:
    """set the 0-d or (K,) tensor fields that a checkpoint's arrays hold
    (popped); a JAX checkpoint carries no Philox keys"""
    for k in names:
        if k in arrays:
            setattr(state, k, on_device(arrays.pop(k), state.position.device))


@dataclass
class VerletSGLDState(SGLDState):
    delta_energy_acc: Optional[torch.Tensor] = None  # 0-d, param dtype
    prev_nmd: Optional[torch.Tensor] = None          # 0-d, param dtype
    saved: Optional[Tuple[torch.Tensor, ...]] = None  # (position, momentum, grads)

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        return {**super().state_arrays(), **energy_and_rollback_arrays(self)}

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        arrays = load_rollback(self, arrays)
        _scalar_arrays(self, arrays, ("delta_energy_acc", "prev_nmd"))
        super().load_state_arrays(arrays)


class VerletSGLD(SGLD):
    """GGMC kernel. `temperature`/`lr` are host floats; `momentum` fixed."""

    def init(self, params, seed: int = 0,
             save_state: bool = False) -> VerletSGLDState:
        vecs = self._init_vectors(params, seed)
        theta = vecs["position"]
        zero = torch.zeros((), dtype=theta.dtype, device=theta.device)
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
            noise_std = self._noise_std(1 - a ** 2, temperature)
        elif kind == "initial":
            mom_decay, grad_v = a ** 0.5, 1.0
            noise_std = self._noise_std(1 - a, temperature)
        elif kind == "final":
            mom_decay = grad_v = a ** 0.5
            noise_std = self._noise_std(1 - a, temperature)
        else:  # pragma: no cover
            raise ValueError(kind)
        return bh, bhn, mom_decay, grad_v, noise_std

    @staticmethod
    def _noise_std(c, temperature):
        "σ = sqrt(c·T) for a host-float temperature"
        return math.sqrt(c * temperature)

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
        partials = self._update(
            state.position, state.momentum, state.square_avg, grads,
            state.precond, seed, (mom_decay, grad_lr, noise_std, pos_c, alpha),
            total=self.packer.total)
        g_mold = c_gm * partials[..., 0]
        g_mnew = c_gm * partials[..., 1]
        pe_initial = (self.num_data * lr / 8.0) * partials[..., 2]
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


@dataclass
class VerletSGLDChainState:
    """K chains' GGMC state. The vectors are (K, T) banks, the energy
    accumulators (K,); all on one device, in the parameter dtype."""
    position: torch.Tensor
    momentum: torch.Tensor
    grads: torch.Tensor
    square_avg: torch.Tensor
    precond: torch.Tensor
    keys: torch.Tensor            # (K,) int64 on the device: Philox keys
    gens: List[torch.Generator]   # host, one a chain: M-H uniforms
    noise_gens: List[torch.Generator]  # state's device: momentum refresh
    delta_energy_acc: torch.Tensor
    prev_nmd: torch.Tensor
    saved: Optional[Tuple[torch.Tensor, ...]] = None
    n_updates: int = 0            # fused updates so far: the seeds' counter

    # -- checkpoints (io/checkpoint.py) --------------------------------------
    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """the tensors a checkpoint holds, by name (a SegVec field as its
        segments); the counter as a 0-d int64"""
        out = {}
        for k in VECTORS:
            out.update(named_arrays(k, getattr(self, k)))
        out["keys"] = self.keys
        out.update(energy_and_rollback_arrays(self))
        out["n_updates"] = torch.tensor(self.n_updates, dtype=torch.int64)
        return out

    def generators(self) -> Dict[str, torch.Generator]:
        "every chain's two generators, in chain order"
        out = {f"gens.{k}": g for k, g in enumerate(self.gens)}
        out.update({f"noise_gens.{k}": g
                    for k, g in enumerate(self.noise_gens)})
        return out

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        arrays = load_rollback(self, arrays)
        self.n_updates = int(arrays.pop("n_updates"))
        _scalar_arrays(self, arrays, ("keys", "delta_energy_acc", "prev_nmd"))
        load_vectors(self, arrays, VECTORS)


class VerletSGLDChains(VerletSGLD):
    """GGMC over K independent chains in one `(K, T)` bank: the counterpart
    of `jax.vmap` over `VerletSGLD` in the JAX chain runner.

    `temperature` is a (K,) tensor on the state's device (one temperature a
    chain); `lr` is a host float shared by all chains. Every phase is ONE
    launch of `fused_langevin_update_chains`. Chain k's noise for its n-th
    update is keyed by `keys[k] + n` (Philox keys in [0, 2**62), so chains'
    streams do not meet), added in the kernel (`seed_offset`): a step makes
    no host-to-device copy, no sync and no launch for its seeds. Each
    chain's noise_std vector is computed once per (phase, temperature
    vector) and kept, since a runner
    passes the same two temperature tensors (descent zeros, and the chains'
    own) for a whole run."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._noise_cache: Dict[tuple, tuple] = {}

    def init(self, params, seeds, save_state: bool = False
             ) -> VerletSGLDChainState:
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
        zero = torch.zeros(K, dtype=theta.dtype, device=theta.device)
        saved = ((theta.clone(), zeros.clone(), zeros.clone())
                 if save_state else None)
        return VerletSGLDChainState(
            position=theta, momentum=zeros, grads=zeros.clone(),
            square_avg=vapply(torch.ones_like, theta),
            precond=packer.expand(torch.ones(K, packer.n_leaves,
                                             dtype=theta.dtype,
                                             device=theta.device)),
            keys=keys, gens=gens, noise_gens=noise_gens,
            delta_energy_acc=zero, prev_nmd=zero.clone(), saved=saved)

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

    def maybe_reject(self, state: VerletSGLDChainState, delta_energy,
                     temperature, flip_on_reject: bool = False):
        """Each chain's M-H test on the device: a rejected chain gets its
        rows of (position, momentum, grads) back from `state.saved`, the
        others keep theirs (the vmapped rollback, multichain.py:1101-1109).
        delta_energy and temperature are (K,) tensors; a chain at T=0 never
        rejects. Returns (state, rejected (K,) bool, log_accept_prob (K,)),
        all on the device: no sync."""
        assert state.saved is not None, "init(..., save_state=True) required"
        dt, dev = delta_energy.dtype, delta_energy.device
        u = torch.stack([torch.rand((), generator=g, dtype=torch.float64)
                         for g in state.gens]).to(dev, dt)
        log_accept_prob = -delta_energy / temperature
        reject = (temperature > 0.0) & (torch.log(u) > log_accept_prob)
        saved_pos, saved_mom, saved_grads = state.saved
        if flip_on_reject:
            saved_mom = -saved_mom
        state.position.copy_(vwhere(reject, saved_pos, state.position))
        state.momentum.copy_(vwhere(reject, saved_mom, state.momentum))
        state.grads = vwhere(reject, saved_grads, state.grads)
        return state, reject, log_accept_prob
