"""Initial states of K independent chains, and the `(chains, data)` mesh
stepper (counterpart of `bnn_priors_tpu/parallel/chains.py`).

Every chain gets its own explicit generators: one for its initial
parameters and, through its chain seed, its own noise and M-H streams (the
`init` of a chain form of `mcmc/chains.py`: SGLD, GGMC or HMC). The chain
state is a `(K, T)` bank, so the K chains step together on one card; a
sub-bank of rows `rows=(lo, hi)` draws every chain's seeds as the whole
bank does and keeps its own, so its chains are the whole bank's.

`make_mesh` and `ChainMesh` are the JAX `shard_map` stepper over a
(`chains`, `data`) mesh: chains split over the `chains` axis, and within a
chain group the minibatch splits over the `data` axis, whose positions'
gradients are summed (`all_reduce` across ranks: the one device collective
the algorithm has). The JAX `vmap_chains` has no counterpart: the port's K
chains already step as one bank (`mcmc/chains.py`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..mcmc.segmented import SegVec, vapply, vclip
from .distributed import (DeviceMesh, _all_gather, global_positions,
                          is_multiprocess, rank)


def init_chains_from_fn(kernel, n_chains: int, params_fn, seed: int = 0,
                        init_kwargs=None,
                        rows: Optional[Tuple[int, int]] = None, device=None):
    """Stacked chain state with explicit per-chain initial parameters:
    `params_fn(chain_index, generator) -> params dict` (he-initialization,
    warm starts, ...), given a CPU generator of its own a chain; each chain
    also gets its own seed for its kernel streams. `seed` draws both, for
    all `n_chains` in order; `rows=(lo, hi)` builds chains lo..hi-1 only,
    on `device` (default: where `params_fn` puts them)."""
    lo, hi = rows or (0, n_chains)
    gen = torch.Generator().manual_seed(int(seed))
    draw = lambda: int(torch.randint(0, 2 ** 62, (), generator=gen))
    per_chain, chain_seeds = [], []
    for i in range(n_chains):
        param_seed, chain_seed = draw(), draw()
        if not lo <= i < hi:
            continue
        params = params_fn(i, torch.Generator().manual_seed(param_seed))
        per_chain.append({k: v.detach() for k, v in params.items()})
        chain_seeds.append(chain_seed)
    stacked = {k: torch.stack([p[k] for p in per_chain])
               for k in per_chain[0]}
    if device is not None:
        stacked = {k: v.to(device) for k, v in stacked.items()}
    return kernel.init(stacked, chain_seeds, **(init_kwargs or {}))


def init_chains_diverse(kernel, model, n_chains: int, seed: int = 0,
                        init_kwargs=None, rows=None, device=None):
    """an independent prior draw per chain (the ensemble workload's init);
    `model` itself is left as it is"""
    def params_fn(i, generator):
        return copy.deepcopy(model).init(generator).params()
    return init_chains_from_fn(kernel, n_chains, params_fn, seed, init_kwargs,
                               rows=rows, device=device)


def make_mesh(n_chain_shards: int, n_data_shards: int = 1,
              positions: Optional[Sequence] = None,
              device="cuda") -> DeviceMesh:
    """the (chains, data) mesh over the first n_chain_shards ×
    n_data_shards positions of `positions` ((rank, device) pairs; default:
    every rank's `local_devices(device)`), row-major"""
    positions = (list(positions) if positions is not None
                 else global_positions(device))
    n = n_chain_shards * n_data_shards
    if len(positions) < n:
        raise ValueError(f"need {n} devices, have {len(positions)}")
    return DeviceMesh(positions[:n], ("chains", "data"),
                      (n_chain_shards, n_data_shards))


def _rows_of(value, packer, lo, hi, device):
    """rows lo..hi-1 of a chain-state field on `device`, as copies: a
    vector's rows, a (K,) tensor's, each chain's generators as new ones in
    the same state"""
    if isinstance(value, SegVec) or (torch.is_tensor(value)
                                     and value.dim() > 1):
        return vapply(lambda t: t.to(device, copy=True),
                      packer.rows(value, lo, hi))
    if torch.is_tensor(value):
        return value[lo:hi].to(device, copy=True)
    if isinstance(value, tuple):
        return tuple(_rows_of(v, packer, lo, hi, device) for v in value)
    if isinstance(value, list):  # generators, one a chain
        out = []
        for g in value[lo:hi]:
            g2 = torch.Generator(device=device if g.device.type != "cpu"
                                 else "cpu")
            g2.set_state(g.get_state())
            out.append(g2)
        return out
    return value


class ChainMesh:
    """The (chains, data) mesh stepper (JAX `ChainMesh`, chains.py:86-171):
    chain group c (the `chains` index) holds rows c·K_c..(c+1)·K_c of the
    bank, and its minibatch splits over the `data` positions. Each position
    of this rank computes the gradient of its own part,

        −(Σ_local ll)·(N_eff/B_global)/N_eff − log_prior/(N_eff·d),

    whose sum over the `data` axis is the full minibatch's potential
    gradient: summed over this rank's positions of a group, then
    `all_reduce`d over the ranks that hold the group (on the process
    group's backend). Every holder of a group then takes the same kernel
    step on its own copy of the group's state (the state is replicated over
    `data`, as `P('chains')` is in JAX). A rank keeps one copy a group it
    holds, on the device of its first position of the group. Batchnorm
    buffers come back from the group's first local `data` position."""

    def __init__(self, mesh: DeviceMesh, kernel, model, eff_num_data: float,
                 grad_max: float = 1e6):
        if mesh.axis_names != ("chains", "data"):
            raise ValueError(f"ChainMesh takes a (chains, data) mesh, not "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.kernel = kernel
        self.model = model
        self.eff_num_data = float(eff_num_data)
        self.grad_max = grad_max
        self.n_chain_shards, self.n_data_shards = mesh.shape
        me = rank()
        # {chain group: [(data index, device)]} of this rank's positions
        self.local: Dict[int, list] = {}
        for i, (r, dev) in enumerate(mesh.positions):
            if r == me:
                c, d = divmod(i, self.n_data_shards)
                self.local.setdefault(c, []).append((d, dev))
        # a process group a chain group whose positions span ranks (every
        # rank makes every group, in order, as torch.distributed requires)
        self.groups = {}
        if is_multiprocess():
            for c in range(self.n_chain_shards):
                ranks = sorted({r for r, _ in mesh.positions[
                    c * self.n_data_shards:(c + 1) * self.n_data_shards]})
                if len(ranks) > 1:
                    group = dist.new_group(ranks)
                    if me in ranks:
                        self.groups[c] = group

    def _rows(self, n, c):
        per = n // self.n_chain_shards
        return c * per, (c + 1) * per

    def place_chains(self, state):
        """{chain group: its rows of the stacked chain state} for the groups
        this rank holds, on the device of its first position of each"""
        K = state.keys.shape[0]
        if K % self.n_chain_shards:
            raise ValueError(f"{K} chains do not split over "
                             f"{self.n_chain_shards} chain groups")
        out = {}
        for c, pos in self.local.items():
            lo, hi = self._rows(K, c)
            fields = {f.name: _rows_of(getattr(state, f.name),
                                       self.kernel.packer, lo, hi, pos[0][1])
                      for f in dataclasses.fields(state)}
            out[c] = type(state)(**fields)
        return out

    def place_batch(self, x):
        """{(chain group, data index): its part} of a (K, B, ...) batch:
        the group's rows, and the data position's slice of the batch"""
        K, B = x.shape[0], x.shape[1]
        if B % self.n_data_shards:
            raise ValueError(f"a batch of {B} does not split over "
                             f"{self.n_data_shards} data positions")
        per = B // self.n_data_shards
        return {(c, d): x[slice(*self._rows(K, c)),
                          d * per:(d + 1) * per].to(dev)
                for c, pos in self.local.items() for d, dev in pos}

    def _local_grad(self, state, buffers, xb, yb, device):
        """this data position's part of the minibatch potential and its
        gradient (and accuracy), on the state's device"""
        pk = self.kernel.packer
        position = vapply(lambda t: t.to(device), state.position)
        B_global = xb.shape[1] * self.n_data_shards
        theta, params = pk.differentiable(position)
        ll, f = self.model.log_likelihood(params, xb, yb, 1.0, train=True,
                                          buffers=buffers)
        lp = self.model.log_prior(params)
        pot = -(ll * (xb.shape[1] / B_global)
                + lp / (self.eff_num_data * self.n_data_shards))
        g, = torch.autograd.grad(pot.sum(), theta)
        acc = self.model.acc_fn(f, yb).sum(-1) / B_global
        home = state.position.device
        return torch.cat([g.reshape(-1), pot.detach(), acc.to(g.dtype)]).to(
            home)

    def make_step(self, lr_fn):
        """`step(states, buffers, step_idx, xb, yb, temperature) ->
        (states, buffers, metrics)` for this rank's chain groups:
        `states` from `place_chains`, `buffers` {group: {name: (K_c, ...)}}
        on its state's device ({} for a model without any), `xb`/`yb` from
        `place_batch`, `temperature` a float or a (K,) tensor.
        `metrics` holds {group: (K_c,)} potentials and accuracies and
        `mean_potential`, the mean over all K chains (a float, the same on
        every rank)."""
        kernel, pk = self.kernel, self.kernel.packer

        def step(states, buffers, step_idx, xb, yb, temperature):
            pots, accs = {}, {}
            new_states, new_buffers = {}, {}
            for c, pos in self.local.items():
                st, home = states[c], states[c].position.device
                total, first = None, None
                for d, dev in pos:
                    bufs = {k: v.to(dev).clone()
                            for k, v in buffers.get(c, {}).items()}
                    part = self._local_grad(st, bufs, xb[c, d], yb[c, d], dev)
                    total = part if total is None else total + part
                    first = bufs if first is None else first
                if c in self.groups:
                    dist.all_reduce(total, group=self.groups[c])
                n = st.keys.shape[0]
                g = total[:-2 * n]
                g = pk.wrap_grad(g if isinstance(st.position, SegVec)
                                 else g.view_as(st.position), st.position)
                pot, acc = total[-2 * n:-n], total[-n:]
                g = vclip(g, -self.grad_max, self.grad_max)
                temps = torch.as_tensor(temperature, dtype=pot.dtype)
                if temps.dim():
                    temps = temps[slice(*self._rows(
                        n * self.n_chain_shards, c))]
                temps = temps.expand(n).to(home).contiguous()
                new_states[c], _ = kernel.step(st, g, lr_fn(step_idx), temps,
                                               calc_metrics=False)
                new_buffers[c] = {k: v.to(home) for k, v in first.items()}
                pots[c], accs[c] = pot, acc
            # each group's potentials counted once: by its first position
            owned = [pots[c] for c in pots
                     if self.mesh.positions[c * self.n_data_shards][0]
                     == rank()]
            sums = _all_gather((float(sum(p.sum() for p in owned)),
                                sum(p.numel() for p in owned)))
            mean = sum(s for s, _ in sums) / sum(n for _, n in sums)
            return new_states, new_buffers, {"potential": pots, "acc": accs,
                                             "mean_potential": mean}
        return step
