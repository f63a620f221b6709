"""The chain axis across processes (counterpart of
`bnn_priors_tpu/parallel/distributed.py`), on `torch.distributed`.

* `initialize(coordinator_address, num_processes, process_id)` starts the
  process group over a TCP store at `coordinator_address` (host:port of
  rank 0); a no-op for `num_processes` None or 1, so the same program runs
  in one process. The group's backend is `gloo` unless the caller names
  another (`nccl` for device collectives across cards); host values always
  travel over `gloo`, on a group of their own when the default is not.
* `DeviceMesh` is the port's mesh: an ordered list of positions, each a
  (rank, local `torch.device`), over one or two named axes.
  `global_chains_mesh` lists every rank's `local_devices` in rank order,
  as `jax.devices()` lists the global devices once `jax.distributed` is up.
* Chains split evenly over the `chains` positions in order; a rank holds
  the chains of its own positions, each position a `(K_d, T)` sub-bank on
  its device (`local_chain_indices_for_mesh`, `put_chains`). Chains never
  talk to each other, so the only traffic is small host values:
  diagnostics, M-H records and checkpoints, gathered so that every rank
  holds all K (`host_value`), and no sample traffic at all: every rank
  streams its own chains' banks (`local_chain_rows`).

Recipe, as in the JAX package: one card, no mesh; one host, a mesh over
its cards (`n_devices`); N processes, `initialize(...)` in each, then the
same mesh code over the global positions, the same program everywhere.
Two ranks may share one card (positions on `cuda:0` in both): that is how
the two-process path runs on a one-card machine, over `gloo`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import local_devices

__all__ = ("initialize", "is_multiprocess", "rank", "DeviceMesh",
           "global_positions", "global_chains_mesh",
           "local_chain_indices_for_mesh", "put_chains", "host_value",
           "local_chain_rows", "DISTRIBUTED_DEFAULTS",
           "add_distributed_config", "initialize_from_config")

# the host values' group when the default backend is not gloo
_host_group = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> bool:
    """`torch.distributed.init_process_group` over `tcp://<coordinator_
    address>`. No-op (returns False) when num_processes is None or 1, and
    (returns True) when this process is already in that group, so a
    process runs several CLIs in one group. Runs before the first mesh is
    made."""
    global _host_group
    if not num_processes or int(num_processes) <= 1:
        return False
    if not coordinator_address or process_id is None:
        raise ValueError("multi-process runs need coordinator_address and "
                         "process_id")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (int(num_processes),
                                                        int(process_id)):
            raise ValueError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {process_id} of "
                f"{num_processes}")
        return True
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    _host_group = None if backend == "gloo" else dist.new_group(
        backend="gloo")
    return True


# the sacred-style CLI keys shared by train_bnn and sweep_tempering
DISTRIBUTED_DEFAULTS = dict(
    coordinator_address=None,  # host:port of process 0
    num_processes=None,        # total process count (None/1 = local run)
    process_id=None,           # this process's rank
)


def add_distributed_config(defaults: dict) -> dict:
    defaults.update(DISTRIBUTED_DEFAULTS)
    return defaults


def initialize_from_config(cfg: dict) -> bool:
    return initialize(cfg.get("coordinator_address"),
                      cfg.get("num_processes"), cfg.get("process_id"))


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _all_gather(value) -> list:
    "every rank's `value`, in rank order (one rank: [value])"
    if not is_multiprocess():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value, group=_host_group)
    return out


class DeviceMesh:
    """Positions (rank, device) laid out row-major over named axes: a
    `("chains",)` line, or the `("chains", "data")` grid of `ChainMesh`."""

    def __init__(self, positions: Sequence[Tuple[int, torch.device]],
                 axis_names=("chains",), shape=None):
        self.positions = tuple((int(r), torch.device(d))
                               for r, d in positions)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape or (len(self.positions),))
        if int(np.prod(self.shape)) != len(self.positions):
            raise ValueError(f"{len(self.positions)} positions do not fill "
                             f"a {self.shape} mesh")

    @property
    def size(self) -> int:
        return len(self.positions)

    @property
    def devices(self) -> List[torch.device]:
        return [d for _, d in self.positions]

    def local(self) -> List[Tuple[int, torch.device]]:
        "(index, device) of this rank's positions, in order"
        me = rank()
        return [(i, d) for i, (r, d) in enumerate(self.positions) if r == me]

    def chain_ranges(self, n_chains: int) -> List[Tuple[int, int]]:
        """(first, stop) chains of each position of a one-axis mesh: an
        even split in order"""
        if n_chains % self.size:
            raise ValueError(f"{n_chains} chains do not split evenly over "
                             f"{self.size} mesh positions")
        per = n_chains // self.size
        return [(i * per, (i + 1) * per) for i in range(self.size)]

    def __repr__(self):
        return (f"DeviceMesh({dict(zip(self.axis_names, self.shape))}, "
                f"{[(r, str(d)) for r, d in self.positions]})")


def global_positions(device="cuda") -> List[Tuple[int, torch.device]]:
    "every rank's `local_devices(device)`, in rank order"
    per_rank = _all_gather([str(d) for d in local_devices(device)])
    return [(r, torch.device(d)) for r, devs in enumerate(per_rank)
            for d in devs]


def global_chains_mesh(n_devices: Optional[int] = None, device="cuda",
                       axis="chains") -> DeviceMesh:
    """one-axis mesh (`chains`; eval's `samples`) over the first
    `n_devices` global positions (None: all). Asking for more than there
    are raises, naming both counts."""
    positions = global_positions(device)
    n = int(n_devices or len(positions))
    if n > len(positions):
        kind = torch.device(device).type
        raise ValueError(f"n_devices={n} but only {len(positions)} "
                         f"device(s) are available ({kind}): refusing to "
                         "run on fewer")
    return DeviceMesh(positions[:n], (axis,))


def local_chain_indices_for_mesh(mesh: DeviceMesh, n_chains: int
                                 ) -> List[int]:
    """the chains this rank holds under `mesh`, so that a caller makes run
    dirs and savers for its own chains only, before the runner exists"""
    ranges = mesh.chain_ranges(n_chains)
    return [c for i, _ in mesh.local() for c in range(*ranges[i])]


def put_chains(tree: Dict[str, Any], mesh: DeviceMesh
               ) -> List[Dict[str, Any]]:
    """a (K, ...) tree that every rank holds whole, as this rank's
    positions' rows: a tensor's on the position's device, a numpy array's
    on the host (a checkpoint's, which the chain state loads onto its
    device); a 0-d leaf (a shared counter) goes whole to every position"""
    ranges = mesh.chain_ranges(next(
        (v.shape[0] for v in tree.values() if v.ndim), 0))

    def rows(v, r, d):
        v = v if v.ndim == 0 else v[slice(*r)]
        return v.to(d) if torch.is_tensor(v) else v
    return [{k: rows(v, ranges[i], d) for k, v in tree.items()}
            for i, d in mesh.local()]


def host_value(parts: Dict[int, Any], mesh: Optional[DeviceMesh] = None
               ) -> Dict[int, Any]:
    """{first chain: host payload} of this rank's positions -> the same of
    every position on every rank (a gather over gloo; no collective in one
    process). Payloads are small host values: numpy arrays, numbers."""
    if mesh is None or not is_multiprocess():
        return dict(parts)
    out: Dict[int, Any] = {}
    for p in _all_gather(dict(parts)):
        out.update(p)
    return out


def local_chain_rows(parts: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """{chain index: row} from {first chain: (K_d, ...) rows} of this
    rank's positions: what a rank-aware writer saves"""
    return {lo + j: a[j] for lo, a in parts.items() for j in range(len(a))}
