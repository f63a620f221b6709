"""K independent chains (counterpart of
`bnn_priors_tpu/parallel/multichain.py`): `MultiChainRunner`, the plain
loop of SGLD, GGMC (VerletSGLD) or HMC (OurHMC) chains, and
`MultiChainRunnerReject`, the same chains with exact full-data gradients
and an M-H test at every sampling boundary.

The K chains step together: their state is one `(K, T)` bank (a chain
form of `mcmc/chains.py`: `SGLDChains`, `VerletSGLDChains`, `HMCChains`),
every minibatch step is one forward/backward of all K networks folded into
channel groups (`models/layers.py`) on one minibatch a chain, and one
launch of the `(K, T)` fused kernel updates them all. Temperatures are per
chain (0 in descent epochs). The plain runner draws a fresh minibatch
order a chain each epoch; the reject runner keeps each chain's order fixed
within a cycle, and each chain takes its own M-H decision at every
sampling boundary, rolled back on the device.

The mesh (`mesh=`, a `distributed.DeviceMesh` of `chains` positions, the
JAX runner's `NamedSharding(P('chains'))`): the K chains split evenly over
the positions in order, and each position of this process holds its own
`(K_d, T)` sub-bank (`_Bank`), batchnorm buffers and data on its device,
so every phase is one launch a local position. Launches are asynchronous,
so several cards in one process overlap. Every chain-level random draw
still comes from the runner's one host generator in chain order (a rank
that holds K/2 chains draws for all K and keeps its rows), and the kernel
draws chain k's noise from chain k's own seed, so a chain's trajectory is
the one-bank run's whatever the mesh. Across processes (`torch.
distributed`, see `distributed.py`) a rank touches only its own chains'
savers (`local_chains`, `local_chain_rows`; the others may be None), shared diagnostics (the
potentials, ΔE, the decisions) are gathered so that every rank holds all
K, `save_checkpoint` gathers every chain into rank 0's one file, and
`restore_checkpoint` reads the file on every rank and keeps its rows
(`put_chains`). A runner without a mesh has one position, this process's
whole bank.

`chain_group_size` splits each sub-bank into dispatch groups of that many
chains (it must divide the sub-bank; 0 or None: one group). The groups'
forward and backward passes, minibatch and exact, run one after another,
each over its rows of the bank; every update stays one launch over the
sub-bank, so trajectories equal the ungrouped ones. The JAX package's
automatic choice (`MEASURED_GROUP_RATES`, `CHAIN_GROUP_TARGET`) rests on
TPU measurements and is not carried over: None is one group until the
card's own curve sets a rule (ROADMAP item 9).

The test pass runs every `eval_skip` epochs and after the last (0 or None:
never), `_eval_due` of multichain.py:638-642.

The pipelined epoch (`pipeline=True`, the default, multichain.py:
538-624). The loop dispatches an epoch's device work (its minibatch steps,
the test pass, the epoch end's boundary and preconditioner) and stages
everything the epoch's host work reads (the minibatch potentials and
diagnostics, the test metrics, ΔE and the decisions, the sample) into
host copies on the current stream: the update writes the bank in place,
so the host work must not read the live state. A CUDA event marks the end
of those copies. The host work (the NaN check, the metric rows, the
boundary row, the sample writes, the timings) is the epoch's drain: with
the pipeline it runs on a drain thread after the next epoch's device work
is dispatched, through a queue at most 2 deep; the thread waits on the
event and launches no device work of its own. Drains are flushed before
every checkpoint, the thread is stopped before `run()` returns or raises,
and an error in it is raised again on the calling thread. `pipeline=False`
drains each epoch on the calling thread at once. A multi-process run
drains on the calling thread, one epoch late as with the pipeline: its
gathers are collectives, whose order must match across ranks
(multichain.py:584-596). Either way the drain's results are the same; with
the pipeline `timings/wall_s` (dispatch to dispatch) is streamed beside
`timings/epoch_s` (dispatch to the drain's host copies).

Host reads: once an epoch (the minibatch potentials, the last step's
diagnostics and the test metrics; with metrics savers also the logged
steps' per-leaf diagnostics and the preconditioner) and once a boundary
(ΔE, the decisions and the exact-pass metrics), in the drain. With
`metrics_savers` (one `HDF5Metrics`-like saver a chain) every chain
streams the JAX package's step-granular series at its indices; with
`model_savers` every chain's samples stream to its own saver (a
quarantined NaN chain writes none). `augment_fn(x, generators)` augments
every minibatch step, each chain from its own device generator re-seeded
with its augmentation seed plus the step.

`run(checkpoint_path=, checkpoint_every=, resume_from=)` writes and
resumes full checkpoints of all K chains in one file (`io/checkpoint.py`:
the (K, T) bank, the (K, ...) batchnorm buffers, every generator and the
loop's M-H records); in-memory samples are not in it, as in the JAX package
(multichain.py:429-462): stream them to `model_savers`.

`packing` ("flat", the default; "segmented"; "hybrid") chooses the bank's
layout (`mcmc/segmented.py`): a segmented or hybrid bank holds every
segment as a contiguous (K, ...) block of one buffer and updates through
the segments kernel, one launch a phase as the flat bank does.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

from .. import mcmc
from ..device import resolve_device
from ..precision import matmul_precision
from ..inference.reject import exact_potential_and_grad
from ..inference.runner import progress, resume_point
from ..inference.schedules import make_schedule
from ..io.checkpoint import load_chain_checkpoint, save_chain_checkpoint
from ..mcmc.segmented import vapply, vclip, vsum
from ..mcmc.sgld import on_device
from .chains import init_chains_diverse, init_chains_from_fn
from .distributed import (DeviceMesh, host_value, is_multiprocess,
                          local_chain_rows, put_chains, rank)


KERNELS = {"SGLD": mcmc.SGLDChains, "VerletSGLD": mcmc.VerletSGLDChains,
           "HMC": mcmc.HMCChains}

# the epoch record's diagnostics that come one row a logged step (the
# others, one value a chain)
STEP_KEYS = ("potential", "acc", "loss", "log_prior", "est_temperature",
             "est_config_temp")


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """a host copy of `t` that later in-place writes to `t` do not reach:
    on the card a non-blocking copy into pinned memory, enqueued on the
    current stream (valid once the stream passes it); on the CPU a clone"""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    return t.to("cpu", non_blocking=True)


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """a host tensor on `device`; to the card through pinned memory without
    blocking the host, so the dispatch runs ahead of the card"""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _stage(tensors: Dict[str, torch.Tensor], dtype) -> tuple:
    """{key: device tensor} as one host copy in `dtype` (one transfer) and
    its layout"""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors.values()])
    return _host_copy(flat), [(k, tuple(t.shape)) for k, t in tensors.items()]


def _unstage(staged) -> Dict[str, np.ndarray]:
    "`_stage`'s host copy as {key: numpy array}"
    flat, layout = staged
    flat, out, at = flat.numpy(), {}, 0
    for k, shape in layout:
        n = int(np.prod(shape))
        out[k] = flat[at:at + n].reshape(shape)
        at += n
    return out


class _Bank:
    """one mesh position's sub-bank: chains lo..hi-1 on `device`, with its
    own chain state, batchnorm buffers, data, temperatures and (per
    device) model and kernel"""

    def __init__(self, lo, hi, device, model, kernel, data):
        self.lo, self.hi, self.n = lo, hi, hi - lo
        self.device, self.model, self.kernel = device, model, kernel
        self.train_x, self.train_y, self.test_x, self.test_y = data
        self.chains = None
        self.buffers: Dict[str, torch.Tensor] = {}
        self.temps = None          # (descent zeros, the chains' own), (n,)
        self.aug_gens: List[torch.Generator] = []
        self.initial_pots = None   # the reject runner's base potentials


class MultiChainRunner:
    """Cyclical SG-MCMC over K chains in one bank (descent/warmup/sampling
    phases, cosine cycles) with the `kernel` "SGLD", "VerletSGLD" (the
    default) or "HMC": every minibatch step is the kernel's mid step, the
    preconditioner is updated after every epoch with `epoch %
    precond_update == 0`, each sampling epoch stores a sample, and with the
    HMC kernel (`inference=OurHMC`) every chain's momentum is refreshed at
    the start and after every sampling epoch (multichain.py:464-535). HMC
    takes temperature 1 for every chain and no descent epochs; its
    `momentum` is 1 whatever is passed. `MultiChainRunnerReject` adds the
    M-H boundaries.

    `init_params_fn(chain_index, generator) -> params` sets each chain's
    initial parameters (he-initialization, warm starts); by default every
    chain is an independent draw from the model's priors. The chains'
    batchnorm state starts as K copies of the model's buffers. The
    parameter dtype is the model's; `compute_dtype` (e.g. torch.bfloat16)
    runs the minibatch steps' network in reduced precision, while the exact
    boundary passes stay in the parameter dtype; the test-set evaluation
    runs the network in the parameter dtype, on bf16 operands when
    `compute_dtype` is bf16 (`_evaluate`). The chain axis takes no
    `matmul_precision`, as in the JAX CLI.

    `mesh` splits the chains over its positions (see the module docstring);
    `chains`, `buffers` and `bank` are the one sub-bank of a runner
    without a mesh, `banks` this process's sub-banks."""

    reject_samples = False  # rollback slots for an M-H test: none here

    def __init__(self, model, train_data, n_chains, temperatures=1.0,
                 kernel="VerletSGLD", learning_rate=1e-2, momentum=0.994,
                 sampling_decay="cosine",
                 batch_size=128, cycles=1, epochs_per_cycle=1,
                 warmup_epochs=0, sample_epochs=1, skip=1, grad_max=1e6,
                 precond_update=None, data_mult=1.0, seed: int = 0,
                 init_params_fn=None, compute_dtype=None, test_data=None,
                 eval_batch_size=None, chain_group_size=None,
                 augment_fn=None, model_savers=None, metrics_savers=None,
                 metrics_skip=1, eval_skip=1, device="cuda", packing="flat",
                 mesh=None, pipeline=True):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        dtype = next(self.model.parameters()).dtype
        self.train_x, self.train_y = (t.to(self.device) for t in train_data)
        self.n_chains = K = int(n_chains)
        self.N = int(self.train_x.shape[0])
        self.eff_num_data = self.N * data_mult
        self.batch_size = int(batch_size)
        self.n_full = self.N // self.batch_size
        if self.n_full == 0:
            raise ValueError(f"{self.N} points make no batch of "
                             f"{self.batch_size}")
        assert warmup_epochs >= 0 and sample_epochs >= 0
        assert epochs_per_cycle >= warmup_epochs + sample_epochs
        self.grad_max = grad_max
        self.cycles = cycles
        self.epochs_per_cycle = epochs_per_cycle
        self.descent_epochs = epochs_per_cycle - warmup_epochs - sample_epochs
        self.warmup_epochs = warmup_epochs
        self.sample_epochs = sample_epochs
        self.skip = skip
        self.precond_update = precond_update
        self.learning_rate = learning_rate
        self.compute_dtype = compute_dtype
        self.pipeline = bool(pipeline)
        # an epoch is n_full minibatch steps: no ragged tail (as JAX's scan)
        self.schedule = make_schedule(
            sampling_decay, self.n_full * epochs_per_cycle,
            steps_per_stair=150 * self.n_full)

        self.temperatures = torch.as_tensor(
            temperatures, dtype=dtype).expand(K).contiguous()
        self._temps_np = self.temperatures.numpy().astype(np.float64)
        self.temperatures = self.temperatures.to(self.device)
        self.packing = packing
        self.kernel_name = kernel
        if kernel == "HMC":
            # OurHMC (multichain.py:120-129): T=1, momentum 1, no descent
            assert bool((self.temperatures == 1.0).all()), \
                "HMC kernel requires temperature=1 for every chain"
            assert self.descent_epochs == 0, \
                "HMC not implemented for descent (T=0) epochs"
        if test_data is not None:
            self.test_x, self.test_y = (t.to(self.device) for t in test_data)
            self.eval_batch_size = int(eval_batch_size or batch_size)
        else:
            self.test_x = self.test_y = None

        # without a mesh, one position: this process's whole bank
        self.mesh = mesh or DeviceMesh([(rank(), self.device)])
        self._multiprocess = mesh is not None and is_multiprocess()
        self.banks = self._make_banks(kernel, momentum,
                                      self._mesh_spans(self.mesh, K))
        self.kernel = self.banks[0].kernel
        self.local_chains = [c for b in self.banks
                             for c in range(b.lo, b.hi)]
        self.chain_group_size = int(chain_group_size or 0)
        if self.chain_group_size and self.banks[0].n % self.chain_group_size:
            raise ValueError(f"chain_group_size={chain_group_size} does not "
                             f"divide the {self.banks[0].n} chains of a "
                             "(sub-)bank")

        # host generator: chain seeds and data orders (explicit, never global)
        self.gen = torch.Generator().manual_seed(int(seed))
        init_seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen))
        for b in self.banks:
            # with rollback slots: every chain takes an M-H test
            init = {"save_state": self.reject_samples}
            if init_params_fn is not None:
                b.chains = init_chains_from_fn(
                    b.kernel, K, init_params_fn, init_seed, init, rows=(
                        b.lo, b.hi), device=b.device)
            else:
                b.chains = init_chains_diverse(
                    b.kernel, b.model, K, init_seed, init, rows=(b.lo, b.hi),
                    device=b.device)
            # each chain's own batchnorm state (multichain.py:153-156), new
            # memory even for one chain (an expand of 1 is a view)
            b.buffers = {k: v.detach().repeat(b.n, *[1] * v.dim()).to(b.device)
                         for k, v in self.model.named_buffers()}
            # the two per-chain temperature vectors of a run (descent,
            # sampling), made once: the kernel keys its noise_std cache on
            # them
            own = self.temperatures[b.lo:b.hi].to(b.device)
            b.temps = (torch.zeros_like(own), own)
        self.eval_skip = int(eval_skip or 0)
        self.nan_chains: set = set()
        self._samples: List[tuple] = []
        self.potentials: List[np.ndarray] = []
        self.augment_fn = augment_fn
        if augment_fn is not None:
            self._aug_seeds = [int(torch.randint(0, 2 ** 62, (),
                                                 generator=self.gen))
                               for _ in range(K)]
            for b in self.banks:
                b.aug_gens = [torch.Generator(device=b.device)
                              for _ in range(b.n)]
        for savers in (model_savers, metrics_savers):
            assert savers is None or len(savers) == K, "one saver a chain"
        self.model_savers = model_savers
        self.metrics_savers = metrics_savers
        self.metrics_skip = int(metrics_skip)
        self._np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self._drain_thread = None
        self._drain_errors: list = []

    # -- the sub-banks ---------------------------------------------------------
    @staticmethod
    def _mesh_spans(mesh, K):
        "(first, stop, device) of this process's positions' chains"
        if mesh.axis_names != ("chains",):
            raise ValueError(f"the runners take a ('chains',) mesh, not "
                             f"{mesh.axis_names}")
        ranges = mesh.chain_ranges(K)
        spans = [(*ranges[i], d) for i, d in mesh.local()]
        if not spans:
            raise ValueError(f"this process holds no position of {mesh}")
        return spans

    def _make_banks(self, kernel, momentum, spans):
        """a `_Bank` a span, sharing one model, kernel (its packer holds
        device tensors) and copy of the data a device"""
        here = next(self.model.parameters()).device
        per_device = {}
        banks = []
        for lo, hi, dev in spans:
            dev = torch.device(dev)
            if dev.type != self.device.type:
                raise ValueError(f"mesh position on {dev}, the runner's "
                                 f"device is {self.device}")
            if dev not in per_device:
                on = lambda t: None if t is None else t.to(dev)
                per_device[dev] = (
                    self.model if dev == here
                    else copy.deepcopy(self.model).to(dev),
                    KERNELS[kernel](
                        num_data=self.eff_num_data, packing=self.packing,
                        **({} if kernel == "HMC" else {"momentum": momentum})),
                    tuple(on(t) for t in (self.train_x, self.train_y,
                                          self.test_x, self.test_y)))
            banks.append(_Bank(lo, hi, dev, *per_device[dev]))
        return banks

    @property
    def bank(self) -> _Bank:
        "the runner's one sub-bank (a runner without a mesh has one)"
        if len(self.banks) != 1:
            raise AttributeError(f"this runner holds {len(self.banks)} "
                                 "sub-banks: see `banks`")
        return self.banks[0]

    @property
    def chains(self):
        return self.bank.chains

    @chains.setter
    def chains(self, value):
        self.bank.chains = value

    @property
    def buffers(self) -> Dict[str, torch.Tensor]:
        return self.bank.buffers

    def _host_value(self, parts: Dict[int, Any]) -> Dict[int, Any]:
        """{first chain: host payload} of this process's sub-banks -> the
        same of every sub-bank (gathered over the ranks of a mesh)"""
        return host_value(parts, self.mesh) if self._multiprocess else parts

    def _gathered(self, parts: Dict[int, np.ndarray]) -> np.ndarray:
        """{first chain: (K_d, ...) rows} of this process's sub-banks -> the
        (K, ...) rows of every chain, in order (gathered over the ranks)"""
        parts = self._host_value(parts)
        return np.concatenate([parts[lo] for lo in sorted(parts)])

    def _temps_for(self, epoch, b=None):
        "(K_d,) temperatures for the epoch (0 during descent epochs)"
        return (b or self.bank).temps[int(epoch >= self.descent_epochs)]

    def _is_sampling_epoch(self, epoch):
        epoch = epoch % self.epochs_per_cycle
        se = epoch - (self.descent_epochs + self.warmup_epochs)
        return (0 <= se) and (se % self.skip == 0)

    def _eval_due(self, e):
        "the test pass after epoch e (multichain.py:638-642)"
        if self.test_x is None or self.eval_skip <= 0:
            return False
        return ((e + 1) % self.eval_skip == 0
                or e == self.cycles * self.epochs_per_cycle - 1)

    def _epoch_idxs(self, cycle=0, epoch=0):
        """(n_chains, n_full, B) minibatch indices: a fresh permutation a
        chain each epoch, from the runner's host generator
        (multichain.py:409-422)"""
        n = self.n_full * self.batch_size
        perms = [torch.randperm(self.N, generator=self.gen)[:n]
                 for _ in range(self.n_chains)]
        return _to_device(torch.stack(perms).view(
            self.n_chains, self.n_full, self.batch_size), self.device)

    # -- dispatch groups -----------------------------------------------------
    def _groups(self, b=None):
        """(start, stop) rows of each dispatch group of sub-bank b (default:
        the one bank), in order"""
        b = b or self.bank
        Kg = self.chain_group_size or b.n
        return [(s, s + Kg) for s in range(0, b.n, Kg)]

    def _grouped(self, fn, b):
        """`fn(rows of the bank's position, rows of the buffers, start,
        stop)` for each dispatch group, in order; returns each group's
        result (one group: the bank itself, no copy)"""
        groups, position = self._groups(b), b.chains.position
        if len(groups) == 1:
            return [fn(position, b.buffers, 0, b.n)]
        pk = b.kernel.packer
        return [fn(pk.rows(position, s, e),
                   {k: v[s:e] for k, v in b.buffers.items()}, s, e)
                for s, e in groups]

    @staticmethod
    def _join(parts, b):
        """the groups' tuples of (K_g, ...) tensors, ending with a packed
        gradient, as one tuple over the sub-bank"""
        if len(parts) == 1:
            return parts[0]
        *vals, grads = zip(*parts)
        return (*(torch.cat(v) for v in vals),
                b.kernel.packer.cat_rows(grads))

    # -- one minibatch step of all chains ------------------------------------
    def _chain_step(self, idx, step, temperatures, last=False, b=None):
        """every chain's transition on its own minibatch (idx (K_d, B)) in
        sub-bank `b` (default: the one bank). With metrics savers every
        step returns the per-leaf (K_d, n_leaves) diagnostics
        (multichain.py:293-302); otherwise the epoch's last step adds the
        chains' aggregate ones after the step (kinetic ‖m‖²/d,
        configurational ⟨θ,g⟩N/d)"""
        b = b or self.bank
        xb, yb = b.train_x[idx], b.train_y[idx]
        if self.augment_fn is not None:
            for seed, g in zip(self._aug_seeds[b.lo:b.hi], b.aug_gens):
                g.manual_seed((seed + int(step)) % 2 ** 63)
            xb = self.augment_fn(xb, b.aug_gens)
        pk = b.kernel.packer

        def group(position, buffers, s, e):
            theta, params = pk.differentiable(position)
            fn = b.model.potential_avg_fn(
                xb[s:e], yb[s:e], self.eff_num_data, train=True,
                compute_dtype=self.compute_dtype, buffers=buffers)
            pot, aux = fn(params)
            g, = torch.autograd.grad(pot.sum(), theta)
            return (pot.detach(), aux["acc"].detach(), aux["loss"].detach(),
                    aux["log_prior"].detach(), pk.wrap_grad(g, position))
        pot, acc, loss, log_prior, g = self._join(self._grouped(group, b), b)
        g = vclip(g, -self.grad_max, self.grad_max)
        lr = self.learning_rate * self.schedule(step)
        granular = self.metrics_savers is not None
        b.chains, km = b.kernel.step(b.chains, g, lr, temperatures,
                                     calc_metrics=granular)
        out = {"potential": pot, "acc": acc}
        if granular:
            out["est_temperature"] = pk.pack_leaf_scalars(
                km["est_temperature"])
            out["est_config_temp"] = pk.pack_leaf_scalars(
                km["est_config_temp"])
            out["loss"] = loss
            out["log_prior"] = log_prior
            out["lr"] = lr
        elif last:
            d = pk.total
            m, pos = b.chains.momentum, b.chains.position
            out["est_temperature"] = vsum(m * m) / d
            out["est_config_temp"] = vsum(pos * g) * (b.kernel.num_data / d)
        return out

    def _metric_rows(self, step0):
        """the epoch's rows that the metrics stream logs (every
        `metrics_skip` steps and always the first), plus the last row for
        the epoch-end entry (`_select_epoch_metrics`, multichain.py:711-731)"""
        n = self.n_full
        if self.metrics_skip <= 1:
            return np.arange(n)
        keep = [i for i in range(n)
                if (step0 + i) % self.metrics_skip == 0 or i == 0]
        if keep[-1] != n - 1:
            keep.append(n - 1)
        return np.asarray(keep)

    # -- an epoch's device work ----------------------------------------------
    def _dispatch_epoch(self, e, step0, t0):
        """epoch e's device work on every sub-bank (its minibatch steps,
        one step of all sub-banks at a time, then the test pass and the
        epoch end), with everything its drain reads staged to the host;
        returns the drain's record (`_dispatch_epoch_tail`,
        multichain.py:644-679)"""
        cycle, epoch = divmod(e, self.epochs_per_cycle)
        idxs = self._epoch_idxs(cycle, epoch)
        temps = [self._temps_for(epoch, b) for b in self.banks]
        rows = [idxs[b.lo:b.hi].to(b.device) for b in self.banks]
        ms = [[] for _ in self.banks]
        for i in range(self.n_full):
            for b, r, t, m in zip(self.banks, rows, temps, ms):
                m.append(self._chain_step(r[:, i], step0 + i, t,
                                          last=i == self.n_full - 1, b=b))
        granular = self.metrics_savers is not None
        rec = {"e": e, "epoch": epoch, "step0": step0,
               "step": step0 + self.n_full, "t0": t0,
               "sel": self._metric_rows(step0) if granular else None,
               "steps": STEP_KEYS if granular else ("potential",)}
        if granular:
            rec["lr"] = np.asarray([ms[0][i]["lr"] for i in rec["sel"]],
                                   dtype=self._np_dtype)
            # the epoch's temperatures as the JAX runner logs them
            rec["temps"] = (np.zeros(self.n_chains)
                            if epoch < self.descent_epochs else
                            self._temps_np)
        evaluate = self._eval_due(e)
        rec["fetch"] = [self._epoch_fetch(b, m, rec["sel"], evaluate)
                        for b, m in zip(self.banks, ms)]
        self._epoch_end(epoch, rec["step"], rec)
        dt = self.banks[0].chains.position.dtype
        rec["fetch"] = [_stage(f, dt) for f in rec["fetch"]]
        rec["events"] = self._mark_copies()
        return rec

    def _epoch_fetch(self, b, ms, sel, evaluate):
        """sub-bank b's values that the drain reads, chain axis first: the
        epoch's potentials, its logged rows (with metrics savers: every
        logged step's per-leaf diagnostics and the preconditioner; else the
        last step's), and the test pass"""
        stacked = lambda k, rows: torch.stack(
            [ms[i][k] for i in rows]).transpose(0, 1)
        fetch = {"potential": stacked("potential", range(self.n_full))}
        if sel is not None:
            for k in STEP_KEYS[1:]:
                fetch[k] = stacked(k, sel)
            fetch["precond"] = b.kernel.leaf_precond(b.chains)
        else:
            for k in ("acc", "est_temperature", "est_config_temp"):
                fetch[k] = ms[-1][k]
        if evaluate:
            lp, acc = self._evaluate(b)
            fetch["test/acc"], fetch["test/loss"] = acc, -lp
        return fetch

    def _mark_copies(self):
        """a CUDA event a card after this epoch's host copies, for the
        drain to wait on (none on the CPU, where the copies are made)"""
        events = []
        for dev in dict.fromkeys(b.device for b in self.banks):
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
        return events

    # -- evaluation ------------------------------------------------------------
    @torch.no_grad()
    def _evaluate(self, b):
        """(mean test log-likelihood, test accuracy), (K_d,) each, on the
        device: every chain of sub-bank b on the whole test set with its
        running batchnorm statistics, in batches of `eval_batch_size` plus
        a ragged last one (`_build_eval_fn`, multichain.py:841-882).
        As there, the network runs in the parameter dtype, with the
        convolutions and products on bf16 operands when `compute_dtype`
        is bf16 (`jax.default_matmul_precision("bfloat16")`,
        multichain.py:870-880; `precision.py`)."""
        params = b.kernel.params_of(b.chains)
        n, B = b.test_x.shape[0], self.eval_batch_size
        lp = acc = 0.0
        bf16 = self.compute_dtype == torch.bfloat16
        with matmul_precision("bfloat16" if bf16 else None):
            for s in range(0, n, B):
                xb, yb = b.test_x[s:s + B], b.test_y[s:s + B]
                xk, yk = xb.expand(b.n, *xb.shape), yb.expand(b.n, *yb.shape)
                # eff_num_data = the batch: ll is the batch's plain sum
                ll, f = b.model.log_likelihood(
                    params, xk, yk, float(yb.shape[0]), train=False,
                    buffers=b.buffers)
                lp = lp + ll
                acc = acc + b.model.acc_fn(f, yk).sum(-1)
        return lp / n, acc / n

    # -- NaN quarantine and the sample bank ------------------------------------
    def _check_finite(self, potentials):
        """a NaN potential in one chain must not kill the independent others:
        warn once per chain instead of raising (multichain.py:884-893)"""
        for c in np.flatnonzero(~np.isfinite(np.asarray(potentials))):
            if c not in self.nan_chains:
                self.nan_chains.add(int(c))
                warnings.warn(f"chain {c}: potential is NaN/inf "
                              "(diverged; its samples will be unusable)")

    @staticmethod
    def _stage_sample(b):
        """sub-bank b's packed position and batchnorm state as host copies
        (`_snapshot_sample`, multichain.py:895-929)"""
        return (vapply(_host_copy, b.chains.position),
                {k: _host_copy(v) for k, v in b.buffers.items()})

    def _store_sample(self, samples, step):
        """every chain's staged sample: to its model saver (one state dict a
        chain, this process's chains only; quarantined chains write
        nothing, multichain.py:930-955), or kept on the host (gathered over
        the ranks)"""
        pk = self.kernel.packer
        if self.model_savers is None:
            parts = {b.lo: (pk.to_flat(pos).numpy(),
                            {k: v.numpy() for k, v in bufs.items()})
                     for b, (pos, bufs) in zip(self.banks, samples)}
            parts = self._host_value(parts)
            flats, bufs = zip(*(parts[lo] for lo in sorted(parts)))
            position = pk.from_flat(torch.from_numpy(np.concatenate(flats)))
            self._samples.append((position, {k: np.concatenate(
                [bf[k] for bf in bufs]) for k in bufs[0]}, step))
            return
        parts: Dict[str, Dict[int, np.ndarray]] = {}
        for b, (position, bufs) in zip(self.banks, samples):
            for k, v in {**pk.unpack(position), **bufs}.items():
                parts.setdefault(k, {})[b.lo] = v.numpy()
        rows = {k: local_chain_rows(v) for k, v in parts.items()}
        for c in self.local_chains:
            saver = self.model_savers[c]
            if saver is None or c in self.nan_chains:
                continue
            saver.add_state_dict({k: v[c] for k, v in rows.items()},
                                 step=step)

    # -- the drain: an epoch's host work ---------------------------------------
    def _drain_epoch(self, rec):
        """epoch rec's host work, after its host copies are done: the NaN
        check, the metric rows, the boundary row, the sample and the
        timings; returns the epoch's entry (numpy (K,) rows)
        (`_drain_epoch`, multichain.py:681-706)"""
        for ev in rec["events"]:
            ev.synchronize()
        parts = {b.lo: _unstage(f) for b, f in zip(self.banks, rec["fetch"])}
        if "boundary" in rec:
            for b, t in zip(self.banks, rec["boundary"]):
                parts[b.lo]["boundary"] = t.numpy()
        parts = self._host_value(parts)
        parts = [parts[lo] for lo in sorted(parts)]
        host = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        for k in rec["steps"]:
            host[k] = np.swapaxes(host[k], 0, 1)
        epoch_s = time.perf_counter() - rec["t0"]
        self.potentials.append(host["potential"])
        entry = {k: host[k] for k in ("acc", "est_temperature",
                                      "est_config_temp", "test/acc",
                                      "test/loss") if k in host}
        entry["potential"] = host["potential"][-1]
        if rec["sel"] is not None:
            # the last row's per-leaf diagnostics as their size-weighted
            # mean, the single chain's '/all' (multichain.py:733-742)
            w = np.asarray(self.kernel.packer.sizes, dtype=np.float64)
            entry["acc"] = host["acc"][-1]
            for k in ("est_temperature", "est_config_temp"):
                entry[k] = (host[k][-1] * w).sum(-1) / w.sum()
        self._check_finite(entry["potential"])
        if self.metrics_savers is not None:
            self._stream_step_metrics(rec, host)
            if "test/acc" in entry:
                self._stream_eval(rec["step"], entry)
        self._drain_boundary(rec, host)
        if "sample" in rec:
            self._store_sample(rec["sample"], rec["step"])
        self._stream_timings(rec["step"], epoch_s, rec.get("wall_s"))
        if self._progressbar:
            progress(rec["e"], self.cycles * self.epochs_per_cycle, epoch_s,
                     entry["potential"])
        return entry

    def _drain_boundary(self, rec, host):
        "hook: the reject runner records and streams its M-H boundary here"

    # -- metric streams (one saver a chain) ------------------------------------
    def _savers(self):
        "(chain, metrics saver) of this process's chains that have one"
        savers = self.metrics_savers or [None] * self.n_chains
        return [(c, savers[c]) for c in self.local_chains
                if savers[c] is not None]

    def _stream_step_metrics(self, rec, host):
        """the per-step per-chain series (multichain.py:744-798): step t's
        metrics under index t-1, every `metrics_skip` steps and always the
        epoch's first; one `add_rows` block a chain an epoch"""
        pk = self.kernel.packer
        sizes = np.asarray(pk.sizes, dtype=np.float64)
        rows = np.asarray(rec["sel"], dtype=np.int64)
        s_abs = rec["step0"] + rows
        r_idx = np.flatnonzero((s_abs % self.metrics_skip == 0) | (rows == 0))
        li = s_abs[r_idx] - 1
        n_rows = r_idx.size
        cast = lambda a: np.asarray(a, dtype=self._np_dtype)
        precond = cast(host["precond"])
        est_t = cast(host["est_temperature"])
        est_c = cast(host["est_config_temp"])
        for c, sv in self._savers():
            et, ec = est_t[r_idx, c, :], est_c[r_idx, c, :]
            cols = {}
            for j, nm in enumerate(pk.names):
                cols["preconditioner/" + nm] = np.full(n_rows, precond[c, j])
                cols["est_temperature/" + nm] = et[:, j]
                cols["est_config_temp/" + nm] = ec[:, j]
            cols["est_temperature/all"] = et @ sizes / sizes.sum()
            cols["est_config_temp/all"] = ec @ sizes / sizes.sum()
            cols["temperature"] = np.full(n_rows, rec["temps"][c])
            for k in ("loss", "acc", "log_prior", "potential"):
                v = host[k] if k != "potential" else host[k][rows]
                cols[k] = cast(v)[r_idx, c]
            cols["lr"] = rec["lr"][r_idx]
            sv.add_rows(cols, li)

    def _stream_eval(self, step, entry):
        "per-chain test/loss and test/acc at step-1 (multichain.py:828-839)"
        for c, sv in self._savers():
            sv.add_scalar("test/loss", float(entry["test/loss"][c]), step - 1)
            sv.add_scalar("test/acc", float(entry["test/acc"][c]), step - 1)

    def _stream_timings(self, step, epoch_s, wall_s=None):
        """multichain.py:800-819: the epoch's time from its dispatch to its
        host copies and, with the pipeline, dispatch to dispatch"""
        for c, sv in self._savers():
            sv.add_scalar("timings/epoch_s", epoch_s, step - 1)
            sv.add_scalar("timings/steps_per_s",
                          self.n_full / max(epoch_s, 1e-9), step - 1)
            sv.add_scalar("timings/aggregate_steps_per_s",
                          self.n_chains * self.n_full / max(epoch_s, 1e-9),
                          step - 1)
            if wall_s is not None:
                sv.add_scalar("timings/wall_s", wall_s, step - 1)
                sv.add_scalar("timings/wall_aggregate_steps_per_s",
                              self.n_chains * self.n_full / max(wall_s, 1e-9),
                              step - 1)
            sv.flush(every_s=10, keep_last_row=True)

    def _flush_metrics(self):
        for _, sv in self._savers():
            sv.flush()

    def get_samples(self, drop_nan_chains=True) -> Dict[str, np.ndarray]:
        """stacked sample bank: each entry (n_samples, n_chains, ...).
        Diverged (NaN) chains are dropped from the chain axis by default so
        they cannot enter posterior-predictive ensembles; pass
        drop_nan_chains=False for the raw bank (multichain.py:972-995)."""
        out: Dict[str, list] = {}
        for position, bufs, _ in self._samples:
            params = self.kernel.packer.unpack(position)
            for k, v in params.items():
                out.setdefault(k, []).append(v.numpy())
            for k, v in bufs.items():
                out.setdefault(k, []).append(v)
        bank = {k: np.stack(v) for k, v in out.items()}
        if drop_nan_chains and self.nan_chains:
            keep = [c for c in range(self.n_chains)
                    if c not in self.nan_chains]
            warnings.warn(f"dropping diverged chains {sorted(self.nan_chains)}"
                          " from the sample bank")
            bank = {k: v[:, keep] for k, v in bank.items()}
        return bank

    # -- checkpoint / resume (io/checkpoint.py; all chains in one file) ------
    def _generators(self):
        """every generator a checkpoint holds, by name: the runner's, and
        each chain's under its chain index"""
        out = {"runner": self.gen}
        for b in self.banks:
            for k, g in b.chains.generators().items():
                field, j = k.rsplit(".", 1)
                out[f"{field}.{b.lo + int(j)}"] = g
        return out

    def _checkpoint_meta(self, next_e, step):
        meta = {"next_epoch_index": int(next_e), "step": int(step),
                "nan_chains": np.asarray(sorted(self.nan_chains),
                                         dtype=np.int64)}
        if self.augment_fn is not None:
            meta["aug_seeds"] = np.asarray(self._aug_seeds, dtype=np.int64)
        return meta

    def _restore_meta(self, meta):
        self.nan_chains = {int(c) for c in np.atleast_1d(meta["nan_chains"])}
        if "aug_seeds" in meta and self.augment_fn is not None:
            self._aug_seeds = [int(s) for s in meta["aug_seeds"]]
        return int(meta["next_epoch_index"]), int(meta["step"])

    def save_checkpoint(self, path, next_epoch_index, step):
        """every chain's whole state (bank, rollback slots, generators,
        batchnorm buffers) and the loop's metadata, to resume at epoch
        `next_epoch_index`. Across processes every rank takes part in the
        gather and rank 0 writes the file."""
        host = lambda t: t.detach().cpu().numpy()
        parts = {}
        for b in self.banks:
            gens = {k: (g.device.type, g.get_state().numpy())
                    for k, g in self._generators().items()
                    if k == "runner" or b.lo <= int(k.rsplit(".", 1)[1])
                    < b.hi}
            parts[b.lo] = ({k: host(v) for k, v in
                            b.chains.state_arrays().items()},
                           {k: host(v) for k, v in b.buffers.items()}, gens)
        meta = self._checkpoint_meta(next_epoch_index, step)
        parts = self._host_value(parts)
        if self._multiprocess and torch.distributed.get_rank() != 0:
            return
        parts = [parts[lo] for lo in sorted(parts)]
        join = lambda vs: vs[0] if vs[0].ndim == 0 else np.concatenate(vs)
        chain = {k: join([p[0][k] for p in parts]) for k in parts[0][0]}
        buffers = {k: join([p[1][k] for p in parts]) for k in parts[0][1]}
        gens = {k: g for p in parts for k, g in p[2].items()}
        save_chain_checkpoint(path, chain, buffers, gens, meta)

    def restore_checkpoint(self, path):
        """the whole runner state from `path` (every rank reads the file and
        keeps its chains' rows); returns (next_epoch_index, step)"""
        K = self.n_chains
        whole = lambda v: torch.empty(
            (K,) + tuple(v.shape[1:]) if v.dim() else (), dtype=v.dtype,
            device="meta")
        b0 = self.banks[0]
        gens = self._generators()
        arrays, bufs, states, meta = load_chain_checkpoint(
            path, {k: whole(v) for k, v in b0.chains.state_arrays().items()},
            {k: whole(v) for k, v in b0.buffers.items()}, gens)
        for b, own, own_bufs in zip(self.banks, put_chains(arrays, self.mesh),
                                    put_chains(bufs, self.mesh)):
            b.chains.load_state_arrays(own)
            with torch.no_grad():
                for k, v in own_bufs.items():
                    b.buffers[k].copy_(torch.from_numpy(v))
        for k, s in states.items():
            gens[k].set_state(s)
        return self._restore_meta(meta)

    # -- main loop -----------------------------------------------------------
    def run(self, progressbar=False, resume_from=None, checkpoint_path=None,
            checkpoint_every=None):
        """all epochs; returns one entry an epoch: each chain's last-step
        potential, acc, est_temperature and est_config_temp and, in epochs
        with a test pass, test/acc and test/loss, as numpy (K,) arrays.
        With `checkpoint_path` and `checkpoint_every` every chain's state is
        written there after every `checkpoint_every`-th epoch; with
        `resume_from` (such a file, or see `resume_point`) the run goes on
        from where it left off, without the start's momentum draw (and the
        reject runner's initial exact step). The drain worker is stopped
        before this returns or raises (multichain.py:464-477)."""
        try:
            return self._run(progressbar, resume_from, checkpoint_path,
                             checkpoint_every)
        except BaseException:
            self._stop_drain_worker(raise_errors=False)
            raise

    def _run(self, progressbar, resume_from, checkpoint_path,
             checkpoint_every):
        self.potentials = []
        self._progressbar = progressbar
        step = start_e = 0
        if resume_from is not None:
            start_e, step = resume_point(self, resume_from)
        else:
            self._start()
        history = []
        pending = None
        for e in range(start_e, self.cycles * self.epochs_per_cycle):
            rec = self._dispatch_epoch(e, step, time.perf_counter())
            step = rec["step"]
            pending = self._advance_pipeline(history, pending, rec)
            if (checkpoint_path is not None and checkpoint_every is not None
                    and (e + 1) % checkpoint_every == 0):
                if pending is not None:
                    pending["wall_s"] = time.perf_counter() - pending["t0"]
                    self._submit_drain(history, pending)
                    pending = None
                self._flush_drains()  # the checkpoint sees every record
                self.save_checkpoint(checkpoint_path, e + 1, step)
        if pending is not None:
            pending["wall_s"] = time.perf_counter() - pending["t0"]
            self._submit_drain(history, pending)
        self._stop_drain_worker()
        self._flush_metrics()
        return history

    # -- the pipeline and its drain worker (multichain.py:538-624) -------------
    def _advance_pipeline(self, history, pending, rec):
        """one epoch deep: the previous epoch's drain goes after this
        epoch's dispatch, its wall time dispatch to dispatch; without the
        pipeline this epoch drains at once"""
        if pending is not None:
            pending["wall_s"] = rec["t0"] - pending["t0"]
            self._submit_drain(history, pending)
        if self.pipeline:
            return rec
        history.append(self._drain_epoch(rec))
        return None

    def _submit_drain(self, history, rec):
        """the drain of `rec`: on the worker thread with the pipeline, on
        this thread without it or across processes (whose gathers are
        collectives: issued from a thread, their order could differ
        between ranks)"""
        if not self.pipeline or self._multiprocess:
            history.append(self._drain_epoch(rec))
            return
        if self._drain_thread is None:
            self._start_drain_worker(history)
        self._raise_drain_errors()
        self._drain_q.put(rec)

    def _start_drain_worker(self, history):
        self._drain_q = queue.Queue(maxsize=2)  # bounds the pipeline's depth
        self._drain_errors = []

        def worker():
            while True:
                rec = self._drain_q.get()
                try:
                    if rec is None:
                        return
                    if not self._drain_errors:
                        history.append(self._drain_epoch(rec))
                except BaseException as err:  # noqa: BLE001 — raised again
                    self._drain_errors.append(err)
                finally:
                    self._drain_q.task_done()

        self._drain_thread = threading.Thread(target=worker,
                                              name="drain-worker", daemon=True)
        self._drain_thread.start()

    def _flush_drains(self):
        "wait until every queued drain is done (before a checkpoint)"
        if self._drain_thread is not None:
            self._drain_q.join()
            self._raise_drain_errors()

    def _raise_drain_errors(self):
        if self._drain_errors:
            err = self._drain_errors[0]
            self._stop_drain_worker(raise_errors=False)
            raise err

    def _stop_drain_worker(self, raise_errors=True):
        """stop the worker after the drains queued before; then raise the
        first error of its drains"""
        thread, self._drain_thread = self._drain_thread, None
        if thread is not None:
            self._drain_q.put(None)
            thread.join(timeout=None if raise_errors else 30)
        if raise_errors and self._drain_errors:
            err, self._drain_errors = self._drain_errors[0], []
            raise err
        self._drain_errors = []

    # -- the loop's start and epoch end -----------------------------------
    def _start(self):
        "every chain's momentum at its temperature (multichain.py:488-489)"
        for b in self.banks:
            b.chains = b.kernel.sample_momentum(b.chains, b.temps[1])

    def _update_preconditioner(self):
        for b in self.banks:
            b.chains = b.kernel.update_preconditioner(b.chains)

    def _epoch_end(self, epoch, step, rec):
        """after an epoch of the plain loop (multichain.py:498-520): the
        sample of a sampling epoch, the preconditioner at `epoch %
        precond_update == 0`, and with the HMC kernel a fresh momentum after
        a sampling epoch (a trajectory's end)"""
        sampling = self._is_sampling_epoch(epoch)
        if sampling:
            rec["sample"] = [self._stage_sample(b) for b in self.banks]
        if (self.precond_update is not None
                and epoch % self.precond_update == 0):
            self._update_preconditioner()
        if self.kernel_name == "HMC" and sampling:
            self._start()

    def chain_samples(self, chain: int) -> Dict[str, np.ndarray]:
        if chain in self.nan_chains:
            raise ValueError(
                f"chain {chain} diverged (NaN potential); its samples are "
                "quarantined: use get_samples(drop_nan_chains=False) to "
                "inspect them")
        bank = self.get_samples(drop_nan_chains=False)
        return {k: v[:, chain] for k, v in bank.items()}


class MultiChainRunnerReject(MultiChainRunner):
    """The paper's main algorithm, GGMC with exact-gradient M-H boundaries
    (`inference=VerletSGLDReject`), over K chains in one bank: the
    counterpart of the JAX `MultiChainRunnerReject`. With
    `kernel="SGLD"` (`inference=SGLDReject`) the boundaries take exact
    gradients but no M-H test (ΔE = ∞, `reject_samples` is turned off);
    with `kernel="HMC"` (`inference=HMCReject`, and at batch N classical
    `HMC`) every chain runs at temperature 1 and draws a fresh momentum
    before every boundary's initial step (multichain.py:1027-1047,
    1130-1145).

    Everything `VerletSGLDRunnerReject` does happens here per chain,
    batched: the exact full-dataset gradient is one sweep in which the K
    chains see every batch together, `final_step` → ΔE → `maybe_reject` →
    `initial_step` are one kernel launch each for all chains of a
    sub-bank, every chain accepts or rejects on its own (a device-side
    select over its rows), and the minibatch order is fixed per (chain,
    cycle). Preconditioner updates land between M-H segments
    (multichain.py:1240-1255). Every chain takes the M-H test and a
    rejection restores its momentum unflipped, as the reference does (the
    JAX runner's `flip_on_reject` is not taken). With
    `reject_samples=False` the chains keep no rollback state, take no M-H
    decision and update the preconditioner at the reference's per-epoch
    cadence."""

    def __init__(self, *args, reject_samples=True, **kwargs):
        # SGLD cannot reject (ΔE = ∞): no rollback slots, no M-H decision
        self.reject_samples = (bool(reject_samples)
                               and kwargs.get("kernel") != "SGLD")
        super().__init__(*args, **kwargs)
        self.tail = self.N - self.n_full * self.batch_size
        # one permutation seed a chain: its order is fixed within a cycle
        self._perm_seeds = [int(torch.randint(0, 2 ** 62, (),
                                              generator=self.gen))
                            for _ in range(self.n_chains)]
        self._idxs = None  # (cycle, (K, n_full, B) indices on the device)
        self._precond_pending = False
        self._total_energies = np.zeros(self.n_chains)
        self.delta_energies: list = []    # (n_chains,) per boundary
        self.rejections: list = []        # (n_chains,) bool per boundary
        self.boundary_metrics: list = []  # exact loss/log_prior/potential/acc

    @property
    def _initial_pots(self):
        return self.bank.initial_pots

    @_initial_pots.setter
    def _initial_pots(self, value):
        self.bank.initial_pots = value

    # -- fixed data order per (chain, cycle) ----------------------------------
    def _epoch_idxs(self, cycle=0, epoch=0):
        "(n_chains, n_full, B) minibatch indices: each chain's order a cycle"
        if self._idxs is None or self._idxs[0] != cycle:
            n = self.n_full * self.batch_size
            perms = [torch.randperm(self.N, generator=torch.Generator()
                                    .manual_seed(s + int(cycle)))[:n]
                     for s in self._perm_seeds]
            self._idxs = (cycle, _to_device(torch.stack(perms).view(
                self.n_chains, self.n_full, self.batch_size), self.device))
        return self._idxs[1]

    # -- exact gradient and the boundaries -----------------------------------
    def _exact(self, b):
        """every chain's exact (loss, log_prior, potential, acc, grads) in
        sub-bank b, a dispatch group at a time (multichain.py:1116-1128)"""
        return self._join(self._grouped(
            lambda position, buffers, s, e: exact_potential_and_grad(
                b.model, b.kernel, position, b.train_x, b.train_y,
                n_full=self.n_full, batch_size=self.batch_size,
                tail=self.tail, N=self.N, eff_num_data=self.eff_num_data,
                grad_max=self.grad_max, buffers=buffers), b), b)

    def _boundary_final(self, lr_index, temperatures, b):
        """exact gradient → final_step → ΔE → maybe_reject → next base
        potential (`_bfinal_fn`, multichain.py:1091-1128) on sub-bank b;
        returns what the drain records, (K_d, 6): ΔE, the decision and the
        exact loss, log prior, potential and accuracy"""
        loss, log_prior, pot, acc, grads = self._exact(b)
        lr = self.learning_rate * self.schedule(lr_index)
        b.chains, _ = b.kernel.final_step(b.chains, grads, lr, temperatures,
                                          calc_metrics=False)
        de = b.kernel.delta_energy(b.chains, grads, lr, b.initial_pots, pot)
        if self.reject_samples:
            b.chains, rejected, _ = b.kernel.maybe_reject(
                b.chains, de, temperatures)
        else:
            rejected = torch.zeros_like(de, dtype=torch.bool)
        # a rejected chain returns to its saved state, whose potential is
        # its old base potential (see inference/reject.py)
        b.initial_pots = torch.where(rejected, b.initial_pots, pot)
        return torch.stack([t.double() for t in (
            de, rejected, loss, log_prior, pot, acc)], dim=1)

    def _boundary_initial(self, lr_index, temperatures, b):
        """initial_step from each chain's (possibly rolled back) exact
        gradient; the HMC kernel first draws a fresh momentum
        (`_build_binit_fn`, multichain.py:1130-1145)"""
        if self.kernel_name == "HMC":
            b.chains = b.kernel.sample_momentum(b.chains, temperatures)
        lr = self.learning_rate * self.schedule(lr_index)
        b.chains, _ = b.kernel.initial_step(
            b.chains, b.chains.grads, lr, temperatures,
            save_state=self.reject_samples, calc_metrics=False)

    # -- checkpoint extras ---------------------------------------------------
    def _checkpoint_meta(self, next_e, step):
        meta = super()._checkpoint_meta(next_e, step)
        meta["initial_pots"] = self._gathered(
            {b.lo: b.initial_pots.cpu().numpy() for b in self.banks})
        meta["precond_pending"] = self._precond_pending
        meta["perm_seeds"] = np.asarray(self._perm_seeds, dtype=np.int64)
        meta["total_energies"] = self._total_energies
        if self.rejections:
            meta["rejections"] = np.stack(self.rejections)
            meta["delta_energies"] = np.stack(self.delta_energies)
        return meta

    def _restore_meta(self, meta):
        for b in self.banks:
            b.initial_pots = on_device(
                meta["initial_pots"][b.lo:b.hi], b.device).to(
                b.chains.position.dtype)
        self._precond_pending = bool(meta["precond_pending"])
        self._perm_seeds = [int(s) for s in meta["perm_seeds"]]
        self._idxs = None  # rebuilt from the seeds
        self._total_energies = np.array(meta["total_energies"])
        if "rejections" in meta:
            self.rejections = list(np.asarray(meta["rejections"], dtype=bool))
            self.delta_energies = list(np.asarray(meta["delta_energies"]))
        return super()._restore_meta(meta)

    def _drain_boundary(self, rec, host):
        """the boundary's records, and its row a chain at index step-1
        (multichain.py:1272-1303): the exact pass's metrics under exact/*,
        ΔE, the total energy and the decision"""
        if "boundary" not in host:
            return
        de, rejected, *exact = host["boundary"].T
        self.delta_energies.append(de)
        self.rejections.append(rejected.astype(bool))
        self.boundary_metrics.append(dict(zip(
            ("loss", "log_prior", "potential", "acc"), exact)))
        self._total_energies = self._total_energies + de
        bm, li = self.boundary_metrics[-1], rec["step"] - 1
        for c, sv in self._savers():
            for k in ("loss", "log_prior", "potential", "acc"):
                sv.add_scalar("exact/" + k, float(bm[k][c]), li)
            sv.add_scalar("delta_energy", float(de[c]), li)
            sv.add_scalar("total_energy", float(self._total_energies[c]), li)
            sv.add_scalar("acceptance/is_sample", 1, li)
            if self.reject_samples:
                sv.add_scalar("acceptance/rejected", int(rejected[c]), li)

    # -- the loop's start and epoch end -----------------------------------
    def _start(self):
        """initial exact gradient, momentum refresh and initial_step
        (multichain.py:1188-1196)"""
        for b in self.banks:
            _, _, pot, _, grads = self._exact(b)
            b.chains.grads = grads
            b.chains = b.kernel.sample_momentum(b.chains, b.temps[1])
            self._boundary_initial(0, b.temps[1], b)
            b.initial_pots = pot

    def _epoch_end(self, epoch, step, rec):
        """the M-H boundary after a sampling epoch, and the preconditioner
        (multichain.py:1220-1255): with an M-H test it changes only between
        M-H segments, so ΔE is each segment's true energy change"""
        # without an M-H test, or with no sampling epoch, there is no M-H
        # segment to keep M fixed in
        defer_precond = self.reject_samples and self.sample_epochs > 0
        precond_due = (self.precond_update is not None
                       and (epoch + 1) % self.precond_update == 0)
        if self._is_sampling_epoch(epoch):
            update = (precond_due or (defer_precond
                                      and self._precond_pending))
            rec["sample"], rec["boundary"] = [], []
            for b in self.banks:
                temps = self._temps_for(epoch, b)
                rec["boundary"].append(_host_copy(
                    self._boundary_final(step - 1, temps, b)))
                # the sample is taken after maybe_reject, so it is already
                # rolled back (inference_reject.py:140-146)
                rec["sample"].append(self._stage_sample(b))
                if update:
                    b.chains = b.kernel.update_preconditioner(b.chains)
                self._boundary_initial(step, temps, b)
            if defer_precond:
                self._precond_pending = False
        elif precond_due:
            if defer_precond:
                self._precond_pending = True
            else:
                self._update_preconditioner()

    def acceptance_rates(self) -> np.ndarray:
        "(n_chains,) fraction of accepted M-H boundaries"
        if not self.rejections:
            return np.ones(self.n_chains)
        return 1.0 - np.stack(self.rejections).mean(axis=0)
