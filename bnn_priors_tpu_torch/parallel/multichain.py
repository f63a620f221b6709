"""K independent chains on one card (counterpart of
`bnn_priors_tpu/parallel/multichain.py` without the mesh):
`MultiChainRunner`, the plain loop of SGLD, GGMC (VerletSGLD) or HMC
(OurHMC) chains, and `MultiChainRunnerReject`, the same chains with exact
full-data gradients and an M-H test at every sampling boundary.

The K chains step together: their state is one `(K, T)` bank (a chain
form of `mcmc/chains.py`: `SGLDChains`, `VerletSGLDChains`, `HMCChains`),
every minibatch step is one forward/backward of all K networks folded into
channel groups (`models/layers.py`) on one minibatch a chain, and one
launch of the `(K, T)` fused kernel updates them all. Temperatures are per
chain (0 in descent epochs). The plain runner draws a fresh minibatch
order a chain each epoch; the reject runner keeps each chain's order fixed
within a cycle, and each chain takes its own M-H decision at every
sampling boundary, rolled back on the device.

`chain_group_size` splits the K chains into dispatch groups of that many
chains (it must divide K; 0 or None: one group). The groups' forward and
backward passes, minibatch and exact, run one after another, each over
its rows of the bank; the bank stays (K, T) and every update stays one
launch over all K chains, so trajectories equal the ungrouped ones. The
JAX package's automatic choice (`MEASURED_GROUP_RATES`,
`CHAIN_GROUP_TARGET`) rests on TPU measurements and is not carried over:
None is one group until the card's own curve sets a rule (ROADMAP item 8).

The test pass runs every `eval_skip` epochs and after the last (0 or None:
never), `_eval_due` of multichain.py:638-642.

Host reads: once an epoch (the minibatch potentials, the last step's
diagnostics and the test metrics, with the NaN check; with metrics savers
also the logged steps' per-leaf diagnostics and the preconditioner) and
once a boundary (ΔE, the decisions and the exact-pass metrics),
synchronously. With `metrics_savers` (one `HDF5Metrics`-like saver a
chain) every chain streams the JAX package's step-granular series at its
indices; with `model_savers` every chain's samples stream to its own saver
(a quarantined NaN chain writes none). `augment_fn(x, generators)` augments
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

Not ported here: the mesh and multi-process paths, and the drain worker
and epoch pipelining (the port's loop is synchronous).
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from .. import mcmc
from ..device import resolve_device
from ..inference.reject import exact_potential_and_grad
from ..inference.runner import progress, resume_point, to_host
from ..inference.schedules import make_schedule
from ..io.checkpoint import restore_chain_checkpoint, save_chain_checkpoint
from ..mcmc.segmented import vapply, vclip, vsum
from ..mcmc.sgld import on_device
from .chains import init_chains_diverse, init_chains_from_fn


KERNELS = {"SGLD": mcmc.SGLDChains, "VerletSGLD": mcmc.VerletSGLDChains,
           "HMC": mcmc.HMCChains}


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
    boundary passes stay in the parameter dtype."""

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
                 metrics_skip=1, eval_skip=1, device="cuda", packing="flat"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        dtype = next(self.model.parameters()).dtype
        self.train_x, self.train_y = (t.to(self.device) for t in train_data)
        self.n_chains = K = int(n_chains)
        self.chain_group_size = int(chain_group_size or 0)
        if self.chain_group_size and K % self.chain_group_size:
            raise ValueError(f"chain_group_size={chain_group_size} does not "
                             f"divide the {K} chains")
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
        # an epoch is n_full minibatch steps: no ragged tail (as JAX's scan)
        self.schedule = make_schedule(
            sampling_decay, self.n_full * epochs_per_cycle,
            steps_per_stair=150 * self.n_full)

        self.temperatures = torch.as_tensor(
            temperatures, dtype=dtype).expand(K).contiguous().to(self.device)
        # the two per-chain temperature vectors of a run (descent, sampling),
        # made once: the kernel keys its noise_std cache on them
        self._temps = (torch.zeros_like(self.temperatures), self.temperatures)

        self.packing = packing
        self.kernel_name = kernel
        if kernel == "HMC":
            # OurHMC (multichain.py:120-129): T=1, momentum 1, no descent
            assert bool((self.temperatures == 1.0).all()), \
                "HMC kernel requires temperature=1 for every chain"
            assert self.descent_epochs == 0, \
                "HMC not implemented for descent (T=0) epochs"
        self.kernel = KERNELS[kernel](
            num_data=self.eff_num_data, packing=packing,
            **({} if kernel == "HMC" else {"momentum": momentum}))
        # host generator: chain seeds and data orders (explicit, never global)
        self.gen = torch.Generator().manual_seed(int(seed))
        init_seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen))
        # with rollback slots: every chain takes an M-H test
        if init_params_fn is not None:
            self.chains = init_chains_from_fn(
                self.kernel, K, init_params_fn, init_seed,
                init_kwargs={"save_state": self.reject_samples})
        else:
            self.chains = init_chains_diverse(
                self.kernel, self.model, K, init_seed,
                init_kwargs={"save_state": self.reject_samples})
        # each chain's own batchnorm state, (K, ...) (multichain.py:153-156)
        self.buffers: Dict[str, torch.Tensor] = {
            k: v.detach().expand(K, *v.shape).contiguous()
            for k, v in self.model.named_buffers()}
        if test_data is not None:
            self.test_x, self.test_y = (t.to(self.device) for t in test_data)
            self.eval_batch_size = int(eval_batch_size or batch_size)
        else:
            self.test_x = self.test_y = None
        self.eval_skip = int(eval_skip or 0)
        self.nan_chains: set = set()
        self._samples: List[tuple] = []
        self.potentials: List[np.ndarray] = []
        self.augment_fn = augment_fn
        if augment_fn is not None:
            self._aug_seeds = [int(torch.randint(0, 2 ** 62, (),
                                                 generator=self.gen))
                               for _ in range(K)]
            self._aug_gens = [torch.Generator(device=self.device)
                              for _ in range(K)]
        for savers in (model_savers, metrics_savers):
            assert savers is None or len(savers) == K, "one saver a chain"
        self.model_savers = model_savers
        self.metrics_savers = metrics_savers
        self.metrics_skip = int(metrics_skip)
        self._np_dtype = np.float32 if dtype == torch.float32 else np.float64

    def _temps_for(self, epoch):
        "(K,) temperatures for the epoch (0 during descent epochs)"
        return self._temps[int(epoch >= self.descent_epochs)]

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
        return torch.stack(perms).view(self.n_chains, self.n_full,
                                       self.batch_size).to(self.device)

    # -- dispatch groups -----------------------------------------------------
    def _groups(self):
        "(start, stop) chains of each dispatch group, in order"
        Kg = self.chain_group_size or self.n_chains
        return [(s, s + Kg) for s in range(0, self.n_chains, Kg)]

    def _grouped(self, fn):
        """`fn(rows of the bank's position, rows of the buffers, start,
        stop)` for each dispatch group, in order; returns each group's
        result (one group: the bank itself, no copy)"""
        groups, position = self._groups(), self.chains.position
        if len(groups) == 1:
            return [fn(position, self.buffers, 0, self.n_chains)]
        pk = self.kernel.packer
        return [fn(pk.rows(position, s, e),
                   {k: v[s:e] for k, v in self.buffers.items()}, s, e)
                for s, e in groups]

    def _join(self, parts):
        """the groups' tuples of (K_g, ...) tensors, ending with a packed
        gradient, as one tuple over all chains"""
        if len(parts) == 1:
            return parts[0]
        *vals, grads = zip(*parts)
        return (*(torch.cat(v) for v in vals),
                self.kernel.packer.cat_rows(grads))

    # -- one minibatch step of all chains ------------------------------------
    def _chain_step(self, idx, step, temperatures, last=False):
        """every chain's transition on its own minibatch (idx (K, B)). With
        metrics savers every step returns the per-leaf (K, n_leaves)
        diagnostics (multichain.py:293-302); otherwise the epoch's last step
        adds the chains' aggregate ones after the step (kinetic ‖m‖²/d,
        configurational ⟨θ,g⟩N/d)"""
        xb, yb = self.train_x[idx], self.train_y[idx]
        if self.augment_fn is not None:
            for seed, g in zip(self._aug_seeds, self._aug_gens):
                g.manual_seed((seed + int(step)) % 2 ** 63)
            xb = self.augment_fn(xb, self._aug_gens)
        pk = self.kernel.packer

        def group(position, buffers, s, e):
            theta, params = pk.differentiable(position)
            fn = self.model.potential_avg_fn(
                xb[s:e], yb[s:e], self.eff_num_data, train=True,
                compute_dtype=self.compute_dtype, buffers=buffers)
            pot, aux = fn(params)
            g, = torch.autograd.grad(pot.sum(), theta)
            return (pot.detach(), aux["acc"].detach(), aux["loss"].detach(),
                    aux["log_prior"].detach(), pk.wrap_grad(g, position))
        pot, acc, loss, log_prior, g = self._join(self._grouped(group))
        g = vclip(g, -self.grad_max, self.grad_max)
        lr = self.learning_rate * self.schedule(step)
        granular = self.metrics_savers is not None
        self.chains, km = self.kernel.step(self.chains, g, lr, temperatures,
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
            d = self.kernel.packer.total
            m, pos = self.chains.momentum, self.chains.position
            out["est_temperature"] = vsum(m * m) / d
            out["est_config_temp"] = vsum(pos * g) * (self.kernel.num_data / d)
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

    def _run_epoch(self, idxs, step0, temperatures, evaluate=True):
        """n_full steps of all chains, then the test evaluation (when
        `evaluate`), then the epoch's one host read; returns the epoch's
        entry (numpy (K,) rows) and, with metrics savers, the logged rows
        for the stream"""
        ms = [self._chain_step(idxs[:, b], step0 + b, temperatures,
                               last=b == self.n_full - 1)
              for b in range(self.n_full)]
        fetch = {"potential": torch.stack([m["potential"] for m in ms])}
        sel = None
        if self.metrics_savers is not None:
            sel = self._metric_rows(step0)
            for k in ("acc", "loss", "log_prior", "est_temperature",
                      "est_config_temp"):
                fetch[k] = torch.stack([ms[i][k] for i in sel])
            fetch["precond"] = self.kernel.leaf_precond(self.chains)
        else:
            for k in ("acc", "est_temperature", "est_config_temp"):
                fetch[k] = ms[-1][k]
        if evaluate:
            lp, acc = self._evaluate()
            fetch["test/acc"], fetch["test/loss"] = acc, -lp
        host = to_host(fetch, self.chains.position.dtype)
        self.potentials.append(host["potential"])
        entry = {k: host[k] for k in ("acc", "est_temperature",
                                      "est_config_temp", "test/acc",
                                      "test/loss") if k in host}
        entry["potential"] = host["potential"][-1]
        if sel is not None:
            # the last row's per-leaf diagnostics as their size-weighted
            # mean, the single chain's '/all' (multichain.py:733-742)
            w = np.asarray(self.kernel.packer.sizes, dtype=np.float64)
            entry["acc"] = host["acc"][-1]
            for k in ("est_temperature", "est_config_temp"):
                entry[k] = (host[k][-1] * w).sum(-1) / w.sum()
            host["sel"] = sel
            host["lr"] = np.asarray(
                [ms[i]["lr"] for i in sel], dtype=self._np_dtype)
        self._check_finite(entry["potential"])
        return entry, host

    # -- evaluation ------------------------------------------------------------
    @torch.no_grad()
    def _evaluate(self):
        """(mean test log-likelihood, test accuracy), (K,) each, on the
        device: every chain on the whole test set with its running batchnorm
        statistics, in batches of `eval_batch_size` plus a ragged last one
        (`_build_eval_fn`, multichain.py:841-882). Evaluation follows the
        training precision (`compute_dtype`), as there."""
        K = self.n_chains
        params = self.kernel.params_of(self.chains)
        n, B = self.test_x.shape[0], self.eval_batch_size
        lp = acc = 0.0
        for s in range(0, n, B):
            xb, yb = self.test_x[s:s + B], self.test_y[s:s + B]
            xk, yk = xb.expand(K, *xb.shape), yb.expand(K, *yb.shape)
            # eff_num_data = the batch: ll is the batch's plain sum
            ll, f = self.model.log_likelihood(
                params, xk, yk, float(yb.shape[0]), train=False,
                compute_dtype=self.compute_dtype, buffers=self.buffers)
            lp = lp + ll
            acc = acc + self.model.acc_fn(f, yk).sum(-1)
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

    def _store_sample(self, step):
        """every chain's packed position and batchnorm state: to its model
        saver (one state dict a chain; quarantined chains write nothing,
        multichain.py:930-955), or kept on the host"""
        position = vapply(lambda t: t.detach().cpu().clone(),
                          self.chains.position)
        bufs = {k: v.cpu().numpy().copy() for k, v in self.buffers.items()}
        if self.model_savers is None:
            self._samples.append((position, bufs, step))
            return
        params = self.kernel.packer.unpack(position)
        for c, saver in enumerate(self.model_savers):
            if saver is None or c in self.nan_chains:
                continue
            sd = {k: v[c].numpy() for k, v in params.items()}
            sd.update({k: v[c] for k, v in bufs.items()})
            saver.add_state_dict(sd, step=step)

    # -- metric streams (one saver a chain) ------------------------------------
    def _savers(self):
        return [(c, sv) for c, sv in enumerate(self.metrics_savers or ())
                if sv is not None]

    def _stream_step_metrics(self, step0, host, temps):
        """the per-step per-chain series (multichain.py:744-798): step t's
        metrics under index t-1, every `metrics_skip` steps and always the
        epoch's first; one `add_rows` block a chain an epoch"""
        pk = self.kernel.packer
        sizes = np.asarray(pk.sizes, dtype=np.float64)
        rows = np.asarray(host["sel"], dtype=np.int64)
        s_abs = step0 + rows
        r_idx = np.flatnonzero((s_abs % self.metrics_skip == 0) | (rows == 0))
        li = s_abs[r_idx] - 1
        n_rows = r_idx.size
        cast = lambda a: np.asarray(a, dtype=self._np_dtype)
        precond = cast(host["precond"])
        est_t, est_c = cast(host["est_temperature"]), cast(host["est_config_temp"])
        for c, sv in self._savers():
            et, ec = est_t[r_idx, c, :], est_c[r_idx, c, :]
            cols = {}
            for j, nm in enumerate(pk.names):
                cols["preconditioner/" + nm] = np.full(n_rows, precond[c, j])
                cols["est_temperature/" + nm] = et[:, j]
                cols["est_config_temp/" + nm] = ec[:, j]
            cols["est_temperature/all"] = et @ sizes / sizes.sum()
            cols["est_config_temp/all"] = ec @ sizes / sizes.sum()
            cols["temperature"] = np.full(n_rows, temps[c])
            for k in ("loss", "acc", "log_prior", "potential"):
                v = host[k] if k != "potential" else host[k][rows]
                cols[k] = cast(v)[r_idx, c]
            cols["lr"] = host["lr"][r_idx]
            sv.add_rows(cols, li)

    def _stream_eval(self, step, entry):
        "per-chain test/loss and test/acc at step-1 (multichain.py:828-839)"
        for c, sv in self._savers():
            sv.add_scalar("test/loss", float(entry["test/loss"][c]), step - 1)
            sv.add_scalar("test/acc", float(entry["test/acc"][c]), step - 1)

    def _stream_timings(self, step, epoch_s):
        "multichain.py:800-819, without the pipeline's wall-clock series"
        for c, sv in self._savers():
            sv.add_scalar("timings/epoch_s", epoch_s, step - 1)
            sv.add_scalar("timings/steps_per_s",
                          self.n_full / max(epoch_s, 1e-9), step - 1)
            sv.add_scalar("timings/aggregate_steps_per_s",
                          self.n_chains * self.n_full / max(epoch_s, 1e-9),
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
    def _checkpoint_parts(self):
        "(chain state, batchnorm buffers, generators) a checkpoint holds"
        return (self.chains, self.buffers,
                {"runner": self.gen, **self.chains.generators()})

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
        `next_epoch_index`"""
        state, buffers, gens = self._checkpoint_parts()
        save_chain_checkpoint(path, state.state_arrays(), buffers, gens,
                              self._checkpoint_meta(next_epoch_index, step))

    def restore_checkpoint(self, path):
        "the whole runner state from `path`; returns (next_epoch_index, step)"
        return self._restore_meta(
            restore_chain_checkpoint(path, *self._checkpoint_parts()))

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
        reject runner's initial exact step)."""
        self.potentials = []
        step = start_e = 0
        if resume_from is not None:
            start_e, step = resume_point(self, resume_from)
        else:
            self._start()
        history = []
        total_epochs = self.cycles * self.epochs_per_cycle
        for e in range(start_e, total_epochs):
            cycle, epoch = divmod(e, self.epochs_per_cycle)
            t0 = time.perf_counter()
            temps = self._temps_for(epoch)
            entry, host = self._run_epoch(self._epoch_idxs(cycle, epoch),
                                          step, temps, self._eval_due(e))
            step0, step = step, step + self.n_full
            if self.metrics_savers is not None:
                # the epoch's temperatures as the JAX runner logs them
                temps_np = (np.zeros(self.n_chains)
                            if epoch < self.descent_epochs else
                            self.temperatures.cpu().numpy())
                self._stream_step_metrics(step0, host, temps_np)
                if "test/acc" in entry:
                    self._stream_eval(step, entry)
            self._epoch_end(epoch, step, temps)
            epoch_s = time.perf_counter() - t0
            self._stream_timings(step, epoch_s)
            if progressbar:
                progress(e, total_epochs, epoch_s, entry["potential"])
            history.append(entry)
            if (checkpoint_path is not None and checkpoint_every is not None
                    and (e + 1) % checkpoint_every == 0):
                self.save_checkpoint(checkpoint_path, e + 1, step)
        self._flush_metrics()
        return history

    def _start(self):
        "every chain's momentum at its temperature (multichain.py:488-489)"
        self.chains = self.kernel.sample_momentum(self.chains,
                                                  self.temperatures)

    def _epoch_end(self, epoch, step, temps):
        """after an epoch of the plain loop (multichain.py:498-520): the
        sample of a sampling epoch, the preconditioner at `epoch %
        precond_update == 0`, and with the HMC kernel a fresh momentum after
        a sampling epoch (a trajectory's end)"""
        sampling = self._is_sampling_epoch(epoch)
        if sampling:
            self._store_sample(step)
        if (self.precond_update is not None
                and epoch % self.precond_update == 0):
            self.chains = self.kernel.update_preconditioner(self.chains)
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
    counterpart of the JAX `MultiChainRunnerReject` with no mesh. With
    `kernel="SGLD"` (`inference=SGLDReject`) the boundaries take exact
    gradients but no M-H test (ΔE = ∞, `reject_samples` is turned off);
    with `kernel="HMC"` (`inference=HMCReject`, and at batch N classical
    `HMC`) every chain runs at temperature 1 and draws a fresh momentum
    before every boundary's initial step (multichain.py:1027-1047,
    1130-1145).

    Everything `VerletSGLDRunnerReject` does happens here per chain,
    batched: the exact full-dataset gradient is one sweep in which the K
    chains see every batch together, `final_step` → ΔE → `maybe_reject` →
    `initial_step` are one kernel launch each for all chains, every chain
    accepts or rejects on its own (a device-side select over its rows), and
    the minibatch order is fixed per (chain, cycle). Preconditioner updates
    land between M-H segments (multichain.py:1240-1255). Every chain takes
    the M-H test and a rejection restores its momentum unflipped, as the
    reference does (the JAX runner's `flip_on_reject` is not taken). With
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
        self._initial_pots = None
        self._precond_pending = False
        self._total_energies = np.zeros(self.n_chains)
        self.delta_energies: list = []    # (n_chains,) per boundary
        self.rejections: list = []        # (n_chains,) bool per boundary
        self.boundary_metrics: list = []  # exact loss/log_prior/potential/acc

    # -- fixed data order per (chain, cycle) ----------------------------------
    def _epoch_idxs(self, cycle=0, epoch=0):
        "(n_chains, n_full, B) minibatch indices: each chain's order a cycle"
        if self._idxs is None or self._idxs[0] != cycle:
            n = self.n_full * self.batch_size
            perms = [torch.randperm(self.N, generator=torch.Generator()
                                    .manual_seed(s + int(cycle)))[:n]
                     for s in self._perm_seeds]
            self._idxs = (cycle, torch.stack(perms).view(
                self.n_chains, self.n_full, self.batch_size).to(self.device))
        return self._idxs[1]

    # -- exact gradient and the boundaries -----------------------------------
    def _exact(self):
        """every chain's exact (loss, log_prior, potential, acc, grads), a
        dispatch group at a time (multichain.py:1116-1128)"""
        return self._join(self._grouped(
            lambda position, buffers, s, e: exact_potential_and_grad(
                self.model, self.kernel, position, self.train_x,
                self.train_y, n_full=self.n_full, batch_size=self.batch_size,
                tail=self.tail, N=self.N, eff_num_data=self.eff_num_data,
                grad_max=self.grad_max, buffers=buffers)))

    def _boundary_final(self, lr_index, temperatures):
        """exact gradient → final_step → ΔE → maybe_reject → next base
        potential (`_bfinal_fn`, multichain.py:1091-1128), then the
        boundary's one host read"""
        loss, log_prior, pot, acc, grads = self._exact()
        lr = self.learning_rate * self.schedule(lr_index)
        self.chains, _ = self.kernel.final_step(self.chains, grads, lr,
                                                temperatures,
                                                calc_metrics=False)
        de = self.kernel.delta_energy(self.chains, grads, lr,
                                      self._initial_pots, pot)
        if self.reject_samples:
            self.chains, rejected, _ = self.kernel.maybe_reject(
                self.chains, de, temperatures)
        else:
            rejected = torch.zeros_like(de, dtype=torch.bool)
        # a rejected chain returns to its saved state, whose potential is
        # its old base potential (see inference/reject.py)
        self._initial_pots = torch.where(rejected, self._initial_pots, pot)
        host = torch.stack([t.double() for t in (
            de, rejected, loss, log_prior, pot, acc)]).cpu().numpy()
        self.delta_energies.append(host[0])
        self.rejections.append(host[1].astype(bool))
        self.boundary_metrics.append(dict(zip(
            ("loss", "log_prior", "potential", "acc"), host[2:])))
        self._total_energies = self._total_energies + host[0]

    def _boundary_initial(self, lr_index, temperatures):
        """initial_step from each chain's (possibly rolled back) exact
        gradient; the HMC kernel first draws a fresh momentum
        (`_build_binit_fn`, multichain.py:1130-1145)"""
        if self.kernel_name == "HMC":
            self.chains = self.kernel.sample_momentum(self.chains,
                                                      temperatures)
        lr = self.learning_rate * self.schedule(lr_index)
        self.chains, _ = self.kernel.initial_step(
            self.chains, self.chains.grads, lr, temperatures,
            save_state=self.reject_samples, calc_metrics=False)

    # -- checkpoint extras ---------------------------------------------------
    def _checkpoint_meta(self, next_e, step):
        meta = super()._checkpoint_meta(next_e, step)
        meta["initial_pots"] = self._initial_pots
        meta["precond_pending"] = self._precond_pending
        meta["perm_seeds"] = np.asarray(self._perm_seeds, dtype=np.int64)
        meta["total_energies"] = self._total_energies
        if self.rejections:
            meta["rejections"] = np.stack(self.rejections)
            meta["delta_energies"] = np.stack(self.delta_energies)
        return meta

    def _restore_meta(self, meta):
        self._initial_pots = on_device(meta["initial_pots"], self.device).to(
            self.chains.position.dtype)
        self._precond_pending = bool(meta["precond_pending"])
        self._perm_seeds = [int(s) for s in meta["perm_seeds"]]
        self._idxs = None  # rebuilt from the seeds
        self._total_energies = np.array(meta["total_energies"])
        if "rejections" in meta:
            self.rejections = list(np.asarray(meta["rejections"], dtype=bool))
            self.delta_energies = list(np.asarray(meta["delta_energies"]))
        return super()._restore_meta(meta)

    def _stream_boundary(self, step):
        """the M-H boundary row a chain at index step-1 (multichain.py:
        1284-1303): the exact pass's metrics under exact/*, ΔE, the total
        energy and the decision"""
        bm, li = self.boundary_metrics[-1], step - 1
        de, rejected = self.delta_energies[-1], self.rejections[-1]
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
        _, _, pot, _, grads = self._exact()
        self.chains.grads = grads
        super()._start()
        self._boundary_initial(0, self.temperatures)
        self._initial_pots = pot

    def _epoch_end(self, epoch, step, temps):
        """the M-H boundary after a sampling epoch, and the preconditioner
        (multichain.py:1220-1255): with an M-H test it changes only between
        M-H segments, so ΔE is each segment's true energy change"""
        # without an M-H test, or with no sampling epoch, there is no M-H
        # segment to keep M fixed in
        defer_precond = self.reject_samples and self.sample_epochs > 0
        precond_due = (self.precond_update is not None
                       and (epoch + 1) % self.precond_update == 0)
        if self._is_sampling_epoch(epoch):
            self._boundary_final(step - 1, temps)
            self._stream_boundary(step)
            # the sample is taken after maybe_reject, so it is already
            # rolled back (inference_reject.py:140-146)
            self._store_sample(step)
            if defer_precond:
                if precond_due or self._precond_pending:
                    self.chains = self.kernel.update_preconditioner(
                        self.chains)
                    self._precond_pending = False
            elif precond_due:
                self.chains = self.kernel.update_preconditioner(self.chains)
            self._boundary_initial(step, temps)
        elif precond_due:
            if defer_precond:
                self._precond_pending = True
            else:
                self.chains = self.kernel.update_preconditioner(self.chains)

    def acceptance_rates(self) -> np.ndarray:
        "(n_chains,) fraction of accepted M-H boundaries"
        if not self.rejections:
            return np.ones(self.n_chains)
        return 1.0 - np.stack(self.rejections).mean(axis=0)
