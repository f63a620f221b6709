"""Cyclical SG-MCMC runners `SGLDRunner` and `VerletSGLDRunner`
(counterpart of `bnn_priors_tpu/inference/runner.py`), and the pieces the
exact-gradient reject runner (`reject.py`) builds on.

Each cycle has descent (T=0), warmup and sampling phases with a cosine LR
schedule. The training set lives on the device; an epoch is a Python loop
over minibatches gathered there (the JAX package's jitted `lax.scan`
becomes that loop), with a ragged tail batch of its true size so likelihood
scaling and batchnorm statistics match. The LR schedule is a host float of
the global step index, so a step needs no device sync; the epoch's
per-step values are read once, at its end, for the NaN check and the
metrics.

Protocol parity notes:
* scheduler order: global step t uses lr₀·sched(t) with sched(0)=1.
* `VerletSGLDRunner` performs final_step → ΔE → (maybe_reject) →
  initial_step at the FIRST minibatch of the epoch following each sampling
  epoch, reusing that minibatch's gradient (reference inference.py:304-365).
* samples are saved at the END of each sampling epoch, before the next
  boundary's M-H decision (the reference's `reject_samples_` resolves
  rejected samples afterwards); with a `model_saver` they stream to it.
* metrics of step t are logged under index t-1 (reference
  inference.py:244-248), through the `metrics_saver`'s
  `add_scalar(name, value, step)`/`flush(...)` interface; the per-step
  kernel diagnostics are computed only when it is set.
* `augment_fn(x, generator)` augments every minibatch step (not the
  boundary steps, as in the JAX package), from a device generator seeded
  with the runner's augmentation seed plus the global step: the same seed
  replays the same augmentations.
* with `checkpoint_path` and `checkpoint_every`, the whole runner state
  (chain, model buffers, generators, loop metadata; `io/checkpoint.py`) is
  written after every `checkpoint_every`-th epoch, and `run(resume_from=)`
  continues from such a file bit for bit (runner.py:333-390).
* `HMCRunner` refreshes the momentum at every boundary (a new trajectory
  a sampling epoch; runner.py:594-611,637-638,702-708).
* `packing` ("flat", the default; "segmented"; "hybrid") chooses the chain
  state's layout (`mcmc/segmented.py`). The JAX runners default to
  "hybrid"; here flat stays the default until the card shows otherwise.

Not ported: profiling.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import mcmc
from ..device import resolve_device
from ..io.checkpoint import restore_chain_checkpoint, save_chain_checkpoint
from ..mcmc.segmented import vclip
from .schedules import make_schedule


def to_host(tensors, dtype=torch.float64):
    """{key: numpy array in `dtype`} from a dict of device tensors, in ONE
    device→host transfer"""
    if not tensors:
        return {}
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors.values()])
    flat = flat.cpu().numpy()
    out, at = {}, 0
    for k, t in tensors.items():
        out[k] = flat[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
    return out


def host_rows(ms, keys):
    """{key: (n, ...) float64 numpy} from a list of per-step dicts of device
    tensors (or host floats), in one device→host transfer"""
    out = {k: np.asarray([m[k] for m in ms], dtype=np.float64)
           for k in keys if not torch.is_tensor(ms[0][k])}
    out.update(to_host({k: torch.stack([m[k] for m in ms]) for k in keys
                        if torch.is_tensor(ms[0][k])}))
    return out


def resume_point(runner, resume_from):
    """(first epoch, step) of a run resumed from `resume_from`: a
    checkpoint path, or the (next_epoch_index, step) of a state already
    restored (`interop.load_jax_checkpoint`)"""
    if isinstance(resume_from, tuple):
        return resume_from
    return runner.restore_checkpoint(resume_from)


def progress(e, total, epoch_s, potential):
    "the runners' `progressbar`: one line an epoch on stderr"
    print(f"epoch {e + 1}/{total}: {epoch_s:.2f} s, potential "
          f"{potential}", file=sys.stderr, flush=True)


class SGLDRunner:
    def __init__(self, model, train_data, test_data, epochs_per_cycle,
                 warmup_epochs, sample_epochs, learning_rate=1e-2, skip=1,
                 metrics_skip=1, temperature=1.0, data_mult=1.0, momentum=0.0,
                 sampling_decay=True, grad_max=1e6, cycles=1,
                 precond_update=None, metrics_saver=None, model_saver=None,
                 reject_samples=False, flip_on_reject=False,
                 batch_size=128, eval_batch_size=None,
                 augment_fn: Optional[Callable] = None, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 checkpoint_path=None, checkpoint_every=None, device="cuda",
                 packing="flat"):
        self.device = resolve_device(device)
        self.packing = packing
        self.model = model.to(self.device)
        self.train_x, self.train_y = (t.to(self.device) for t in train_data)
        if test_data is not None:
            self.test_x, self.test_y = (t.to(self.device) for t in test_data)
        else:
            self.test_x = self.test_y = None

        assert warmup_epochs >= 0 and sample_epochs >= 0
        assert epochs_per_cycle >= warmup_epochs + sample_epochs
        self.epochs_per_cycle = epochs_per_cycle
        self.descent_epochs = epochs_per_cycle - warmup_epochs - sample_epochs
        self.warmup_epochs = warmup_epochs
        self.sample_epochs = sample_epochs
        self.skip = skip
        self.metrics_skip = metrics_skip
        self.num_samples = sample_epochs // skip
        assert sample_epochs % skip == 0

        self.learning_rate = learning_rate
        self.temperature = temperature
        self.N = int(self.train_x.shape[0])
        self.eff_num_data = self.N * data_mult
        self.momentum = momentum
        self.sampling_decay = sampling_decay
        self.grad_max = grad_max
        self.cycles = cycles
        self.precond_update = precond_update
        self.metrics_saver = metrics_saver
        self.model_saver = model_saver
        self.reject_samples = reject_samples
        # GHMC momentum-flip correction on rejection (the reference never
        # flips)
        self.flip_on_reject = flip_on_reject
        self.batch_size = int(batch_size)
        self.eval_batch_size = int(eval_batch_size or batch_size)
        self.augment_fn = augment_fn
        # e.g. torch.bfloat16: run the net forward/backward in reduced
        # precision (params+inputs cast down, likelihood/prior reductions
        # stay in the parameter dtype) — models/base.py log_likelihood
        self.compute_dtype = compute_dtype
        # full chain-state checkpoints (io/checkpoint.py)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every

        self.n_full = self.N // self.batch_size
        self.tail = self.N - self.n_full * self.batch_size
        self.steps_per_epoch = self.n_full + (1 if self.tail else 0)
        self.schedule = make_schedule(
            sampling_decay, self.steps_per_epoch * epochs_per_cycle,
            steps_per_stair=150 * self.steps_per_epoch)

        # host generator: chain seed, data order (explicit, never global)
        self.gen = torch.Generator().manual_seed(int(seed))
        self.chain_seed = int(torch.randint(0, 2 ** 62, (),
                                            generator=self.gen))
        if augment_fn is not None:
            self._aug_seed = int(torch.randint(0, 2 ** 62, (),
                                               generator=self.gen))
            self._aug_gen = torch.Generator(device=self.device)
        self.kernel = self._make_kernel()
        self.chain = self.kernel.init(self.model.params(), self.chain_seed,
                                      **self._init_kwargs())
        self._samples: Dict[str, list] = {}
        self._sample_steps: list = []
        self._initial_potential = 0.0
        self._total_energy = 0.0

    # -- kernel factory ----------------------------------------------------
    def _make_kernel(self):
        assert self.reject_samples is False, "SGLD cannot reject samples"
        return mcmc.SGLD(num_data=self.eff_num_data, momentum=self.momentum,
                         packing=self.packing)

    def _init_kwargs(self):
        return {}

    # -- one minibatch -----------------------------------------------------
    def _augment(self, xb, step):
        """this step's augmentation (runner.py:180-185): its generator is
        re-seeded from the runner's seed and the global step"""
        self._aug_gen.manual_seed((self._aug_seed + int(step)) % 2 ** 63)
        return self.augment_fn(xb, self._aug_gen)

    def _value_grad_of_batch(self, position, xb, yb, aug_step=None):
        """(potential_avg, aux, packed clipped gradient). The model sees
        views of a detached copy of `position` (of its buffer, for a
        segmented state), so the gradient comes back packed; batchnorm
        buffers are updated in place (train mode). With `aug_step` (a
        minibatch step's index), the batch is augmented."""
        if self.augment_fn is not None and aug_step is not None:
            xb = self._augment(xb, aug_step)
        pk = self.kernel.packer
        theta, params = pk.differentiable(position)
        fn = self.model.potential_avg_fn(xb, yb, self.eff_num_data,
                                         train=True,
                                         compute_dtype=self.compute_dtype)
        pot, aux = fn(params)
        g, = torch.autograd.grad(pot, theta)
        aux = {k: v.detach() for k, v in aux.items()}
        return pot.detach(), aux, vclip(pk.wrap_grad(g, position),
                                        -self.grad_max, self.grad_max)

    def _plain_step(self, idx, step, temperature):
        "one minibatch transition (kernel mid-step) + its metrics"
        pot, aux, g = self._value_grad_of_batch(
            self.chain.position, self.train_x[idx], self.train_y[idx],
            aug_step=step)
        lr = self.learning_rate * self.schedule(step)
        calc = self.metrics_saver is not None
        self.chain, km = self.kernel.step(self.chain, g, lr, temperature,
                                          calc_metrics=calc)
        metrics = {"loss": aux["loss"], "acc": aux["acc"],
                   "log_prior": aux["log_prior"], "potential": pot, "lr": lr}
        if calc:
            pk = self.kernel.packer
            metrics["est_temperature"] = pk.pack_leaf_scalars(
                km["est_temperature"])
            metrics["est_config_temp"] = pk.pack_leaf_scalars(
                km["est_config_temp"])
        return metrics

    # -- epoch orchestration ----------------------------------------------
    def _epoch_perm(self, cycle, epoch):
        return torch.randperm(self.N, generator=self.gen)

    def _perm_on_device(self, cycle, epoch):
        return torch.as_tensor(np.asarray(self._epoch_perm(cycle, epoch)),
                               dtype=torch.long).to(self.device)

    def _is_sampling_epoch(self, epoch):
        epoch = epoch % self.epochs_per_cycle
        sampling_epoch = epoch - (self.descent_epochs + self.warmup_epochs)
        return (0 <= sampling_epoch) and (sampling_epoch % self.skip == 0)

    def _run_epoch(self, cycle, epoch, step, boundary):
        """one epoch (runner.py:266-325); returns (new_step, per-step
        metrics, boundary metrics). `boundary` marks that the first
        minibatch performs the runner's boundary transition."""
        temperature = 0.0 if epoch < self.descent_epochs else self.temperature
        perm = self._perm_on_device(cycle, epoch)
        B = self.batch_size
        ms, bm, start = [], None, 0
        if boundary is not None:
            m, bm = self._boundary(step, perm[:B], temperature, boundary)
            ms.append(m)
            step += 1
            start = 1
        for b in range(start, self.n_full):
            ms.append(self._plain_step(perm[b * B:(b + 1) * B], step,
                                       temperature))
            step += 1
        if self.tail:
            ms.append(self._plain_step(perm[self.n_full * B:], step,
                                       temperature))
            step += 1
        return step, ms, bm

    def _boundary(self, step, idx, temperature, kind):
        "plain SGLD has no boundary transitions; run a normal step"
        return self._plain_step(idx, step, temperature), {
            "rejected": None, "delta_energy": None, "total_energy": None}

    # -- checkpoint / resume (io/checkpoint.py) ------------------------------
    def _checkpoint_parts(self):
        "(chain state, model buffers, generators) that a checkpoint holds"
        return (self.chain, dict(self.model.named_buffers()),
                {"runner": self.gen, **self.chain.generators()})

    def _checkpoint_due(self, e):
        return (self.checkpoint_path is not None
                and self.checkpoint_every is not None
                and (e + 1) % self.checkpoint_every == 0)

    def save_checkpoint(self, path, next_epoch_index, step, extra=None):
        "the whole runner state, to resume at epoch `next_epoch_index`"
        meta = {"next_epoch_index": int(next_epoch_index), "step": int(step),
                "initial_potential": float(self._initial_potential),
                "total_energy": float(self._total_energy),
                "chain_seed": self.chain_seed}
        if self.augment_fn is not None:
            meta["aug_seed"] = self._aug_seed
        meta.update(extra or {})
        state, buffers, gens = self._checkpoint_parts()
        save_chain_checkpoint(path, state.state_arrays(), buffers, gens, meta)

    def restore_checkpoint(self, path):
        """the whole runner state from `path`; returns (next_epoch_index,
        step). The metadata stays in `self._ckpt_meta` for the subclasses'
        fields."""
        return self._restore_meta(
            restore_chain_checkpoint(path, *self._checkpoint_parts()))

    def _restore_meta(self, meta):
        "the loop metadata of a checkpoint; returns (next_epoch_index, step)"
        self._initial_potential = float(meta["initial_potential"])
        self._total_energy = float(meta["total_energy"])
        if "chain_seed" in meta:
            self.chain_seed = int(meta["chain_seed"])
        if "aug_seed" in meta and self.augment_fn is not None:
            self._aug_seed = int(meta["aug_seed"])
        self._ckpt_meta = meta
        return int(meta["next_epoch_index"]), int(meta["step"])

    # -- public API ----------------------------------------------------------
    def run(self, progressbar=False, resume_from=None):
        """all epochs, then the final boundary step that logs the last
        sample's metrics (runner.py:357-407). With `resume_from` (see
        `resume_point`) the run continues where the checkpoint left off."""
        step = start_e = 0
        if resume_from is not None:
            start_e, step = resume_point(self, resume_from)
        else:
            # initial momentum refresh at self.temperature, even when the
            # first epochs are descent (T=0) epochs (reference
            # inference.py:94,120)
            self.chain = self.kernel.sample_momentum(self.chain,
                                                     self.temperature)
        total_epochs = self.cycles * self.epochs_per_cycle
        for e in range(start_e, total_epochs):
            cycle, epoch = divmod(e, self.epochs_per_cycle)
            boundary = None
            if e == 0:
                boundary = "first"
            elif self._is_sampling_epoch(epoch - 1):
                boundary = "sample"
            step = self._finish_epoch(cycle, epoch, step, boundary,
                                      e if progressbar else None)
            if self._checkpoint_due(e):
                self.save_checkpoint(self.checkpoint_path, e + 1, step)
        perm = self._perm_on_device(self.cycles, 0)
        idx = perm[:self.batch_size]
        boundary = "sample" if self._is_sampling_epoch(-1) else None
        if boundary:
            m, bm = self._boundary(step, idx, self.temperature, boundary)
        else:
            m, bm = self._plain_step(idx, step, self.temperature), None
        self._log_metrics(step, [m], bm, corresponds_to_sample=bool(boundary))
        if self.metrics_saver is not None:
            self.metrics_saver.flush()

    def _finish_epoch(self, cycle, epoch, step, boundary, progress_e=None):
        "an epoch and its host work (runner.py:409-434)"
        step0 = step
        t0 = time.perf_counter()
        step, ms, bm = self._run_epoch(cycle, epoch, step, boundary)
        pots = torch.stack([m["potential"] for m in ms]).cpu().numpy()
        epoch_s = time.perf_counter() - t0
        if not np.all(np.isfinite(pots)):
            raise ValueError("Potential is NaN")
        self._log_metrics(step0, ms, bm,
                          corresponds_to_sample=(boundary is not None))
        if self.metrics_saver is not None:
            # after _log_metrics: the saver's step cursor is monotone
            self.metrics_saver.add_scalar("timings/epoch_s", epoch_s,
                                          step - 1)
            self.metrics_saver.add_scalar(
                "timings/steps_per_s", (step - step0) / max(epoch_s, 1e-9),
                step - 1)
        if self.precond_update is not None and \
                epoch % self.precond_update == 0:
            self.chain = self.kernel.update_preconditioner(self.chain)
        if self._is_sampling_epoch(epoch):
            self._save_sample(step - 1)
        self._evaluate_and_log(step - 1)
        if self.metrics_saver is not None:
            self.metrics_saver.flush(every_s=10, keep_last_row=True)
        if progress_e is not None:
            progress(progress_e, self.cycles * self.epochs_per_cycle,
                     epoch_s, float(pots[-1]))
        return step

    # -- samples -----------------------------------------------------------
    def current_state_dict(self):
        "params + model buffers as numpy, like the reference state_dict"
        params = self.kernel.params_of(self.chain)
        out = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
        out.update({k: v.detach().cpu().numpy().copy()
                    for k, v in self.model.named_buffers()})
        return out

    def _save_sample(self, step):
        sd = self.current_state_dict()
        if self.model_saver is None:
            for k, v in sd.items():
                self._samples.setdefault(k, []).append(v)
            self._sample_steps.append(step)
        else:
            self.model_saver.add_state_dict(sd, step)
            self.model_saver.flush()

    def get_samples(self, keep_steps=False):
        if self.model_saver is not None:
            return self.model_saver.load_samples(keep_steps=keep_steps)
        out = {k: np.stack(v) for k, v in self._samples.items()}
        if keep_steps:
            out["steps"] = np.asarray(self._sample_steps)
        return out

    # -- evaluation --------------------------------------------------------
    def _evaluate_and_log(self, step):
        if self.test_x is None:
            return {}
        acc, lp = self._eval_current()
        if self.metrics_saver is not None:
            self.metrics_saver.add_scalar("test/loss", -lp, step)
            self.metrics_saver.add_scalar("test/acc", acc, step)
        return {"test/acc": acc, "test/loss": -lp}

    @torch.no_grad()
    def _eval_current(self):
        """(accuracy, mean log-likelihood) on the test set with the running
        batchnorm statistics. Batches of `eval_batch_size` plus a ragged
        last batch of its true size (eager: no padding needed)."""
        params = self.kernel.params_of(self.chain)
        n = self.test_x.shape[0]
        B = self.eval_batch_size
        lp = acc = 0.0
        for s in range(0, n, B):
            xb, yb = self.test_x[s:s + B], self.test_y[s:s + B]
            f = self.model.net_apply(params, xb, train=False)
            lp = lp + self.model.likelihood_log_prob(f, yb, params).sum()
            acc = acc + self.model.acc_fn(f, yb).sum()
        return float(acc) / n, float(lp) / n

    # -- metric logging ----------------------------------------------------
    def _log_metrics(self, step0, ms, boundary_metrics,
                     corresponds_to_sample=False):
        """one epoch's per-step rows (runner.py:510-566): step t's metrics
        under index t-1, every `metrics_skip` steps and always the epoch's
        first; the boundary's ΔE row first, at step0-1"""
        if self.metrics_saver is None:
            return
        add = self.metrics_saver.add_scalar
        pk = self.kernel.packer
        names, sizes = pk.names, np.asarray(pk.sizes, dtype=np.float64)
        keys = ["loss", "acc", "log_prior", "potential", "lr",
                "est_temperature", "est_config_temp"]
        if "de_wo_pot" in ms[0]:
            keys.append("de_wo_pot")
        rows = host_rows(ms, keys)
        precond = self.kernel.leaf_precond(self.chain).cpu().numpy()
        bm = boundary_metrics
        if bm:
            li = step0 - 1
            if bm.get("delta_energy") is not None:
                add("delta_energy", float(bm["delta_energy"]), li)
                add("total_energy", float(bm["total_energy"]), li)
            if bm.get("rejected") is not None:
                add("acceptance/rejected", int(bm["rejected"]), li)
        est_t, est_c = rows["est_temperature"], rows["est_config_temp"]
        for i in range(len(ms)):
            step = step0 + i
            if (step % self.metrics_skip != 0) and i != 0:
                continue
            li = step - 1
            for j, name in enumerate(names):
                add("preconditioner/" + name, float(precond[j]), li)
                add("est_temperature/" + name, float(est_t[i, j]), li)
                add("est_config_temp/" + name, float(est_c[i, j]), li)
            add("est_temperature/all",
                float((est_t[i] * sizes).sum() / sizes.sum()), li)
            add("est_config_temp/all",
                float((est_c[i] * sizes).sum() / sizes.sum()), li)
            add("temperature", float(self.temperature), li)
            for k in ("loss", "acc", "log_prior", "potential", "lr"):
                add(k, float(rows[k][i]), li)
            add("acceptance/is_sample",
                int(corresponds_to_sample and i == 0), li)
            # the reference's per-step energy drift passes `loss`, not the
            # potential (inference.py:352-354); the boundary row's ΔE was
            # logged above
            if "de_wo_pot" in rows and not (bm and i == 0):
                de_i = float(rows["de_wo_pot"][i]) + (
                    float(rows["loss"][i]) - self._initial_potential
                ) * self.kernel.num_data
                add("delta_energy", de_i, li)
                add("total_energy", self._total_energy + de_i, li)


class VerletSGLDRunner(SGLDRunner):
    "GGMC runner with three-phase boundaries (reference inference.py:297-365)."

    def _make_kernel(self):
        return mcmc.VerletSGLD(num_data=self.eff_num_data,
                               momentum=self.momentum, packing=self.packing)

    def _init_kwargs(self):
        return {"save_state": self.reject_samples}

    def _plain_step(self, idx, step, temperature):
        """Intermediate GGMC step + the potential-free part of the running
        ΔE (reference inference.py:352-354), when metrics are logged. An
        SGLD kernel (`SGLDRunnerReject`) carries no energy accumulator."""
        metrics = super()._plain_step(idx, step, temperature)
        if self.metrics_saver is not None and \
                isinstance(self.kernel, mcmc.VerletSGLD):
            metrics["de_wo_pot"] = self.chain.delta_energy_acc + \
                self.kernel._point_energy(self.chain, self.chain.grads,
                                          metrics["lr"])
        return metrics

    def _is_hmc(self):
        return isinstance(self.kernel, mcmc.HMC)

    def _boundary(self, step, idx, temperature, kind):
        """kind='first': the very first step is an initial_step.
        kind='sample': final_step + ΔE (+ maybe_reject) + initial_step,
        reusing this minibatch's gradient (runner.py:597-683). HMC draws a
        fresh momentum before either initial_step. Boundary minibatches are
        not augmented, as in the JAX package."""
        pot, aux, g = self._value_grad_of_batch(
            self.chain.position, self.train_x[idx], self.train_y[idx])
        lr = self.learning_rate * self.schedule(step)
        calc = self.metrics_saver is not None
        if kind == "first":
            if self._is_hmc():
                self.chain = self.kernel.sample_momentum(self.chain,
                                                         temperature)
            self.chain, km = self.kernel.initial_step(
                self.chain, g, lr, temperature,
                save_state=self.reject_samples, calc_metrics=calc)
            de = self.kernel.delta_energy(self.chain, g, lr, 0.0, 0.0)
            self._initial_potential = float(pot)
            self._total_energy = 0.0
            bm = {"delta_energy": float(de), "total_energy": 0.0,
                  "rejected": (False if self.reject_samples else None)}
            return self._metric_dict(pot, aux, lr, km, g, calc), bm
        self.chain, km = self.kernel.final_step(self.chain, g, lr,
                                                temperature,
                                                calc_metrics=calc)
        de = float(self.kernel.delta_energy(self.chain, g, lr,
                                            self._initial_potential, pot))
        rejected = False
        if self.reject_samples:
            self.chain, rejected, _ = self.kernel.maybe_reject(
                self.chain, de, temperature,
                flip_on_reject=self.flip_on_reject)
        if self._is_hmc():  # a new trajectory
            self.chain = self.kernel.sample_momentum(self.chain, temperature)
        # initial step from the same gradient (possibly rolled back)
        self.chain, _ = self.kernel.initial_step(
            self.chain, self.chain.grads, lr, temperature,
            save_state=self.reject_samples, calc_metrics=False)
        # base potential for the next segment's ΔE: after a rejection the
        # chain is back at the saved state, whose potential is the OLD one
        # (the reference overwrites it, inference.py:344-346; fixed
        # deliberately, as in the JAX package)
        if not rejected:
            self._initial_potential = float(pot)
        self._total_energy += de
        bm = {"delta_energy": de, "total_energy": self._total_energy,
              "rejected": (rejected if self.reject_samples else None)}
        return self._metric_dict(pot, aux, lr, km, self.chain.grads,
                                 calc), bm

    def _metric_dict(self, pot, aux, lr, km, g=None, calc=True):
        out = {"loss": aux["loss"], "acc": aux["acc"],
               "log_prior": aux["log_prior"], "potential": pot, "lr": lr}
        if not calc:
            return out
        pk = self.kernel.packer
        out["est_temperature"] = pk.pack_leaf_scalars(km["est_temperature"])
        out["est_config_temp"] = pk.pack_leaf_scalars(km["est_config_temp"])
        if g is not None:
            # the key of _plain_step's rows; the boundary row's logged ΔE
            # comes from the boundary metrics instead
            out["de_wo_pot"] = self.chain.delta_energy_acc + \
                self.kernel._point_energy(self.chain, g, lr)
        return out


class HMCRunner(VerletSGLDRunner):
    """HMC without an M-H test (`inference=OurHMC`): each sampling epoch is
    a leapfrog trajectory of minibatch gradients, with a fresh momentum at
    every boundary (runner.py:702-708)."""

    def _make_kernel(self):
        assert self.temperature == 1.0, \
            "HMC only implemented for temperature=1."
        assert self.momentum == 1.0, "HMC only works with momentum=1."
        assert self.descent_epochs == 0, \
            "HMC not implemented for descent epochs with temp=0."
        return mcmc.HMC(num_data=self.eff_num_data, packing=self.packing)
