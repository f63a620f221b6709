"""GGMC with exact-gradient Metropolis–Hastings boundaries — the paper's
main algorithm (`inference=VerletSGLDReject`; counterpart of
`bnn_priors_tpu/inference/reject.py`, arXiv:2102.01691).

Differences from the plain `VerletSGLDRunner`:
* the proposal's initial and final gradients are **exact full-dataset
  gradients** (`exact_potential_and_grad`): one pass over all minibatches
  plus the tail, accumulating per-batch gradients (sum of gradients ==
  gradient of the sum, with constant memory);
* the M-H boundary happens at the END of each sampling epoch, so saved
  samples are already correctly rolled back;
* minibatch order is FIXED per cycle: every epoch within a cycle visits the
  data in the same order (one permutation per cycle);
* the LR schedule advances once per minibatch; the epoch's last minibatch,
  the exact `final_step`, ΔE and the M-H decision share one LR value, and
  the follow-up `initial_step` uses the next.

Each sampling-epoch boundary costs 2 extra full-dataset passes (the exact
gradient, then the test-set evaluation) and two fused-update launches
(final and initial step). ΔE, the M-H decision and the next base potential
are read on the host once per boundary. The minibatch steps are augmented
when the runner has an `augment_fn`; the exact gradient never is.

`SGLDRunnerReject` runs the same protocol with the SGLD kernel, which
cannot reject (ΔE = ∞). `HMCRunnerReject` runs it with the HMC kernel,
drawing a fresh momentum before every boundary's initial step: HMC with
exact-gradient trajectory ends and an exact M-H test (`inference=
HMCReject`; with the batch size N, classical HMC, `inference=HMC`).

Checkpoints (`checkpoint_path`, `checkpoint_every`, `run(resume_from=)`)
are written after the epoch's boundary and evaluation and hold, beside the
base runner's state, the fixed order's seed and the M-H loop's counters
(reject.py:106-121,209-218,356-360).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import mcmc
from ..mcmc.segmented import vclip
from .runner import (HMCRunner, VerletSGLDRunner, host_rows, progress,
                     resume_point)


def exact_potential_and_grad(model, kernel, position, tx, ty, *, n_full,
                             batch_size, tail, N, eff_num_data, grad_max,
                             buffers=None):
    """Exact full-dataset potential + packed gradient
    (reference `_exact_model_potential_and_grad`, inference_reject.py:18-33):
    one loop over all full batches (+ tail) accumulating per-batch
    gradients, in train mode, so the batchnorm running statistics are
    threaded through every batch. Returns (loss, log_prior, potential, acc,
    grads) as device tensors.

    With `buffers` ({name: (K, ...)}, the chains' batchnorm state),
    `position` is a (K, T) bank: the K chains sweep the training set
    together, every batch once for all of them (the vmapped sweep of
    multichain.py:1070-1089), and every value gains a leading chain axis.
    A segmented state's gradient is taken with respect to its buffer and
    comes back in the state's packing."""
    pk = kernel.packer
    dt = position.dtype
    lead = pk.lead_of(position)
    g_acc = 0.0
    loss_acc = torch.zeros(lead, dtype=dt, device=position.device)
    acc_acc = torch.zeros(lead, dtype=dt, device=position.device)

    def batch(xb, yb):
        nonlocal g_acc, loss_acc, acc_acc
        if buffers is not None:  # the same batch for every chain
            xb, yb = xb.expand(*lead, *xb.shape), yb.expand(*lead, *yb.shape)
        theta, params = pk.differentiable(position)
        ll, f = model.log_likelihood(params, xb, yb, 1.0,
                                     train=True, buffers=buffers)
        this_loss = -ll * (yb.shape[len(lead)] / eff_num_data)
        if this_loss.requires_grad:  # else a model with no data term
            g, = torch.autograd.grad(this_loss.sum(), theta)
            g_acc = g_acc + g
        loss_acc = loss_acc + this_loss.detach().to(dt)
        acc_acc = acc_acc + model.acc_fn(f.detach(), yb).sum(-1).to(dt)

    for b in range(n_full):
        s = slice(b * batch_size, (b + 1) * batch_size)
        batch(tx[s], ty[s])
    if tail:
        batch(tx[n_full * batch_size:N], ty[n_full * batch_size:N])

    theta, params = pk.differentiable(position)
    log_norm_prior = model.log_prior(params) / -eff_num_data
    g_prior, = torch.autograd.grad(log_norm_prior.sum(), theta)
    log_norm_prior = log_norm_prior.detach()
    log_prior = -log_norm_prior * eff_num_data
    grads = vclip(pk.wrap_grad(g_acc + g_prior, position), -grad_max,
                  grad_max)
    potential = loss_acc + log_norm_prior
    return loss_acc, log_prior, potential, acc_acc / N, grads


class VerletSGLDRunnerReject(VerletSGLDRunner):
    # -- per-cycle fixed data order ---------------------------------------
    def _epoch_perm(self, cycle, epoch):
        "one permutation per cycle, drawn from a per-runner base seed"
        if not hasattr(self, "_perm_seed"):
            self._perm_seed = int(torch.randint(0, 2 ** 62, (),
                                                generator=self.gen))
        gen = torch.Generator().manual_seed(self._perm_seed + int(cycle))
        return torch.randperm(self.N, generator=gen)

    # -- checkpoint extras ---------------------------------------------------
    def save_checkpoint(self, path, next_epoch_index, step, extra=None):
        extra = dict(extra or {})
        extra["precond_pending"] = getattr(self, "_precond_pending", False)
        if hasattr(self, "_perm_seed"):
            # drawn lazily: kept so that a resumed run visits the data in
            # the same order
            extra["perm_seed"] = self._perm_seed
        super().save_checkpoint(path, next_epoch_index, step, extra)

    def _restore_meta(self, meta):
        if "perm_seed" in meta:
            self._perm_seed = int(meta["perm_seed"])
        self._precond_pending = bool(meta.get("precond_pending", False))
        return super()._restore_meta(meta)

    # -- exact full-dataset gradient --------------------------------------
    def _exact_vg(self):
        """(loss, log_prior, potential, acc, grads) at the chain's position,
        with loss = Σ_batches −ll(batch)/N and potential = loss −
        log_prior/N."""
        return exact_potential_and_grad(
            self.model, self.kernel, self.chain.position, self.train_x,
            self.train_y, n_full=self.n_full, batch_size=self.batch_size,
            tail=self.tail, N=self.N, eff_num_data=self.eff_num_data,
            grad_max=self.grad_max)

    # -- boundary pieces ---------------------------------------------------
    def _boundary_final(self, lr_index, temperature):
        """exact vg → final_step → ΔE → maybe_reject; returns host scalars
        (pot, ΔE, rejected, next base potential) and the boundary metrics"""
        loss, log_prior, pot, acc, grads = self._exact_vg()
        lr = self.learning_rate * self.schedule(lr_index)
        calc = self.metrics_saver is not None
        self.chain, km = self.kernel.final_step(self.chain, grads, lr,
                                                temperature,
                                                calc_metrics=calc)
        de = self.kernel.delta_energy(self.chain, grads, lr,
                                      self._initial_potential, pot)
        if self.reject_samples:
            self.chain, rejected, _ = self.kernel.maybe_reject(
                self.chain, de, temperature,
                flip_on_reject=self.flip_on_reject)
        else:
            rejected = False
        pot_f, de_f = float(pot), float(de)
        # base potential for the NEXT segment's ΔE: on rejection the chain
        # is rolled back to the saved state, whose potential is the OLD
        # initial_potential. (The reference always uses the proposal's
        # potential here, inference_reject.py:123, which biases the
        # acceptance test of the segment after a rejection; fixed
        # deliberately, as in the JAX package.)
        next_pot = self._initial_potential if rejected else pot_f
        metrics = (self._metric_dict(pot, {"loss": loss, "acc": acc,
                                           "log_prior": log_prior}, lr, km)
                   if calc else None)
        return metrics, de_f, rejected, next_pot

    def _boundary_initial(self, lr_index, temperature):
        """(HMC momentum refresh +) initial_step with the same exact
        gradient (possibly rolled back)"""
        lr = self.learning_rate * self.schedule(lr_index)
        if self._is_hmc():
            self.chain = self.kernel.sample_momentum(self.chain, temperature)
        self.chain, _ = self.kernel.initial_step(
            self.chain, self.chain.grads, lr, temperature,
            save_state=self.reject_samples,
            calc_metrics=False)

    # -- main loop ---------------------------------------------------------
    def run(self, progressbar=False, resume_from=None):
        """all epochs; with `resume_from` (see `runner.resume_point`) from
        where the checkpoint left off, without the initial exact step"""
        mstep = 0  # metrics step counter (batches + boundaries)
        lr_index = start_e = 0
        # host records of the run: per-step minibatch potentials (read once
        # per epoch, with the NaN check), one row per M-H boundary, and the
        # latest test-set evaluation
        self.potentials, self.boundaries, self.last_eval = [], [], {}
        self._precond_pending = False  # precond update owed to next boundary
        if resume_from is not None:
            start_e, lr_index = resume_point(self, resume_from)
            mstep = int(self._ckpt_meta.get("mstep", lr_index))
        else:
            self._initial_exact_step()
        total_epochs = self.cycles * self.epochs_per_cycle
        for e in range(start_e, total_epochs):
            cycle, epoch = divmod(e, self.epochs_per_cycle)
            t_epoch = time.time()
            temperature = (0.0 if epoch < self.descent_epochs
                           else self.temperature)
            perm = self._perm_on_device(cycle, epoch)
            ms = [self._plain_step(perm[b * self.batch_size:
                                        (b + 1) * self.batch_size],
                                   lr_index + b, temperature)
                  for b in range(self.n_full)]
            n_steps = self.n_full
            if self.tail:
                ms.append(self._plain_step(perm[self.n_full * self.batch_size:],
                                           lr_index + self.n_full,
                                           temperature))
                n_steps += 1
            pots = torch.stack([m["potential"] for m in ms]).cpu().numpy()
            if not np.all(np.isfinite(pots)):
                raise ValueError("Potential is NaN")
            self.potentials.extend(pots.tolist())
            self._log_scan_metrics(mstep + 1, ms)
            mstep += n_steps
            lr_index += n_steps

            precond_due = (self.precond_update is not None
                           and (epoch + 1) % self.precond_update == 0)
            # Deferring updates to M-H segment boundaries preserves ΔE
            # exactness, which only matters when an acceptance test exists;
            # otherwise follow the reference's per-epoch cadence
            # (inference_reject.py:167-168).
            defer_precond = self.reject_samples and self.sample_epochs > 0
            if self._is_sampling_epoch(epoch):
                mstep += 1
                metrics, de, rejected, next_pot = self._boundary_final(
                    lr_index - 1, temperature)
                self._total_energy += de
                self._initial_potential = next_pot
                self.boundaries.append({"step": mstep, "delta_energy": de,
                                        "rejected": rejected})
                if metrics is not None:
                    self._log_row(
                        mstep,
                        {k: metrics[k] for k in
                         ("loss", "log_prior", "potential", "acc", "lr")},
                        {"est_temperature": metrics["est_temperature"],
                         "est_config_temp": metrics["est_config_temp"]},
                        corresponds_to_sample=True, delta_energy=de,
                        total_energy=self._total_energy,
                        rejected=(rejected if self.reject_samples else None))
                self.last_eval = self._evaluate_and_log(mstep)
                self._save_sample(mstep)
                # When rejecting, preconditioner updates apply ONLY between
                # segments — after maybe_reject, before the next
                # initial_step — so M is constant within every M-H proposal
                # segment and ΔE is the segment's true energy change.
                if defer_precond:
                    if precond_due or self._precond_pending:
                        self.chain = self.kernel.update_preconditioner(
                            self.chain)
                        self._precond_pending = False
                elif precond_due:
                    self.chain = self.kernel.update_preconditioner(self.chain)
                self._boundary_initial(lr_index, temperature)
            else:
                self.last_eval = self._evaluate_and_log(mstep)
                if precond_due:
                    if defer_precond:
                        self._precond_pending = True  # next segment boundary
                    else:
                        self.chain = self.kernel.update_preconditioner(
                            self.chain)
            if self.metrics_saver is not None:
                epoch_s = time.time() - t_epoch
                self.metrics_saver.add_scalar("timings/epoch_s", epoch_s,
                                              mstep)
                self.metrics_saver.add_scalar(
                    "timings/steps_per_s", n_steps / max(epoch_s, 1e-9),
                    mstep)
                self.metrics_saver.flush(every_s=30, keep_last_row=True)
            if progressbar:
                progress(e, total_epochs, time.time() - t_epoch,
                         float(pots[-1]))
            if self._checkpoint_due(e):
                self.save_checkpoint(self.checkpoint_path, e + 1, lr_index,
                                     extra={"mstep": mstep})
        if self.metrics_saver is not None:
            self.metrics_saver.flush()

    def _initial_exact_step(self):
        """the exact gradient, the momentum refresh and the initial_step
        that start a run, logged at metrics step 0
        (inference_reject.py:56-66)"""
        loss, log_prior, pot, acc, grads = self._exact_vg()
        self.chain = self.kernel.sample_momentum(self.chain, self.temperature)
        lr0 = self.learning_rate * self.schedule(0)
        calc = self.metrics_saver is not None
        self.chain, km = self.kernel.initial_step(
            self.chain, grads, lr0, self.temperature,
            save_state=self.reject_samples, calc_metrics=calc)
        self._initial_potential = float(pot)
        self._total_energy = 0.0
        self._log_row(0, {
            "loss": loss, "log_prior": log_prior, "potential": pot,
            "acc": acc, "lr": lr0,
        }, km, corresponds_to_sample=True, delta_energy=0.0,
            total_energy=0.0,
            rejected=(False if self.reject_samples else None))

    # -- logging helpers (only with a metrics_saver) ------------------------
    def _log_row(self, index, scalars, km, corresponds_to_sample,
                 delta_energy=None, total_energy=None, rejected=None,
                 precond=None):
        """one metrics row (reject.py:365-396); `km`'s per-leaf diagnostics
        and `precond` may be device tensors or host arrays"""
        if self.metrics_saver is None:
            return
        add = self.metrics_saver.add_scalar
        pk = self.kernel.packer
        if km:
            host = lambda v: (v.cpu().numpy() if torch.is_tensor(v)
                              else np.asarray(v))
            if precond is None:
                precond = self.kernel.leaf_precond(self.chain)
            est_t, est_c = km["est_temperature"], km["est_config_temp"]
            if isinstance(est_t, dict):
                est_t = pk.pack_leaf_scalars(est_t)
                est_c = pk.pack_leaf_scalars(est_c)
            precond, est_t, est_c = host(precond), host(est_t), host(est_c)
            sizes = np.asarray(pk.sizes, dtype=np.float64)
            for j, name in enumerate(pk.names):
                add("preconditioner/" + name, float(precond[j]), index)
                add("est_temperature/" + name, float(est_t[j]), index)
                add("est_config_temp/" + name, float(est_c[j]), index)
            add("est_temperature/all",
                float((est_t * sizes).sum() / sizes.sum()), index)
            add("est_config_temp/all",
                float((est_c * sizes).sum() / sizes.sum()), index)
        add("temperature", float(self.temperature), index)
        for k, v in scalars.items():
            add(k, float(v), index)
        add("acceptance/is_sample", int(corresponds_to_sample), index)
        if delta_energy is not None:
            add("delta_energy", float(delta_energy), index)
            add("total_energy", float(total_energy), index)
        if rejected is not None:
            add("acceptance/rejected", int(rejected), index)

    def _log_scan_metrics(self, base_index, ms):
        """an epoch's minibatch rows (reject.py:398-425), read from the
        device in one transfer"""
        if self.metrics_saver is None:
            return
        keys = ["loss", "log_prior", "potential", "acc", "lr",
                "est_temperature", "est_config_temp"]
        if "de_wo_pot" in ms[0]:
            keys.append("de_wo_pot")
        rows = host_rows(ms, keys)
        precond = self.kernel.leaf_precond(self.chain).cpu().numpy()
        for i in range(len(ms)):
            index = base_index + i
            if index % self.metrics_skip != 0:
                continue
            de_i = total_i = None
            if "de_wo_pot" in rows:
                # reference inference.py:352-354: per-step energy drift
                # within the current segment, using `loss` as the potential
                de_i = float(rows["de_wo_pot"][i]) + (
                    float(rows["loss"][i]) - self._initial_potential
                ) * self.kernel.num_data
                total_i = self._total_energy + de_i
            self._log_row(
                index, {k: rows[k][i] for k in
                        ("loss", "log_prior", "potential", "acc", "lr")},
                {"est_temperature": rows["est_temperature"][i],
                 "est_config_temp": rows["est_config_temp"][i]},
                corresponds_to_sample=False, delta_energy=de_i,
                total_energy=total_i, precond=precond)


class HMCRunnerReject(VerletSGLDRunnerReject):
    "HMC with exact-gradient boundaries and an M-H test (reject.py:427-433)"

    _make_kernel = HMCRunner._make_kernel


class SGLDRunnerReject(VerletSGLDRunnerReject):
    "SGLD with the fixed-order protocol; cannot reject (ΔE = ∞)."

    def _make_kernel(self):
        assert not self.reject_samples, "SGLD cannot reject samples"
        return mcmc.SGLD(num_data=self.eff_num_data, momentum=self.momentum,
                         packing=self.packing)

    def _init_kwargs(self):
        return {}
