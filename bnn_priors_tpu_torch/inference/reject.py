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
are read on the host once per boundary.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..mcmc.segmented import vclip
from .runner import VerletSGLDRunner


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
    multichain.py:1070-1089), and every value gains a leading chain axis."""
    dt = position.dtype
    lead = tuple(position.shape[:-1])
    g_acc = torch.zeros_like(position)
    loss_acc = torch.zeros(lead, dtype=dt, device=position.device)
    acc_acc = torch.zeros(lead, dtype=dt, device=position.device)

    def batch(xb, yb):
        nonlocal g_acc, loss_acc, acc_acc
        if buffers is not None:  # the same batch for every chain
            xb, yb = xb.expand(*lead, *xb.shape), yb.expand(*lead, *yb.shape)
        theta = position.detach().requires_grad_()
        ll, f = model.log_likelihood(kernel.unpack(theta), xb, yb, 1.0,
                                     train=True, buffers=buffers)
        this_loss = -ll * (yb.shape[-1] / eff_num_data)
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

    theta = position.detach().requires_grad_()
    log_norm_prior = model.log_prior(kernel.unpack(theta)) / -eff_num_data
    g_prior, = torch.autograd.grad(log_norm_prior.sum(), theta)
    log_norm_prior = log_norm_prior.detach()
    log_prior = -log_norm_prior * eff_num_data
    grads = vclip(g_acc + g_prior, -grad_max, grad_max)
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
        "initial_step with the same exact gradient (possibly rolled back)"
        lr = self.learning_rate * self.schedule(lr_index)
        self.chain, _ = self.kernel.initial_step(
            self.chain, self.chain.grads, lr, temperature,
            save_state=self.reject_samples,
            calc_metrics=False)

    # -- main loop ---------------------------------------------------------
    def run(self):
        mstep = 0  # metrics step counter (batches + boundaries)
        lr_index = 0
        # host records of the run: per-step minibatch potentials (read once
        # per epoch, with the NaN check), one row per M-H boundary, and the
        # latest test-set evaluation
        self.potentials, self.boundaries, self.last_eval = [], [], {}
        self._precond_pending = False  # precond update owed to next boundary
        # initial exact-gradient step (inference_reject.py:56-66)
        loss, log_prior, pot, acc, grads = self._exact_vg()
        self.chain = self.kernel.sample_momentum(self.chain, self.temperature)
        lr0 = self.learning_rate * self.schedule(0)
        calc = self.metrics_saver is not None
        self.chain, km = self.kernel.initial_step(
            self.chain, grads, lr0, self.temperature,
            save_state=self.reject_samples, calc_metrics=calc)
        self._initial_potential = float(pot)
        self._total_energy = 0.0
        self._log_row(mstep, {
            "loss": loss, "log_prior": log_prior, "potential": pot,
            "acc": acc, "lr": lr0,
        }, km, corresponds_to_sample=True, delta_energy=0.0,
            total_energy=0.0,
            rejected=(False if self.reject_samples else None))

        for e in range(self.cycles * self.epochs_per_cycle):
            cycle, epoch = divmod(e, self.epochs_per_cycle)
            t_epoch = time.time()
            temperature = (0.0 if epoch < self.descent_epochs
                           else self.temperature)
            perm = torch.as_tensor(np.asarray(self._epoch_perm(cycle, epoch)),
                                   dtype=torch.long).to(self.device)
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
        if self.metrics_saver is not None:
            self.metrics_saver.flush()

    # -- logging helpers (only with a metrics_saver) ------------------------
    def _log_row(self, index, scalars, km, corresponds_to_sample,
                 delta_energy=None, total_energy=None, rejected=None):
        if self.metrics_saver is None:
            return
        add = self.metrics_saver.add_scalar
        pk = self.kernel.packer
        if km:
            precond = self.kernel.leaf_precond(self.chain).cpu().numpy()
            est_t = km["est_temperature"]
            est_c = km["est_config_temp"]
            if isinstance(est_t, dict):
                est_t = pk.pack_leaf_scalars(est_t)
                est_c = pk.pack_leaf_scalars(est_c)
            est_t, est_c = est_t.cpu().numpy(), est_c.cpu().numpy()
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
        if self.metrics_saver is None:
            return
        for i, m in enumerate(ms):
            index = base_index + i
            if index % self.metrics_skip != 0:
                continue
            # reference inference.py:352-354: per-step energy drift within
            # the current segment, using `loss` as the potential
            de_i = float(m["de_wo_pot"]) + (
                float(m["loss"]) - self._initial_potential
            ) * self.kernel.num_data
            self._log_row(
                index,
                {k: m[k] for k in ("loss", "log_prior", "potential", "acc",
                                   "lr")},
                {"est_temperature": m["est_temperature"],
                 "est_config_temp": m["est_config_temp"]},
                corresponds_to_sample=False, delta_energy=de_i,
                total_energy=self._total_energy + de_i)
