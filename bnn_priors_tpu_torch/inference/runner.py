"""Cyclical SG-MCMC runners: the parts of `SGLDRunner`/`VerletSGLDRunner`
(counterpart of `bnn_priors_tpu/inference/runner.py`) that the
exact-gradient reject runner (`reject.py`) builds on.

Each cycle has descent (T=0), warmup and sampling phases with a cosine LR
schedule. The training set lives on the device; an epoch is a Python loop
over minibatches gathered there (the JAX package's jitted `lax.scan`
becomes that loop), with a ragged tail batch of its true size so likelihood
scaling and batchnorm statistics match. The LR schedule is a host float of
the global step index, so a step needs no device sync; the potentials of an
epoch are read once, at its end, for the NaN check.

Protocol parity notes:
* scheduler order: global step t uses lr₀·sched(t) with sched(0)=1.
* samples are kept in memory (`get_samples`); HDF5 savers, checkpoints,
  profiling, augmentation and the non-reject `run()` loops are not ported.
* `metrics_saver` is an optional hook with the JAX package's
  `add_scalar(name, value, step)`/`flush(...)` interface; the per-step
  kernel diagnostics it logs are computed only when it is set.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import mcmc
from ..device import resolve_device
from ..mcmc.segmented import vclip
from .schedules import make_schedule


class SGLDRunner:
    def __init__(self, model, train_data, test_data, epochs_per_cycle,
                 warmup_epochs, sample_epochs, learning_rate=1e-2, skip=1,
                 metrics_skip=1, temperature=1.0, data_mult=1.0, momentum=0.0,
                 sampling_decay=True, grad_max=1e6, cycles=1,
                 precond_update=None, metrics_saver=None,
                 reject_samples=False, flip_on_reject=False,
                 batch_size=128, eval_batch_size=None, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = None, device="cuda"):
        self.device = resolve_device(device)
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
        self.reject_samples = reject_samples
        # GHMC momentum-flip correction on rejection (the reference never
        # flips)
        self.flip_on_reject = flip_on_reject
        self.batch_size = int(batch_size)
        self.eval_batch_size = int(eval_batch_size or batch_size)
        # e.g. torch.bfloat16: run the net forward/backward in reduced
        # precision (params+inputs cast down, likelihood/prior reductions
        # stay in the parameter dtype) — models/base.py log_likelihood
        self.compute_dtype = compute_dtype

        self.n_full = self.N // self.batch_size
        self.tail = self.N - self.n_full * self.batch_size
        self.steps_per_epoch = self.n_full + (1 if self.tail else 0)
        self.schedule = make_schedule(
            sampling_decay, self.steps_per_epoch * epochs_per_cycle,
            steps_per_stair=150 * self.steps_per_epoch)

        # host generator: chain seed, data order (explicit, never global)
        self.gen = torch.Generator().manual_seed(int(seed))
        chain_seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen))
        self.kernel = self._make_kernel()
        self.chain = self.kernel.init(self.model.params(), chain_seed,
                                      **self._init_kwargs())
        self._samples: Dict[str, list] = {}
        self._sample_steps: list = []
        self._initial_potential = 0.0
        self._total_energy = 0.0

    # -- kernel factory ----------------------------------------------------
    def _make_kernel(self):
        assert self.reject_samples is False, "SGLD cannot reject samples"
        return mcmc.SGLD(num_data=self.eff_num_data, momentum=self.momentum)

    def _init_kwargs(self):
        return {}

    # -- one minibatch -----------------------------------------------------
    def _value_grad_of_batch(self, position, xb, yb):
        """(potential_avg, aux, packed clipped gradient). The model sees
        views of a detached copy of `position`, so the gradient comes back
        packed; batchnorm buffers are updated in place (train mode)."""
        theta = position.detach().requires_grad_()
        fn = self.model.potential_avg_fn(xb, yb, self.eff_num_data,
                                         train=True,
                                         compute_dtype=self.compute_dtype)
        pot, aux = fn(self.kernel.unpack(theta))
        g, = torch.autograd.grad(pot, theta)
        aux = {k: v.detach() for k, v in aux.items()}
        return pot.detach(), aux, vclip(g, -self.grad_max, self.grad_max)

    def _plain_step(self, idx, step, temperature):
        "one minibatch transition (kernel mid-step) + its metrics"
        pot, aux, g = self._value_grad_of_batch(
            self.chain.position, self.train_x[idx], self.train_y[idx])
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

    def _is_sampling_epoch(self, epoch):
        epoch = epoch % self.epochs_per_cycle
        sampling_epoch = epoch - (self.descent_epochs + self.warmup_epochs)
        return (0 <= sampling_epoch) and (sampling_epoch % self.skip == 0)

    # -- samples -----------------------------------------------------------
    def current_state_dict(self):
        "params + model buffers as numpy, like the reference state_dict"
        params = self.kernel.params_of(self.chain)
        out = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
        out.update({k: v.detach().cpu().numpy().copy()
                    for k, v in self.model.named_buffers()})
        return out

    def _save_sample(self, step):
        for k, v in self.current_state_dict().items():
            self._samples.setdefault(k, []).append(v)
        self._sample_steps.append(step)

    def get_samples(self, keep_steps=False):
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
            lp = lp + self.model.likelihood_log_prob(f, yb).sum()
            acc = acc + self.model.acc_fn(f, yb).sum()
        return float(acc) / n, float(lp) / n


class VerletSGLDRunner(SGLDRunner):
    "GGMC runner pieces (reference inference.py:297-365)."

    def _make_kernel(self):
        return mcmc.VerletSGLD(num_data=self.eff_num_data,
                               momentum=self.momentum)

    def _init_kwargs(self):
        return {"save_state": self.reject_samples}

    def _plain_step(self, idx, step, temperature):
        """Intermediate GGMC step + the potential-free part of the running
        ΔE (reference inference.py:352-354), when metrics are logged."""
        metrics = super()._plain_step(idx, step, temperature)
        if self.metrics_saver is not None:
            metrics["de_wo_pot"] = self.chain.delta_energy_acc + \
                self.kernel._point_energy(self.chain, self.chain.grads,
                                          metrics["lr"])
        return metrics

    def _metric_dict(self, pot, aux, lr, km):
        pk = self.kernel.packer
        return {
            "loss": aux["loss"], "acc": aux["acc"],
            "log_prior": aux["log_prior"], "potential": pot, "lr": lr,
            "est_temperature": pk.pack_leaf_scalars(km["est_temperature"]),
            "est_config_temp": pk.pack_leaf_scalars(km["est_config_temp"]),
        }
