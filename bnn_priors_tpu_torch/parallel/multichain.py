"""K chains of GGMC with exact Metropolis–Hastings boundaries on one card
(counterpart of `bnn_priors_tpu/parallel/multichain.py`: the parts of
`MultiChainRunner` that `MultiChainRunnerReject` uses, then that runner,
with no mesh and all K chains in one dispatch group).

The K chains step together: their state is one `(K, T)` bank
(`mcmc.VerletSGLDChains`), every minibatch step is one forward/backward of
all K networks folded into channel groups (`models/layers.py`) on one
minibatch a chain, and one launch of the `(K, T)` fused kernel updates them
all. Temperatures are per chain (0 in descent epochs), each chain has its
own fixed minibatch order per cycle, and each chain takes its own M-H
decision at every sampling boundary, rolled back on the device.

Host reads: once an epoch (the minibatch potentials, the last step's
diagnostics and the test metrics, with the NaN check) and once a boundary
(ΔE, the decisions and the exact-pass metrics), synchronously. Not ported
here: the mesh and multi-process paths, dispatch grouping (the JAX
package's TPU-measured group rates are not carried over), the drain worker
and epoch pipelining, checkpoints, HDF5 sample and metric streaming, the
hybrid and segmented states and the HMC/SGLD kernels.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch

from .. import mcmc
from ..device import resolve_device
from ..inference.reject import exact_potential_and_grad
from ..inference.schedules import make_schedule
from ..mcmc.segmented import vclip, vsum
from .chains import init_chains_diverse, init_chains_from_fn


class MultiChainRunner:
    """Cyclical GGMC over K chains in one bank (descent/warmup/sampling
    phases, cosine cycles): construction, per-chain temperatures, the epoch
    of minibatch steps, the per-epoch test evaluation, the NaN quarantine
    and the sample bank. `MultiChainRunnerReject` adds the M-H boundaries
    and runs it.

    `init_params_fn(chain_index, generator) -> params` sets each chain's
    initial parameters (he-initialization, warm starts); by default every
    chain is an independent draw from the model's priors. The chains'
    batchnorm state starts as K copies of the model's buffers. The
    parameter dtype is the model's; `compute_dtype` (e.g. torch.bfloat16)
    runs the minibatch steps' network in reduced precision, while the exact
    boundary passes stay in the parameter dtype."""

    def __init__(self, model, train_data, n_chains, temperatures=1.0,
                 learning_rate=1e-2, momentum=0.994, sampling_decay="cosine",
                 batch_size=128, cycles=1, epochs_per_cycle=1,
                 warmup_epochs=0, sample_epochs=1, skip=1, grad_max=1e6,
                 precond_update=None, data_mult=1.0, seed: int = 0,
                 init_params_fn=None, compute_dtype=None, test_data=None,
                 eval_batch_size=None, chain_group_size=None, device="cuda"):
        if chain_group_size is not None:
            raise ValueError(
                "chain_group_size: dispatch grouping is not ported; None runs "
                "all chains as one group")
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
        # an epoch is n_full minibatch steps: no ragged tail (as JAX's scan)
        self.schedule = make_schedule(
            sampling_decay, self.n_full * epochs_per_cycle,
            steps_per_stair=150 * self.n_full)

        self.temperatures = torch.as_tensor(
            temperatures, dtype=dtype).expand(K).contiguous().to(self.device)
        # the two per-chain temperature vectors of a run (descent, sampling),
        # made once: the kernel keys its noise_std cache on them
        self._temps = (torch.zeros_like(self.temperatures), self.temperatures)

        self.kernel = mcmc.VerletSGLDChains(num_data=self.eff_num_data,
                                            momentum=momentum)
        # host generator: chain seeds and data orders (explicit, never global)
        self.gen = torch.Generator().manual_seed(int(seed))
        init_seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen))
        # with rollback slots: every chain takes an M-H test
        if init_params_fn is not None:
            self.chains = init_chains_from_fn(
                self.kernel, K, init_params_fn, init_seed,
                init_kwargs={"save_state": True})
        else:
            self.chains = init_chains_diverse(
                self.kernel, self.model, K, init_seed,
                init_kwargs={"save_state": True})
        # each chain's own batchnorm state, (K, ...) (multichain.py:153-156)
        self.buffers: Dict[str, torch.Tensor] = {
            k: v.detach().expand(K, *v.shape).contiguous()
            for k, v in self.model.named_buffers()}
        if test_data is not None:
            self.test_x, self.test_y = (t.to(self.device) for t in test_data)
            self.eval_batch_size = int(eval_batch_size or batch_size)
        else:
            self.test_x = self.test_y = None
        self.nan_chains: set = set()
        self._samples: List[tuple] = []
        self.potentials: List[np.ndarray] = []

    def _temps_for(self, epoch):
        "(K,) temperatures for the epoch (0 during descent epochs)"
        return self._temps[int(epoch >= self.descent_epochs)]

    def _is_sampling_epoch(self, epoch):
        epoch = epoch % self.epochs_per_cycle
        se = epoch - (self.descent_epochs + self.warmup_epochs)
        return (0 <= se) and (se % self.skip == 0)

    # -- one minibatch step of all chains ------------------------------------
    def _chain_step(self, idx, step, temperatures, last=False):
        """every chain's transition on its own minibatch (idx (K, B)); the
        epoch's last step adds the chains' aggregate tempering diagnostics
        after the step (kinetic ‖m‖²/d, configurational ⟨θ,g⟩N/d)"""
        xb, yb = self.train_x[idx], self.train_y[idx]
        theta = self.chains.position.detach().requires_grad_()
        fn = self.model.potential_avg_fn(
            xb, yb, self.eff_num_data, train=True,
            compute_dtype=self.compute_dtype, buffers=self.buffers)
        pot, aux = fn(self.kernel.unpack(theta))
        g, = torch.autograd.grad(pot.sum(), theta)
        g = vclip(g, -self.grad_max, self.grad_max)
        lr = self.learning_rate * self.schedule(step)
        self.chains, _ = self.kernel.step(self.chains, g, lr, temperatures,
                                          calc_metrics=False)
        out = {"potential": pot.detach(), "acc": aux["acc"].detach()}
        if last:
            d = self.kernel.packer.total
            m, pos = self.chains.momentum, self.chains.position
            out["est_temperature"] = vsum(m * m) / d
            out["est_config_temp"] = vsum(pos * g) * (self.kernel.num_data / d)
        return out

    def _run_epoch(self, idxs, step0, temperatures):
        """n_full steps of all chains, then the test evaluation, then the
        epoch's one host read; returns the epoch's entry (numpy (K,) rows)"""
        pots = []
        for b in range(self.n_full):
            m = self._chain_step(idxs[:, b], step0 + b, temperatures,
                                 last=b == self.n_full - 1)
            pots.append(m["potential"])
        keys = ["acc", "est_temperature", "est_config_temp"]
        rows = [m[k] for k in keys]
        if self.test_x is not None:
            lp, acc = self._evaluate()
            keys += ["test/acc", "test/loss"]
            rows += [acc, -lp]
        host = torch.cat([torch.stack(pots).double(),
                          torch.stack(rows).double()]).cpu().numpy()
        self.potentials.append(host[:self.n_full])
        entry = {"potential": host[self.n_full - 1]}
        entry.update(zip(keys, host[self.n_full:]))
        self._check_finite(entry["potential"])
        return entry

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
        "host copy of every chain's packed position and batchnorm state"
        self._samples.append((
            self.chains.position.detach().cpu().numpy().copy(),
            {k: v.cpu().numpy().copy() for k, v in self.buffers.items()},
            step))

    def get_samples(self, drop_nan_chains=True) -> Dict[str, np.ndarray]:
        """stacked sample bank: each entry (n_samples, n_chains, ...).
        Diverged (NaN) chains are dropped from the chain axis by default so
        they cannot enter posterior-predictive ensembles; pass
        drop_nan_chains=False for the raw bank (multichain.py:972-995)."""
        out: Dict[str, list] = {}
        for position, bufs, _ in self._samples:
            params = self.kernel.packer.unpack(torch.from_numpy(position))
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
    counterpart of the JAX `MultiChainRunnerReject(packing="flat")` with no
    mesh.

    Everything `VerletSGLDRunnerReject` does happens here per chain,
    batched: the exact full-dataset gradient is one sweep in which the K
    chains see every batch together, `final_step` → ΔE → `maybe_reject` →
    `initial_step` are one kernel launch each for all chains, every chain
    accepts or rejects on its own (a device-side select over its rows), and
    the minibatch order is fixed per (chain, cycle). Preconditioner updates
    land between M-H segments (multichain.py:1240-1255). Every chain takes
    the M-H test and a rejection restores its momentum unflipped, as the
    reference does; the JAX runner's `reject_samples=False` and
    `flip_on_reject` are not taken."""

    def __init__(self, *args, **kwargs):
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
        "every chain's exact (loss, log_prior, potential, acc, grads)"
        return exact_potential_and_grad(
            self.model, self.kernel, self.chains.position, self.train_x,
            self.train_y, n_full=self.n_full, batch_size=self.batch_size,
            tail=self.tail, N=self.N, eff_num_data=self.eff_num_data,
            grad_max=self.grad_max, buffers=self.buffers)

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
        self.chains, rejected, _ = self.kernel.maybe_reject(
            self.chains, de, temperatures)
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
        "initial_step from each chain's (possibly rolled back) exact gradient"
        lr = self.learning_rate * self.schedule(lr_index)
        self.chains, _ = self.kernel.initial_step(
            self.chains, self.chains.grads, lr, temperatures,
            save_state=True, calc_metrics=False)

    # -- main loop -----------------------------------------------------------
    def run(self):
        """all epochs; returns one entry an epoch: each chain's last-step
        potential, acc, est_temperature and est_config_temp and, with test
        data, test/acc and test/loss, as numpy (K,) arrays"""
        self.potentials = []
        # initial exact gradient, momentum refresh and initial_step
        # (multichain.py:1188-1196)
        _, _, pot, _, grads = self._exact()
        self.chains.grads = grads
        self.chains = self.kernel.sample_momentum(self.chains,
                                                  self.temperatures)
        self.chains, _ = self.kernel.initial_step(
            self.chains, grads, self.learning_rate * self.schedule(0),
            self.temperatures, save_state=True, calc_metrics=False)
        self._initial_pots = pot

        # with no sampling epoch there is no M-H segment to keep M fixed in
        defer_precond = self.sample_epochs > 0
        history = []
        step = 0
        for e in range(self.cycles * self.epochs_per_cycle):
            cycle, epoch = divmod(e, self.epochs_per_cycle)
            temps = self._temps_for(epoch)
            entry = self._run_epoch(self._epoch_idxs(cycle, epoch), step,
                                    temps)
            step += self.n_full
            precond_due = (self.precond_update is not None
                           and (epoch + 1) % self.precond_update == 0)
            if self._is_sampling_epoch(epoch):
                self._boundary_final(step - 1, temps)
                # the sample is taken after maybe_reject, so it is already
                # rolled back (inference_reject.py:140-146)
                self._store_sample(step)
                # M changes only between M-H segments, so ΔE is each
                # segment's true energy change
                if defer_precond:
                    if precond_due or self._precond_pending:
                        self.chains = self.kernel.update_preconditioner(
                            self.chains)
                        self._precond_pending = False
                elif precond_due:
                    self.chains = self.kernel.update_preconditioner(
                        self.chains)
                self._boundary_initial(step, temps)
            elif precond_due:
                if defer_precond:
                    self._precond_pending = True
                else:
                    self.chains = self.kernel.update_preconditioner(
                        self.chains)
            history.append(entry)
        return history

    def acceptance_rates(self) -> np.ndarray:
        "(n_chains,) fraction of accepted M-H boundaries"
        if not self.rejections:
            return np.ones(self.n_chains)
        return 1.0 - np.stack(self.rejections).mean(axis=0)
