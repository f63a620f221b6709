"""Model layer: network module + likelihood wrappers (counterpart of
`bnn_priors_tpu/models/base.py`).

A `Model` is an `nn.Module` whose parameters are the sampled leaves (prior
leaves `....weight_prior.p` and free parameters such as batchnorm
`weight`/`bias`) and whose buffers are the batchnorm running statistics.
The likelihood functions take an explicit `params` dict (name → tensor,
e.g. views into the sampler's packed vector) and run the network through
`torch.func.functional_call`, so a gradient with respect to the packed
vector comes back packed. Buffers stay the module's own and are updated in
place in train mode.

K chains run in one pass when `buffers` is given (`{name: (K, ...)}`, the
chains' batchnorm state): the params then carry a leading chain axis, each
chain sees its own minibatch, and the layers fold the chains into channel
groups (see `layers.py`); the chains' buffers are updated in place instead
of the module's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .. import distributions as D
from ..priors.base import Prior, join

ParamStore = Dict[str, torch.Tensor]


class Model(nn.Module):
    """Likelihood wrapper; subclasses define `likelihood_log_prob` etc.

    `potential(params, x, y, eff_num_data)` is the -log joint used by the
    samplers, with the unbiased minibatch scaling `eff_num_data / batch`.
    """

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x)

    def params(self) -> ParamStore:
        "the module's own parameters, by name"
        return dict(self.named_parameters())

    # -- priors ------------------------------------------------------------
    def named_priors(self) -> List[Tuple[str, Prior]]:
        """top-level priors (each sums its sub-priors' terms itself),
        parent-first module order"""
        out: List[Tuple[str, Prior]] = []

        def walk(prefix, module):
            for name, child in module.named_children():
                full = join(prefix, name)
                if isinstance(child, Prior):
                    out.append((full, child))
                else:
                    walk(full, child)
        walk("", self)
        return out

    def log_prior(self, params: Optional[ParamStore] = None) -> torch.Tensor:
        """Σ of the top-level priors' log_prob over the whole store (hyper
        leaves resolve from it); one term a chain for (K, ...) leaves"""
        params = self.params() if params is None else params
        total = None
        for name, p in self.named_priors():
            lp = p.log_prob(params, name)
            total = lp if total is None else total + lp
        return total

    def drawable(self) -> bool:
        "whether `init` can draw every top-level prior (ROADMAP §3)"
        return all(p.drawable for _, p in self.named_priors())

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """fresh initial state: every top-level prior's leaves drawn from
        it (sub-priors first, pins honoured; from a CPU `generator`),
        batchnorm affine parameters and buffers reset"""
        for _, p in self.named_priors():
            p.init(generator)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters()
        return self

    @torch.no_grad()
    def sample_all_priors(self, generator: Optional[torch.Generator] = None
                          ) -> "Model":
        """one fresh draw of every prior's leaf, in place, from the CPU
        `generator` (JAX `models/base.py:128-134`): the top-level priors in
        `named_priors()` order, each before its sub-priors and conditioned
        on the values drawn so far (JAX `Prior.sample`). Unlike `init`, which
        draws sub-priors first, pins are not honoured and extra leaves keep
        their values, as in JAX; nothing else of the model changes."""
        for _, top in self.named_priors():
            for _, p in top.named_priors():
                if not p.suppress_own:
                    p.draw_(generator)
        return self

    # -- likelihood (subclass API) ----------------------------------------
    def net_apply(self, params: Optional[ParamStore], x, train=False):
        self.train(train)
        if params is None:
            return self(x)
        return functional_call(self, params, (x,))

    def net_apply_chains(self, params: ParamStore, buffers: ParamStore, x,
                         train=False):
        """K chains' networks in one pass: params and buffers {name:
        (K, ...)}, x (K, B, C, ...) one minibatch a chain. The input is
        folded to (B, K·C, ...) and the output (B, K·out) unfolded to
        (K, B, out)."""
        K, B = x.shape[0], x.shape[1]
        xf = x.transpose(0, 1).reshape(B, K * x.shape[2], *x.shape[3:])
        self.train(train)
        out = functional_call(self, {**params, **buffers}, (xf,))
        return out.reshape(B, K, -1).transpose(0, 1)

    def likelihood_log_prob(self, f, y, params: Optional[ParamStore] = None):
        """per-datapoint log p(y_i | f_i); shape (batch,), or (K, batch)
        for K chains. A likelihood's own leaves (a regression's
        `noise_std.p`) are read from `params` (default: the module's)."""
        raise NotImplementedError

    def acc_fn(self, f, y):
        "per-datapoint accuracy (a regression's: the squared error)"
        raise NotImplementedError

    # -- potential ---------------------------------------------------------
    def log_likelihood(self, params, x, y, eff_num_data, train=False,
                       mask: Optional[torch.Tensor] = None,
                       compute_dtype: Optional[torch.dtype] = None,
                       buffers: Optional[ParamStore] = None):
        """Unbiased minibatch estimate of log p(y | x, params); returns
        (ll, f). `mask` supports padded batches: masked-out rows contribute
        0 and the scaling divides by the true batch size.

        `compute_dtype` (e.g. torch.bfloat16) runs the network forward in
        reduced precision: params and inputs are cast down for the network
        only, while the likelihood, its reduction and the prior stay in the
        parameter dtype (so do the batchnorm statistics).

        With `buffers`, K chains at once (`net_apply_chains`): x (K, B, ...)
        and y (K, B, ...) hold one minibatch a chain, ll comes out (K,) and f
        (K, B, out); `mask` is not taken then."""
        net_params, xc = params, x
        if compute_dtype is not None and compute_dtype != x.dtype:
            net_params = {k: (v.to(compute_dtype) if v.is_floating_point()
                              else v) for k, v in params.items()}
            xc = x.to(compute_dtype)
        if buffers is None:
            f = self.net_apply(net_params, xc, train)
        else:
            assert mask is None, "masked batches are single-chain only"
            f = self.net_apply_chains(net_params, buffers, xc, train)
        f = f.to(x.dtype)
        lps = self.likelihood_log_prob(f, y, params)
        if mask is not None:
            lps = lps * mask
            batch_size = mask.sum()
        else:
            batch_size = lps.shape[-1]
        ll = lps.sum(-1) * (eff_num_data / batch_size)
        return ll, f

    def potential(self, params, x, y, eff_num_data, train=False, mask=None,
                  compute_dtype=None):
        ll, _ = self.log_likelihood(params, x, y, eff_num_data, train, mask,
                                    compute_dtype)
        return -(ll + self.log_prior(params))

    def potential_avg(self, params, x, y, eff_num_data, train=False,
                      mask=None, compute_dtype=None):
        "-log p(y, params | x) / eff_num_data — what the samplers differentiate"
        ll, _ = self.log_likelihood(params, x, y, 1.0, train, mask,
                                    compute_dtype)
        return -(ll + self.log_prior(params) / eff_num_data)

    def potential_avg_fn(self, x, y, eff_num_data, train=True, mask=None,
                         compute_dtype=None, buffers=None):
        """The closure the SG-MCMC kernels differentiate:
        params -> (potential_avg, aux). With `buffers`, K chains at once
        (see `log_likelihood`): every value comes out (K,)."""

        def fn(params):
            ll_avg, f = self.log_likelihood(params, x, y, 1.0, train, mask,
                                            compute_dtype, buffers)
            loss = -ll_avg
            log_prior = self.log_prior(params)
            pot = loss - log_prior / eff_num_data
            acc = self.acc_fn(f, y)
            if mask is not None:
                acc_mean = (acc * mask).sum() / mask.sum()
            else:
                acc_mean = acc.mean(-1)
            return pot, {"loss": loss, "log_prior": log_prior, "acc": acc_mean}
        return fn


class ClassificationModel(Model):
    """Categorical likelihood with a fixed softmax temperature."""

    def __init__(self, net: nn.Module, softmax_temp: float = 1.0):
        super().__init__(net)
        self.softmax_temp = float(softmax_temp)

    def _logits(self, f):
        return f / self.softmax_temp

    def likelihood_log_prob(self, f, y, params=None):
        logits = self._logits(f)
        logZ = torch.logsumexp(logits, dim=-1)
        return torch.gather(logits, -1, y[..., None])[..., 0] - logZ

    def acc_fn(self, f, y):
        return (self._logits(f).argmax(dim=-1) == y).to(torch.float32)


class RegressionModel(Model):
    """Independent Gaussian likelihood (JAX `models/base.py:251-274`).
    `noise_std` is a float or a prior, whose leaf `noise_std.p` is 0-d, and
    (K,) on the chain axis, where it scales chain k's (K, B, D) outputs."""

    def __init__(self, net: nn.Module, noise_std):
        super().__init__(net)
        self.noise_std = (noise_std if isinstance(noise_std, Prior)
                          else float(noise_std))

    def _noise_std(self, params, f):
        "the std, shaped to broadcast against f (..., B, D)"
        if not isinstance(self.noise_std, Prior):
            return self.noise_std
        std = self.noise_std.forward(params, "noise_std")
        return std.reshape(std.shape + (1,) * (f.ndim - std.ndim))

    def likelihood_log_prob(self, f, y, params=None):
        return D.Normal(f, self._noise_std(params, f)).log_prob(y).sum(-1)

    def acc_fn(self, f, y):
        d = f - y
        return (d * d).sum(-1)
