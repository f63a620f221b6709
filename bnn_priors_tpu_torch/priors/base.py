"""Priors as `nn.Module`s (counterpart of `bnn_priors_tpu/priors/base.py`).

A `Prior` holds its leaf as the `nn.Parameter` `p`, so `state_dict()` names
come out as the JAX package's param-store names and the reference torch
library's (`net.0.weight_prior.p`). A hyperparameter is a number, an array
(a distance matrix, a PCA basis) or a sub-`Prior`: a sub-prior is a child
module under the hyper's name, so its leaf is `…weight_prior.scale.p`, and
the hyper's value is the child's `forward`. A prior may also carry extra
leaves (a mixture's `mixture_weights`), have no leaf of its own
(`suppress_own`: a mixture component evaluated at its parent's leaf), and
pin its initial value (`pinned_init`).

Every method takes an optional param store `params` ({dotted name: tensor},
e.g. views into a sampler's packed vector) and the prior's `prefix` in it;
without a store a prior reads its own parameters, which is what the layers'
forward does under `torch.func.functional_call`. The store's leaves may
carry leading chain dims, `(K, *shape)`: `log_prob` then gives one term a
chain, `(K,)`, and a sub-prior's `(K, ...)` value is reshaped to
`(K, 1, …, 1, ...)` to broadcast against the chains' values.

Number hypers stay Python floats and array hypers are copied to a value's
dtype and device once and kept, so a density on the card makes no host
copy.
"""
from __future__ import annotations

from numbers import Number
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

ParamStore = Dict[str, torch.Tensor]


def join(prefix: str, name: str) -> str:
    return name if prefix == "" else prefix + "." + name


def host_like(shape) -> torch.Tensor:
    "a float64 CPU tensor of `shape`: the `like` of the sampling side"
    return torch.empty(tuple(shape), dtype=torch.float64)


class Prior(nn.Module):
    """Base class. Subclasses define `_dist(**hypers)` returning a
    distribution from `bnn_priors_tpu_torch.distributions`."""

    #: no own `p` leaf and no own log-prob term (a mixture's component,
    #: which its parent evaluates at the parent's leaf)
    suppress_own: bool = False
    #: whether `init` can draw the leaf (False for a fitted prior whose
    #: sampler the reference lacks, ROADMAP §3)
    drawable: bool = True

    def __init__(self, shape, **hypers):
        super().__init__()
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.hypers: Dict[str, object] = {}
        self.pinned_init: Optional[np.ndarray] = None
        self._consts: Dict[tuple, torch.Tensor] = {}
        for key, arg in hypers.items():
            assert key != "p", "repeated name of parameter"
            if isinstance(arg, Prior):
                self.add_module(key, arg)
                self.hypers[key] = arg
            else:
                self.hypers[key] = _constant(arg)
        self.p = nn.Parameter(torch.zeros(self.shape))

    def set_hyper(self, name: str, value) -> None:
        """set the number or array hyper `name` after construction (a fitted
        value loaded into a built model): stored as the constructor stores
        it, with every tensor made from the old value dropped"""
        assert not isinstance(self.hypers.get(name), Prior), name
        self.hypers[name] = _constant(value)
        self._consts.clear()
        self._hypers_changed()

    def _hypers_changed(self) -> None:
        "recompute what a subclass derived from its hypers at construction"

    # ---- structure -------------------------------------------------------
    def children_priors(self) -> Dict[str, "Prior"]:
        return {k: v for k, v in self.hypers.items() if isinstance(v, Prior)}

    def named_priors(self, prefix: str = "") -> Iterator[Tuple[str, "Prior"]]:
        "this prior and its sub-priors, parent first"
        yield prefix, self
        for name, child in self.children_priors().items():
            yield from child.named_priors(join(prefix, name))

    def leaf_shapes(self, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
        out: Dict[str, Tuple[int, ...]] = {}
        if not self.suppress_own:
            out[join(prefix, "p")] = self.shape
        for name, shape in self.extra_leaf_shapes().items():
            out[join(prefix, name)] = shape
        for name, child in self.children_priors().items():
            out.update(child.leaf_shapes(join(prefix, name)))
        return out

    def extra_leaf_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def suppress(self) -> "Prior":
        "drop the own leaf: the parent evaluates this prior at its own"
        self.suppress_own = True
        del self.p
        return self

    # ---- values ------------------------------------------------------------
    def leaf(self, params: Optional[ParamStore], prefix: str,
             name: str = "p") -> torch.Tensor:
        return getattr(self, name) if params is None else \
            params[join(prefix, name)]

    def const(self, name: str, like: torch.Tensor, array=None
              ) -> torch.Tensor:
        """array hyper `name` (or the constant `array` of that name) in
        like's dtype and on its device, made once"""
        key = (name, like.dtype, like.device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(
                self.hypers[name] if array is None else array,
                dtype=like.dtype, device=like.device)
        return t

    def n_lead(self, like: torch.Tensor) -> int:
        "the leading chain dims of a value of this prior"
        return like.ndim - len(self.shape)

    def resolve(self, params, prefix: str, name: str, like: torch.Tensor,
                broadcast: bool = True):
        """hyper `name` for a value `like` of this prior: a float, a
        constant tensor, or the sub-prior's forward. With chain dims, a
        sub-prior's (*lead, *cs) value becomes (*lead, 1, …, 1, *cs)
        (`broadcast`), or stays as it is."""
        v = self.hypers[name]
        if isinstance(v, Prior):
            val = v.forward(params, join(prefix, name))
            lead = self.n_lead(like)
            if broadcast and lead:
                cs = tuple(val.shape[lead:])
                val = val.reshape(tuple(val.shape[:lead])
                                  + (1,) * (len(self.shape) - len(cs)) + cs)
            return val
        if isinstance(v, float):
            return v
        return self.const(name, like)

    def resolved_hypers(self, params, prefix, like) -> Dict[str, object]:
        return {k: self.resolve(params, prefix, k, like) for k in self.hypers}

    # ---- density / value -------------------------------------------------
    def _dist(self, **hypers):
        raise NotImplementedError

    def _dist_obj(self, params, prefix, like):
        return self._dist(**self.resolved_hypers(params, prefix, like))

    def forward(self, params: Optional[ParamStore] = None,
                prefix: str = "") -> torch.Tensor:
        "effective value of the parameter carrying this prior"
        return self.leaf(params, prefix)

    def chain_sum(self, lp: torch.Tensor, value: torch.Tensor):
        "sum of an elementwise term over one chain's value: (*lead,)"
        lead = self.n_lead(value)
        return lp.reshape(tuple(lp.shape[:lead]) + (-1,)).sum(-1)

    def log_prob_value(self, params, prefix: str, value: torch.Tensor):
        "this prior's own term at `value` (p-space), one a chain"
        return self.chain_sum(
            self._dist_obj(params, prefix, value).log_prob(value), value)

    def log_prob_own(self, params, prefix: str):
        if self.suppress_own:
            return 0.0
        return self.log_prob_value(params, prefix, self.leaf(params, prefix))

    def log_prob(self, params: Optional[ParamStore] = None,
                 prefix: str = ""):
        "own term + every sub-prior's term (what `Model.log_prior` sums)"
        total = self.log_prob_own(params, prefix)
        for name, child in self.children_priors().items():
            total = total + child.log_prob(params, join(prefix, name))
        return total

    # ---- initialisation / sampling -----------------------------------------
    def host_store(self) -> ParamStore:
        "this prior's leaves by local name, as float64 CPU tensors"
        return {n: t.detach().to("cpu", torch.float64)
                for n, t in self.named_parameters()}

    def _sample_p(self, generator, params: ParamStore, prefix: str):
        """a fresh draw of the own leaf (float64, CPU) given the hypers'
        values in the host store `params`"""
        dist = self._dist_obj(params, prefix, host_like(self.shape))
        return dist.sample(self.shape, generator).expand(self.shape)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "Prior":
        """initial values of every leaf: sub-priors first, so that the own
        draw is conditioned on their values; extra leaves 0; a pinned leaf
        takes its pin. Draws come from the CPU `generator`."""
        for child in self.children_priors().values():
            child.init(generator)
        for name in self.extra_leaf_shapes():
            getattr(self, name).zero_()
        if not self.suppress_own:
            if self.pinned_init is not None:
                self.p.copy_(torch.as_tensor(np.asarray(
                    self.pinned_init, dtype=np.float64)).expand(self.shape))
            else:
                self.draw_(generator)
        return self

    @torch.no_grad()
    def draw_(self, generator: Optional[torch.Generator] = None) -> None:
        """a fresh draw of the own leaf, in place, conditioned on the hypers'
        current values (the step `init` and `Model.sample_all_priors`
        share)"""
        self.p.copy_(self._sample_p(generator, self.host_store(), "")
                     .expand(self.shape))


def _constant(value):
    "a number hyper as a Python float, an array hyper as float64 numpy"
    if isinstance(value, Number) or np.ndim(value) == 0:
        return float(value)
    return np.asarray(value, dtype=np.float64)


def named_priors(prior_tree: Dict[str, Prior]
                 ) -> Iterator[Tuple[str, Prior]]:
    "(prefix, prior) over a dict of top-level priors and their sub-priors"
    for prefix, p in prior_tree.items():
        yield from p.named_priors(prefix)


def value_or_call(v, params: Optional[ParamStore] = None, prefix: str = ""):
    "a value that may be a Prior (reference `value_or_call`)"
    if isinstance(v, Prior):
        return v.forward(params, prefix)
    return torch.as_tensor(v)


def default_dtype() -> torch.dtype:
    return torch.get_default_dtype()
