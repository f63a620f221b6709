"""Experiment glue: string registries and initializers (counterpart of
`bnn_priors_tpu/exp_utils.py`).

The registry names are the JAX package's and the reference's, so paper
commands translate 1:1. Ported so far: data `fake_cifar10`, model
`googleresnet`, weight/bias prior `gaussian`, and `he_initialize`.
Everything runs on the card unless `device="cpu"` is asked for.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import data as data_mod
from . import models
from .device import resolve_device
from .priors import get_prior

__all__ = ("get_data", "get_model", "he_initialize")

_DATA_REGISTRY = {
    "fake_cifar10": data_mod.FakeCIFAR10,
}


def get_data(data: str, device="cuda", **kwargs):
    "string → dataset, on `device` (reference exp_utils.py:30-60)"
    if data not in _DATA_REGISTRY:
        raise NotImplementedError(
            f"data={data!r} is not ported yet (ported: {sorted(_DATA_REGISTRY)})")
    return _DATA_REGISTRY[data](device=device, **kwargs)


def get_model(model: str, weight_prior="gaussian", weight_loc=0.0,
              weight_scale=2 ** 0.5, bias_prior="gaussian", bias_loc=0.0,
              bias_scale=1.0, batchnorm=True, *, device="cuda",
              dtype=torch.float32, seed: int = 0):
    """string → model with its parameters drawn from the priors (CPU
    generator seeded with `seed`), in `dtype` on `device` (reference
    exp_utils.py:108-234). The JAX registry's data-shape, width and depth
    arguments are not taken: `googleresnet` is ResNet-20 on 10 classes
    whatever they are."""
    device = resolve_device(device)
    if weight_prior in ["cauchy"]:
        scaling_fn = lambda std, dim: std / dim
    else:
        scaling_fn = lambda std, dim: std / dim ** 0.5
    kw = dict(prior_w=get_prior(weight_prior), loc_w=weight_loc,
              std_w=weight_scale, prior_b=get_prior(bias_prior), loc_b=bias_loc,
              std_b=bias_scale, scaling_fn=scaling_fn)
    if model == "googleresnet":
        net = models.ResNet(depth=20, bn=batchnorm, softmax_temp=1.0, **kw)
    else:
        raise NotImplementedError(f"model={model!r} is not ported yet")
    net = net.to(dtype)
    net.init(torch.Generator().manual_seed(int(seed)))
    return net.to(device)


def _kaiming_normal(shape, generator):
    "torch kaiming_normal_(mode='fan_in', nonlinearity='relu'), in float64"
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    std = math.sqrt(2.0) / math.sqrt(fan_in)
    return std * torch.randn(shape, generator=generator, dtype=torch.float64)


@torch.no_grad()
def he_initialize(model: torch.nn.Module,
                  generator: Optional[torch.Generator] = None):
    """kaiming-normal weights, uniform ±1/√fan_out biases, in place on the
    model's prior leaves (reference exp_utils.py:63-78). Draws in float64
    on the CPU from `generator`, so every dtype and device gets the same
    values up to rounding, and copies to the parameters."""
    for name, p in model.named_parameters():
        if "weight_prior.p" in name:
            p.copy_(_kaiming_normal(tuple(p.shape), generator))
        elif "bias_prior.p" in name:
            bound = 1 / math.sqrt(p.shape[0])
            u = torch.rand(tuple(p.shape), generator=generator,
                           dtype=torch.float64)
            p.copy_(u * (2 * bound) - bound)
    return model
