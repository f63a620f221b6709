"""Experiment glue: string registries and initializers (counterpart of
`bnn_priors_tpu/exp_utils.py`).

The registry names are the JAX package's and the reference's, so paper
commands translate 1:1. Ported so far: data `cifar10`, `cifar10_augmented`,
`cifar10_small` (from local files) and `fake_cifar10`, models
`googleresnet` and `correlatedgoogleresnet`, every weight/bias prior of
`priors.get_prior`, and the `he`, `he_uniform` and `he_zerobias`
initializers. Everything runs on the card unless `device="cpu"` is asked
for.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, Optional

import torch

from . import data as data_mod
from . import models
from .device import resolve_device
from .priors import get_prior

__all__ = ("get_data", "get_data_from_config", "get_data_seeded",
           "get_model", "he_initialize", "he_uniform_initialize",
           "he_zerobias_initialize")

_DATA_REGISTRY = {
    "cifar10": data_mod.CIFAR10,
    "cifar10_augmented": data_mod.CIFAR10Augmented,
    "cifar10_small": data_mod.CIFAR10Small,
    "fake_cifar10": data_mod.FakeCIFAR10,
}


def get_data(data: str, device="cuda", **kwargs):
    "string → dataset, on `device` (reference exp_utils.py:30-60)"
    if data not in _DATA_REGISTRY:
        raise NotImplementedError(
            f"data={data!r} is not ported yet (ported: {sorted(_DATA_REGISTRY)})")
    return _DATA_REGISTRY[data](device=device, **kwargs)


def get_data_seeded(data: str, seed, device="cuda"):
    """get_data, passing `seed=` only when the dataset's constructor takes
    it (reference exp_utils.py:57-67)"""
    cls = _DATA_REGISTRY.get(data)
    if cls is not None and "seed" in inspect.signature(cls).parameters:
        return get_data(data, device=device, seed=int(seed))
    return get_data(data, device=device)


def get_data_from_config(cfg, device="cuda"):
    """dataset of a training config, seeded with its `seed` so train and
    eval see the same points (reference exp_utils.py:70-102); the
    `synthetic.<base>.<prior>` datasets are not ported"""
    if cfg["data"].startswith("synthetic."):
        raise NotImplementedError(f"data={cfg['data']!r}: synthetic datasets "
                                  "are not ported yet")
    return get_data_seeded(cfg["data"], cfg["seed"], device=device)


def get_model(model: str, weight_prior="gaussian", weight_loc=0.0,
              weight_scale=2 ** 0.5, bias_prior="gaussian", bias_loc=0.0,
              bias_scale=1.0, batchnorm=True, weight_prior_params=None,
              bias_prior_params=None, *, device="cuda",
              dtype=torch.float32, seed: int = 0):
    """string → model with its parameters drawn from the priors (CPU
    generator seeded with `seed`), in `dtype` on `device` (reference
    exp_utils.py:108-234). The JAX registry's data-shape, width and depth
    arguments are not taken: `googleresnet` and `correlatedgoogleresnet`
    are ResNet-20 on 10 classes whatever they are. The prior params go to
    every prior constructor of the model, as in the JAX package."""
    device = resolve_device(device)
    if weight_prior in ["cauchy"]:
        scaling_fn = lambda std, dim: std / dim
    else:
        scaling_fn = lambda std, dim: std / dim ** 0.5
    kw = dict(prior_w=get_prior(weight_prior), loc_w=weight_loc,
              std_w=weight_scale, prior_b=get_prior(bias_prior), loc_b=bias_loc,
              std_b=bias_scale, scaling_fn=scaling_fn,
              weight_prior_params=dict(weight_prior_params or {}),
              bias_prior_params=dict(bias_prior_params or {}))
    if model == "googleresnet":
        net = models.ResNet(depth=20, bn=batchnorm, softmax_temp=1.0, **kw)
    elif model == "correlatedgoogleresnet":
        net = models.CorrelatedResNet(depth=20, bn=batchnorm,
                                      softmax_temp=1.0, **kw)
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


def _uniform(shape, bound, generator):
    "uniform on ±bound, in float64"
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return u * (2 * bound) - bound


def _kaiming_uniform(shape, generator, a=math.sqrt(5)):
    "torch kaiming_uniform_(a=sqrt(5)), the convolution default, in float64"
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    gain = math.sqrt(2.0 / (1 + a ** 2))
    return _uniform(shape, gain * math.sqrt(3.0 / fan_in), generator)


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
            p.copy_(_uniform(tuple(p.shape), 1 / math.sqrt(p.shape[0]),
                             generator))
    return model


@torch.no_grad()
def he_zerobias_initialize(model: torch.nn.Module,
                           generator: Optional[torch.Generator] = None):
    "kaiming-normal weights, zero biases (reference exp_utils.py:63-78)"
    for name, p in model.named_parameters():
        if "weight_prior.p" in name:
            p.copy_(_kaiming_normal(tuple(p.shape), generator))
        elif "bias_prior.p" in name:
            p.zero_()
    return model


@torch.no_grad()
def he_uniform_initialize(model: torch.nn.Module,
                          generator: Optional[torch.Generator] = None):
    """the torch-default init family (reference exp_utils.py:80-96):
    kaiming-uniform convolutions, uniform ±1/√fan_in dense weights and
    uniform ±1/√fan_out dense biases"""
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if "weight_prior.p" in name:
            if "conv" in name or "shortcut" in name or p.ndim == 4:
                p.copy_(_kaiming_uniform(shape, generator))
            elif "linear" in name or p.ndim == 2:
                p.copy_(_uniform(shape, 1 / math.sqrt(shape[1]), generator))
            else:
                raise NotImplementedError(name)
        elif "bias_prior.p" in name:
            if "conv" in name or "shortcut" in name or p.ndim != 1:
                raise NotImplementedError(name)
            p.copy_(_uniform(shape, 1 / math.sqrt(shape[0]), generator))
    return model
