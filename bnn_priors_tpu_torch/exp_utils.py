"""Experiment glue: string registries and initializers (counterpart of
`bnn_priors_tpu/exp_utils.py`).

The registry names are the JAX package's and the reference's, so paper
commands translate 1:1. Ported so far: data `cifar10`, `cifar10_augmented`,
`cifar10_small`, `mnist`, `fashion_mnist`, `rotated_mnist` (from local
files), `UCI_<name>` (the bundled splits), `fake_cifar10` and `fake_mnist`;
models `googleresnet`, `correlatedgoogleresnet`, `classificationconvnet`,
`correlatedclassificationconvnet`, `classificationdensenet`, `densenet`,
`linear` and `logistic`; every weight/bias prior of `priors.get_prior`, and
the `he`, `he_uniform` and `he_zerobias` initializers. The names still
unported raise NotImplementedError naming their ROADMAP item. Everything
runs on the card unless `device="cpu"` is asked for.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, Optional

import torch

from . import data as data_mod
from . import models
from .device import resolve_device
from .priors import LogNormal, get_prior

__all__ = ("get_data", "get_data_from_config", "get_data_seeded",
           "get_model", "he_initialize", "he_uniform_initialize",
           "he_zerobias_initialize")

_DATA_REGISTRY = {
    "cifar10": data_mod.CIFAR10,
    "cifar10_augmented": data_mod.CIFAR10Augmented,
    "cifar10_small": data_mod.CIFAR10Small,
    "mnist": data_mod.MNIST,
    "rotated_mnist": data_mod.RotatedMNIST,
    "fashion_mnist": data_mod.FashionMNIST,
    "fake_mnist": data_mod.FakeMNIST,
    "fake_cifar10": data_mod.FakeCIFAR10,
}
# the JAX registry's names that wait for a later slice: data (ROADMAP
# item 13) and models (item 12)
_UNPORTED_DATA = frozenset({"svhn", "random", "random_ood_test"})
_UNPORTED_MODELS = frozenset({
    "raobdensenet", "datadrivengaussconv", "datadrivendoublegammaconv",
    "resnet18", "vwidth_resnet18", "datadriven_resnet18",
    "vwidth_datadriven_resnet18", "thin_resnet18", "resnet34",
    "datadriven_mvt_googleresnet", "decreasing_mvt_googleresnet",
    "raob_linear", "test_gaussian"})


def get_data(data: str, device="cuda", **kwargs):
    """string → dataset, on `device` (reference exp_utils.py:30-60);
    `UCI_<name>` is split 0 of that dataset"""
    if data[:3] == "UCI":
        name = data.split("_")[1]
        assert name in data_mod.UCI_DATASETS, f"unknown UCI dataset {name}"
        return data_mod.UCI(name, 0, device=device, **kwargs)
    if data[:8] == "cifar10c" or data in _UNPORTED_DATA:
        raise NotImplementedError(
            f"data={data!r} is not ported yet (ROADMAP item 13)")
    if data not in _DATA_REGISTRY:
        raise ValueError(f"Unknown data={data!r}")
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
                                  "are not ported yet (ROADMAP item 13)")
    return get_data_seeded(cfg["data"], cfg["seed"], device=device)


def get_model(model: str, weight_prior="gaussian", weight_loc=0.0,
              weight_scale=2 ** 0.5, bias_prior="gaussian", bias_loc=0.0,
              bias_scale=1.0, batchnorm=True, weight_prior_params=None,
              bias_prior_params=None, *, x_train=None, y_train=None,
              width=50, depth=3, device="cuda", dtype=torch.float32,
              seed: int = 0):
    """string → model with its parameters drawn from the priors (CPU
    generator seeded with `seed`), in `dtype` on `device` (reference
    exp_utils.py:108-234). The model's input and output widths come from
    the training data `x_train`, `y_train` (the classes are max(y)+1, at
    least 2; conv nets read square images of C·H·W features), its hidden
    width and depth from `width` and `depth`. `googleresnet` and
    `correlatedgoogleresnet` are ResNet-20 on 10 classes whatever these
    are. The prior params go to every prior constructor of the model, as
    in the JAX package."""
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
    elif model in _UNPORTED_MODELS:
        raise NotImplementedError(f"model={model!r} is not ported yet "
                                  "(ROADMAP item 12)")
    else:
        net = _data_shaped_model(model, x_train, y_train, width, depth, kw)
    net = net.to(dtype)
    net.init(torch.Generator().manual_seed(int(seed)))
    return net.to(device)


def _data_shaped_model(model, x_train, y_train, width, depth, kw):
    "the registry's models whose widths come from the data (exp_utils.py)"
    if x_train is None or y_train is None:
        raise ValueError(f"model={model!r} takes its widths from the "
                         "training data: pass x_train and y_train")
    n_in, n_out = x_train.shape[-1], y_train.shape[-1]

    def n_classes():
        return max(int(y_train.max()) + 1, 2)

    if model == "densenet":
        return models.DenseNet(n_in, n_out, width, depth,
                               noise_std=LogNormal((), -1.0, 0.2), **kw)
    if model == "classificationdensenet":
        return models.ClassificationDenseNet(n_in, n_classes(), width, depth,
                                             softmax_temp=1.0, **kw)
    if model in ("classificationconvnet", "correlatedclassificationconvnet"):
        if x_train.ndim == 4:
            in_channels, img_height = x_train.shape[1], x_train.shape[-2]
        else:
            in_channels, img_height = 1, int(math.sqrt(n_in))
        cls = (models.ClassificationConvNet if model == "classificationconvnet"
               else models.CorrelatedClassificationConvNet)
        return cls(in_channels, img_height, n_classes(), width, depth,
                   softmax_temp=1.0, **kw)
    if model == "linear":
        return models.LinearRegression(n_in, n_out, noise_std=0.5, **kw)
    if model == "logistic":
        return models.LogisticRegression(n_in, n_classes(), softmax_temp=1.0,
                                         **kw)
    raise ValueError(f"model={model!r}")


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
