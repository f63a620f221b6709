"""Experiment glue: string registries and initializers (counterpart of
`bnn_priors_tpu/exp_utils.py`).

The registry names are the JAX package's and the reference's, so paper
commands translate 1:1: data `cifar10`, `cifar10_augmented`,
`cifar10_small`, `cifar10c-<corruption>`, `svhn`, `mnist`,
`fashion_mnist`, `rotated_mnist` (from local files), `UCI_<name>` (the
bundled splits), `random`, `random_ood_test`, `fake_cifar10`,
`fake_mnist` and `synthetic.<base>.<prior>` (labels drawn from a model of
that prior, `get_data_from_config`); every model of the JAX registry (the
data-driven ones read the fitted files bundled under `models/fits/`);
every weight/bias prior of `priors.get_prior`, and the `he`,
`he_uniform` and `he_zerobias` initializers. Everything runs on the card
unless `device="cpu"` is asked for.
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
    "svhn": data_mod.SVHN,
    "random": data_mod.RandomData,
    "random_ood_test": data_mod.RandomOODTestData,
    "fake_mnist": data_mod.FakeMNIST,
    "fake_cifar10": data_mod.FakeCIFAR10,
}


def get_data(data: str, device="cuda", **kwargs):
    """string → dataset, on `device` (reference exp_utils.py:30-60);
    `UCI_<name>` is split 0 of that dataset, `cifar10c-<corruption>` the
    corruption's whole file as CIFAR-10's test set"""
    if data[:3] == "UCI":
        name = data.split("_")[1]
        assert name in data_mod.UCI_DATASETS, f"unknown UCI dataset {name}"
        return data_mod.UCI(name, 0, device=device, **kwargs)
    if data[:8] == "cifar10c":
        corruption = data.split("-")[1]
        return data_mod.CIFAR10_C(corruption, device=device, **kwargs)
    if data not in _DATA_REGISTRY:
        raise ValueError(f"Unknown data={data!r}")
    return _DATA_REGISTRY[data](device=device, **kwargs)


def get_data_seeded(data: str, seed, device="cuda"):
    """get_data, passing `seed=` only when the dataset's constructor takes
    it (reference exp_utils.py:57-67): the toy datasets draw their points
    from it, so eval re-hydration scores the points the run trained on"""
    cls = _DATA_REGISTRY.get(data)
    if cls is not None and "seed" in inspect.signature(cls).parameters:
        return get_data(data, device=device, seed=int(seed))
    return get_data(data, device=device)


def get_data_from_config(cfg, device="cuda"):
    """dataset of a training config, seeded with its `seed`, so that train
    and eval regenerate the identical dataset (reference
    exp_utils.py:70-102). `synthetic.<base>.<prior>` is the base dataset
    (seeded as in `get_data_seeded`) with its labels drawn from the
    config's model under `<prior>` (`weight_prior_params={}`), whose
    parameters `sample_all_priors` draws: one CPU generator seeded with the
    config's seed gives the model's seed, then its parameters, then the
    labels."""
    if not cfg["data"].startswith("synthetic."):
        return get_data_seeded(cfg["data"], cfg["seed"], device=device)
    _, base_name, prior_name = cfg["data"].split(".")
    base = get_data_seeded(base_name, cfg["seed"], device=device)
    gen = torch.Generator().manual_seed(int(cfg["seed"]))
    true_model = get_model(
        cfg["model"], weight_prior=prior_name, weight_loc=cfg["weight_loc"],
        weight_scale=cfg["weight_scale"], bias_prior=cfg["bias_prior"],
        bias_loc=cfg["bias_loc"], bias_scale=cfg["bias_scale"],
        batchnorm=cfg["batchnorm"], weight_prior_params={},
        bias_prior_params=cfg["bias_prior_params"],
        x_train=base.norm.train_X, y_train=base.norm.train_y,
        width=cfg["width"], depth=cfg["depth"], device=device,
        seed=int(torch.randint(0, 2 ** 62, (), generator=gen)))
    true_model.sample_all_priors(gen)
    return data_mod.Synthetic(base, true_model, generator=gen)


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
    width and depth from `width` and `depth`. The ResNets take no data:
    the ResNet-20s and the PreAct ResNets are on 10 classes whatever these
    are, and only `vwidth_resnet18` and `vwidth_datadriven_resnet18` read
    `width`; `test_gaussian` takes nothing. The prior params go to every
    prior constructor of the model, as in the JAX package; the
    data-driven ResNet-18s take their fitted files there
    (`mean_covs_file`, `fits_dict_file`), `resnet18` its
    `lengthscale_dict_file`. A model that `init` cannot draw
    (`Model.drawable`, ROADMAP §3) comes with zero leaves."""
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
    net = _data_free_model(model, width, batchnorm, kw)
    if net is None:
        net = _data_shaped_model(model, x_train, y_train, width, depth, kw)
    net = net.to(dtype)
    if net.drawable():
        net.init(torch.Generator().manual_seed(int(seed)))
    # else (a data-driven ResNet-18 with its mean_covs fits) the leaves stay
    # at zero for an initializer to overwrite, as the CLI's He init does
    return net.to(device)


def _data_free_model(model, width, batchnorm, kw):
    """the registry's models that take no data, the ResNets
    (exp_utils.py:153-179) and `test_gaussian` (:191-192); None for
    another name"""
    if model == "test_gaussian":
        return models.GaussianModel(N=1, D=100)
    common = dict(bn=batchnorm, softmax_temp=1.0)
    if model == "googleresnet":
        return models.ResNet(depth=20, **common, **kw)
    if model == "correlatedgoogleresnet":
        return models.CorrelatedResNet(depth=20, **common, **kw)
    if model == "resnet18":
        return models.PreActResNet18(**common, **kw)
    if model == "vwidth_resnet18":
        return models.PreActResNet18(width=width, **common, **kw)
    if model == "thin_resnet18":
        return models.ThinPreActResNet18(**common, **kw)
    if model == "resnet34":
        return models.PreActResNet34(**common, **kw)
    if model in ("datadriven_resnet18", "vwidth_datadriven_resnet18"):
        wide = {"width": width} if model.startswith("vwidth") else {}
        return models.DataDrivenPreActResNet18(
            **wide, **common, **dict(kw, scaling_fn=None))
    if model == "datadriven_mvt_googleresnet":
        return models.DataDrivenMVTGoogleResNet(depth=20, num_classes=10,
                                                **common)
    if model == "decreasing_mvt_googleresnet":
        return models.DecreasingMVTGoogleResNet(depth=20, **common, **kw)
    return None


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
    if model == "raobdensenet":  # its priors are the default Normals
        return models.RaoBDenseNet(x_train, y_train, width,
                                   noise_std=LogNormal((), -1.0, 0.2))
    if model == "raob_linear":
        return models.RaoBLinearRegression(x_train, y_train, noise_std=0.5)
    if model == "classificationdensenet":
        return models.ClassificationDenseNet(n_in, n_classes(), width, depth,
                                             softmax_temp=1.0, **kw)
    conv_nets = {
        "classificationconvnet": models.ClassificationConvNet,
        "correlatedclassificationconvnet":
            models.CorrelatedClassificationConvNet,
        "datadrivengaussconv": models.DataDrivenGaussianClassificationConvNet,
        "datadrivendoublegammaconv":
            models.DataDrivenDoubleGammaClassificationConvNet}
    if model in conv_nets:
        if x_train.ndim == 4:
            in_channels, img_height = x_train.shape[1], x_train.shape[-2]
        else:
            in_channels, img_height = 1, int(math.sqrt(n_in))
        return conv_nets[model](in_channels, img_height, n_classes(), width,
                                depth, softmax_temp=1.0, **kw)
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
