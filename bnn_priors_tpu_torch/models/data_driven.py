"""Data-driven models: priors fitted offline to trained networks' weights
(counterpart of `bnn_priors_tpu/models/data_driven.py`).

The fitted parameters ship with the port under `models/fits/` (its own
copies of the JAX package's six files; `BNN_PRIORS_FITS` names another
directory). The `.pkl.gz` files hold plain dicts and tuples of numpy values
and floats and are read with `gzip` and `pickle` (no pandas);
`cifar10_opt_mvt.pkl` holds torch tensors and is read with `torch.load`.

A model is built with its default priors and then edited before `init`:
`replace_prior` swaps a prior module for another, and a fitted number or
array goes into a built prior through `Prior.set_hyper`, which drops the
prior's cached tensors (and a correlated prior's Cholesky factor).
"""
from __future__ import annotations

import gzip
import os
import pickle
from numbers import Number
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import distributions as D
from .. import priors as prior
from ..priors.base import Prior
from .base import ClassificationModel
from .conv_nets import PreActBlock, PreActResNet, _conv_net
from .google_resnet import ResNet

__all__ = ("DataDrivenGaussianClassificationConvNet",
           "DataDrivenDoubleGammaClassificationConvNet",
           "DataDrivenMVTGoogleResNet", "DecreasingMVTGoogleResNet",
           "DataDrivenPreActResNet18", "replace_prior", "load_lengthscales",
           "default_fits_root", "read_fit")


def default_fits_root():
    "`BNN_PRIORS_FITS` if it names a directory, else the bundled `fits/`"
    bundled = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fits")
    for root in (os.environ.get("BNN_PRIORS_FITS", ""), bundled):
        if root and os.path.isdir(root):
            return root
    raise FileNotFoundError("fitted-prior files not found; set BNN_PRIORS_FITS")


def read_fit(path):
    "a fitted-prior pickle, gzipped (by its magic bytes) or plain"
    with open(path, "rb") as f:
        gzipped = f.read(2) == b"\x1f\x8b"
    with (gzip.open if gzipped else open)(path, "rb") as f:
        return pickle.load(f)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def replace_prior(model, prior_path: str, new_prior: Prior):
    """swap the prior at dotted `prior_path` (e.g. 'net.0.weight_prior')
    for `new_prior`, before `model.init`"""
    parent, _, name = prior_path.rpartition(".")
    owner = model.get_submodule(parent)
    assert isinstance(getattr(owner, name, None), Prior), \
        f"no prior {name} at {prior_path}"
    setattr(owner, name, new_prior)


def _strip_module(key: str) -> str:
    "the fits' DataParallel names 'net.module.X' are the models' 'net.X'"
    if key.startswith("net.module."):
        return "net." + key[len("net.module."):]
    return key


def _prior_at(model, key):
    "the prior whose leaf is `key` ('<path>.p')"
    assert key.endswith(".p"), key
    parent, _, name = key[:-len(".p")].rpartition(".")
    p = getattr(model.get_submodule(parent), name)
    assert isinstance(p, Prior), key
    return p


def load_lengthscales(model, lengthscale_dict_file):
    """set each convolution's fitted lengthscale on its prior (JAX
    `data_driven.py:80-92`); every key must name a prior of the model"""
    for k, v in read_fit(lengthscale_dict_file).items():
        _prior_at(model, _strip_module(k)).set_hyper("lengthscale", _to_np(v))
    return model


def _no_scaling(std, dim):
    return std


def _mnist_cnn(in_channels, img_height, out_features, width, softmax_temp,
               conv1, conv4, dense):
    """the depth-3 CNN (JAX `data_driven.py:113-134`) with the three
    layers' prior arguments, unscaled"""
    return _conv_net(in_channels, img_height, out_features, width, 3,
                     softmax_temp, *(dict(kw, scaling_fn=_no_scaling)
                                     for kw in (conv1, conv4, dense)))


def _bias(mean_covs, key):
    "a Normal bias prior's arguments from its fitted mean and variance"
    mb, cb = mean_covs[key]
    return dict(prior_b=prior.Normal, loc_b=float(mb),
                std_b=float(cb) ** 0.5)


def DataDrivenGaussianClassificationConvNet(
        in_channels, img_height, out_features, width, depth=3,
        softmax_temp=1.0, fits_root=None, **_unused):
    """the MNIST CNN with FixedCovNormal convolution priors and Normal dense
    and bias priors at their fitted means and covariances (JAX
    `data_driven.py:95-134`)"""
    assert depth == 3, "fitted data exists for depth=3 only"
    root = fits_root or default_fits_root()
    mc = read_fit(Path(root) / "mean_covs_mnist_classification.pkl.gz")
    m1, c1 = (_to_np(v) for v in mc["net.module.1.weight_prior.p"])
    m4, c4 = (_to_np(v) for v in mc["net.module.4.weight_prior.p"])
    m8, c8 = mc["net.module.8.weight_prior.p"]
    return _mnist_cnn(
        in_channels, img_height, out_features, width, softmax_temp,
        dict(prior_w=prior.FixedCovNormal, loc_w=m1, std_w=c1,
             **_bias(mc, "net.module.1.bias_prior.p")),
        dict(prior_w=prior.FixedCovNormal, loc_w=m4, std_w=c4,
             **_bias(mc, "net.module.4.bias_prior.p")),
        dict(prior_w=prior.Normal, loc_w=float(m8), std_w=float(c8) ** 0.5,
             **_bias(mc, "net.module.8.bias_prior.p")))


def DataDrivenDoubleGammaClassificationConvNet(
        in_channels, img_height, out_features, width, depth=3,
        softmax_temp=1.0, fits_root=None, **_unused):
    """heavy-tailed fitted priors: FixedCovLaplace, FixedCovDoubleGamma and
    a DoubleGamma dense layer (JAX `data_driven.py:137-176`)"""
    assert depth == 3
    root = fits_root or default_fits_root()
    mc = read_fit(Path(root) / "mean_covs_mnist_classification.pkl.gz")
    _, fits = read_fit(Path(root) / "fits_mnist_classification.pkl.gz")
    m1, c1 = (_to_np(v) for v in mc["net.module.1.weight_prior.p"])
    m4, c4 = (_to_np(v) for v in mc["net.module.4.weight_prior.p"])
    dg4 = fits["net.module.4.weight_prior.p"]["dgamma"]
    dg8 = fits["net.module.8.weight_prior.p"]["dgamma"]
    return _mnist_cnn(
        in_channels, img_height, out_features, width, softmax_temp,
        dict(prior_w=prior.FixedCovLaplace, loc_w=m1, std_w=c1,
             **_bias(mc, "net.module.1.bias_prior.p")),
        dict(prior_w=prior.FixedCovDoubleGamma, loc_w=m4, std_w=c4,
             weight_prior_params=dict(concentration=float(dg4[0])),
             **_bias(mc, "net.module.4.bias_prior.p")),
        dict(prior_w=prior.DoubleGamma, loc_w=float(dg8[1]),
             std_w=float(dg8[2]),
             weight_prior_params=dict(concentration=float(dg8[0])),
             **_bias(mc, "net.module.8.bias_prior.p")))


def _prior_paths(model):
    "'<path>.p' -> (path, prior) for every top-level prior"
    return {p + ".p": (p, pr) for p, pr in model.named_priors()}


def DataDrivenMVTGoogleResNet(softmax_temp=1.0, depth=20, num_classes=10,
                              bn=True, fits_root=None):
    """ResNet-20 with the multivariate-t priors of `cifar10_opt_mvt.pkl`
    where a fitted key names one of its priors (JAX `data_driven.py:
    184-212`). The file's keys are PreActResNet18 names, so none does and
    every prior stays the default Normal, in both packages."""
    assert depth == 20, "fitted data exists for depth=20 only"
    root = fits_root or default_fits_root()
    mvt = torch.load(Path(root) / "cifar10_opt_mvt.pkl", weights_only=False)
    model = ResNet(softmax_temp=softmax_temp, depth=depth,
                   num_classes=num_classes, bn=bn)
    paths = _prior_paths(model)
    for key, (_lik, params) in mvt.items():
        key = _strip_module(key)
        if key not in paths:
            continue  # the file's architecture names another network
        path, old = paths[key]
        if len(old.shape) == 4 and params["event_dim"] == "t":
            permute, event_dim = (1, 0, 2, 3), 3
        else:
            permute, event_dim = None, int(params["event_dim"])
        df = float(F.softplus(torch.as_tensor(params["df"])))
        replace_prior(model, path, prior.MultivariateT(
            old.shape, _to_np(params["loc"]), _to_np(params["scale_tril"]),
            df=df, event_dim=event_dim, permute=permute))
    return model


# degrees of freedom by ResNet-20 layer index; above 32 the Normal stays
_DECREASING_DF = {"0": 3.55, "3": 3.0, "4": 5.5, "5": 20.0, "6": 32.0,
                  "7": 50.0, "8": 60.0, "9": 70.0, "10": 80.0, "11": 90.0,
                  "14": 1000.0}


def DecreasingMVTGoogleResNet(softmax_temp=1.0, depth=20, num_classes=10,
                              prior_w=prior.ConvCorrelatedNormal, loc_w=0.0,
                              std_w=2 ** 0.5, prior_b=prior.Normal,
                              loc_b=0.0, std_b=1.0, scaling_fn=None, bn=True,
                              weight_prior_params={}, bias_prior_params={},
                              dense_prior_w=prior.Normal):
    """ResNet-20 whose first layers take multivariate-t priors, heavy-tailed
    first and closer to Gaussian with depth (JAX `data_driven.py:215-259`):
    a convolution's event is its (O, kH, kW) slice of one input channel,
    correlated over kH·kW when `prior_w` is ConvCorrelatedNormal"""
    assert depth == 20
    model = ResNet(softmax_temp=softmax_temp, depth=depth,
                   num_classes=num_classes, prior_w=prior_w, loc_w=loc_w,
                   std_w=std_w, prior_b=prior_b, loc_b=loc_b, std_b=std_b,
                   scaling_fn=scaling_fn, bn=bn,
                   weight_prior_params=weight_prior_params,
                   bias_prior_params=bias_prior_params, conv_prior_w=prior_w)
    for key, (path, old) in _prior_paths(model).items():
        parts = key.split(".")
        if parts[0] != "net" or parts[1] not in _DECREASING_DF:
            continue
        df = _DECREASING_DF[parts[1]]
        if df > 32.0:
            continue
        shape = old.shape
        is_conv = len(shape) == 4
        if is_conv:
            permute, event_dim = (1, 0, 2, 3), 3
        else:
            permute, event_dim = None, len(shape)
        scale_tril = std_w / int(np.prod(shape[1:])) ** 0.5
        loc = loc_w
        if is_conv and shape[-1] != 1 and prior_w is prior.ConvCorrelatedNormal:
            kernel = np.exp(-D.grid_distance_matrix(shape[-2], shape[-1]))
            scale_tril = np.linalg.cholesky(
                kernel + 1e-9 * np.eye(len(kernel))) * scale_tril
            loc = np.zeros([1]) + loc_w
        replace_prior(model, path, prior.MultivariateT(
            shape, loc, scale_tril, df=df, event_dim=event_dim,
            permute=permute))
    return model


def DataDrivenPreActResNet18(softmax_temp=1.0, width=64,
                             prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
                             prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                             scaling_fn=None, bn=True,
                             weight_prior_params={}, bias_prior_params={}):
    """PreActResNet18 without scaling, its priors loaded from fitted files
    named in `weight_prior_params` (JAX `data_driven.py:262-319`):
    `mean_covs_file` sets each named prior's mean and covariance (a number
    covariance as the std `scale`), `fits_dict_file` the generalised-normal
    fits of a FixedCovGenNorm model (`beta`, and `base_scale`, or `loc` and
    `scale` on the dense GenNorm)"""
    assert scaling_fn is None
    load_file_keys = ("mean_covs_file", "fits_dict_file")
    load_file = {k: v for k, v in weight_prior_params.items()
                 if k in load_file_keys}
    weight_prior_params = {k: v for k, v in weight_prior_params.items()
                           if k not in load_file_keys}
    model = ClassificationModel(
        PreActResNet(PreActBlock, [2, 2, 2, 2], bn=bn, prior_w=prior_w,
                     loc_w=loc_w, std_w=std_w, prior_b=prior_b, loc_b=loc_b,
                     std_b=std_b, scaling_fn=_no_scaling, in_planes=width,
                     weight_prior_params=weight_prior_params,
                     bias_prior_params=bias_prior_params),
        softmax_temp)
    paths = _prior_paths(model)
    if "mean_covs_file" in load_file:
        for k, (mean, cov) in read_fit(load_file["mean_covs_file"]).items():
            key = _strip_module(k)
            if key not in paths:
                continue
            _, p = paths[key]
            p.set_hyper("loc", float(mean) if isinstance(mean, Number)
                        else _to_np(mean))
            if isinstance(cov, Number):
                p.set_hyper("scale", float(cov) ** 0.5)
            else:
                assert isinstance(p, prior.ConvCovariance)
                p.assign_cov(_to_np(cov))
    if "fits_dict_file" in load_file:
        assert prior_w is prior.FixedCovGenNorm
        _, fits_dict = read_fit(load_file["fits_dict_file"])
        for k, fit in fits_dict.items():
            key = _strip_module(k)
            if key not in paths:
                continue
            _, p = paths[key]
            beta, gn_loc, gn_scale = fit["gennorm"][:3]
            p.set_hyper("beta", float(beta))
            if isinstance(p, prior.FixedCovGenNorm):
                p.set_hyper("base_scale", float(gn_scale))
            else:
                p.set_hyper("loc", float(gn_loc))
                p.set_hyper("scale", float(gn_scale))
    return model
