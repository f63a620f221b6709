"""Convolutional models with priors (counterpart of
`bnn_priors_tpu/models/conv_nets.py:24-124`): `Conv2dPrior` and the small
CNNs `ClassificationConvNet` and `CorrelatedClassificationConvNet`.

The CNNs take flat (B, C·H·W) or NCHW inputs, as the JAX ones do, and keep
their Sequential indices: image input 0, convolutions 1, 4, ..., the dense
layer last. They compute NCHW; the flatten before the dense layer reads
the activation in the JAX package's NHWC order (`FlattenHWC`), so the same
weights give the same function.
"""
from __future__ import annotations

from .. import priors as prior
from .base import ClassificationModel
from .dense_nets import LinearPrior
from .layers import Conv2d, FlattenHWC, ImageInput, MaxPool2d, ReLU, Sequential

__all__ = ("Conv2dPrior", "ClassificationConvNet",
           "CorrelatedClassificationConvNet")


def Conv2dPrior(in_channels, out_channels, kernel_size=3, stride=1, padding=0,
                dilation=1, groups=1, prior_w=prior.Normal, loc_w=0.0,
                std_w=1.0, prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                scaling_fn=None, weight_prior_params={}, bias_prior_params={}):
    """Conv layer whose weight std scales as std_w/sqrt(in_channels)
    (the reference scales by channels, not fan-in)."""
    if scaling_fn is None:
        def scaling_fn(std, dim):
            return std / dim ** 0.5
    ks = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
          else tuple(kernel_size))
    bias_prior = (prior_b((out_channels,), 0.0, std_b, **bias_prior_params)
                  if prior_b is not None else None)
    return Conv2d(
        weight_prior=prior_w((out_channels, in_channels // groups, ks[0], ks[1]),
                             loc_w, scaling_fn(std_w, in_channels),
                             **weight_prior_params),
        bias_prior=bias_prior, stride=stride, padding=padding,
        dilation=dilation, groups=groups)


def _conv_net(in_channels, img_height, out_features, width, depth,
              softmax_temp, conv_kw, first_params, later_params, dense_kw):
    "conv-relu-maxpool × (depth-1), then the dense layer"
    assert depth >= 2, "We can't have less than two layers"
    layers = [ImageInput(in_channels, img_height),
              Conv2dPrior(in_channels, width, kernel_size=3, padding=1,
                          weight_prior_params=first_params, **conv_kw),
              ReLU(), MaxPool2d(2)]
    for _ in range(depth - 2):
        layers += [Conv2dPrior(width, width, kernel_size=3, padding=1,
                               weight_prior_params=later_params, **conv_kw),
                   ReLU(), MaxPool2d(2)]
    layers.append(FlattenHWC(width))
    reshaped_size = width * (img_height // 2 ** (depth - 1)) ** 2
    layers.append(LinearPrior(reshaped_size, out_features, **dense_kw))
    return ClassificationModel(Sequential(*layers), softmax_temp)


def ClassificationConvNet(in_channels, img_height, out_features, width,
                          depth=3, softmax_temp=1.0, prior_w=prior.Normal,
                          loc_w=0.0, std_w=2 ** 0.5, prior_b=prior.Normal,
                          loc_b=0.0, std_b=1.0, scaling_fn=None,
                          weight_prior_params={}, bias_prior_params={}):
    "conv-relu-maxpool ×(depth-1) + linear (JAX conv_nets.py:58-82)"
    kw = dict(prior_w=prior_w, loc_w=loc_w, std_w=std_w, prior_b=prior_b,
              loc_b=loc_b, std_b=std_b, scaling_fn=scaling_fn,
              bias_prior_params=bias_prior_params)
    return _conv_net(in_channels, img_height, out_features, width, depth,
                     softmax_temp, kw, weight_prior_params,
                     weight_prior_params,
                     dict(kw, weight_prior_params=weight_prior_params))


def CorrelatedClassificationConvNet(in_channels, img_height, out_features,
                                    width, depth=3, softmax_temp=1.0,
                                    prior_w=prior.Normal, loc_w=0.0,
                                    std_w=2 ** 0.5, prior_b=prior.Normal,
                                    loc_b=0.0, std_b=1.0, scaling_fn=None,
                                    weight_prior_params={},
                                    bias_prior_params={}):
    """Same topology; the convolutions get `prior_w` (e.g.
    ConvCorrelatedNormal) with the lengthscale `lengthscale_1` for the
    first and `lengthscale_2` for the others, the dense layer a Normal with
    the remaining `weight_prior_params` (JAX conv_nets.py:85-124)"""
    wp1, wp2 = {}, {}
    if "lengthscale_1" in weight_prior_params:
        wp1["lengthscale"] = weight_prior_params["lengthscale_1"]
    if "lengthscale_2" in weight_prior_params:
        wp2["lengthscale"] = weight_prior_params["lengthscale_2"]
    dense_params = {k: v for k, v in weight_prior_params.items()
                    if k not in ("lengthscale_1", "lengthscale_2")}
    kw = dict(loc_w=loc_w, std_w=std_w, prior_b=prior_b, loc_b=loc_b,
              std_b=std_b, scaling_fn=scaling_fn,
              bias_prior_params=bias_prior_params)
    return _conv_net(in_channels, img_height, out_features, width, depth,
                     softmax_temp, dict(kw, prior_w=prior_w), wp1, wp2,
                     dict(kw, prior_w=prior.Normal,
                          weight_prior_params=dense_params))
