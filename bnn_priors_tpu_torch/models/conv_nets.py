"""Convolutional models with priors (counterpart of
`bnn_priors_tpu/models/conv_nets.py`): `Conv2dPrior`, the small CNNs
`ClassificationConvNet` and `CorrelatedClassificationConvNet`, and the
PreAct ResNets (`PreActResNet18`, its width-16 `ThinPreActResNet18`,
`PreActResNet34`).

The CNNs take flat (B, C·H·W) or NCHW inputs, as the JAX ones do, and keep
their Sequential indices: image input 0, convolutions 1, 4, ..., the dense
layer last. They compute NCHW; the flatten before the dense layer reads
the activation in the JAX package's NHWC order (`FlattenHWC`), so the same
weights give the same function. The ResNets take NCHW images and keep the
JAX names (`net.conv1`, `net.layer{1..4}.{i}.bn1/conv1/bn2/conv2`,
`….shortcut.0`, `net.linear`); their spatial mean before `linear` reads
no layout.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .. import priors as prior
from .base import ClassificationModel
from .dense_nets import LinearPrior
from .layers import (BatchNorm2d, Conv2d, FlattenHWC, Identity, ImageInput,
                     MaxPool2d, ReLU, Sequential)

__all__ = ("Conv2dPrior", "ClassificationConvNet",
           "CorrelatedClassificationConvNet", "PreActBlock", "PreActResNet",
           "PreActResNet18", "ThinPreActResNet18", "PreActResNet34")


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
              softmax_temp, first_kw, later_kw, dense_kw):
    """conv-relu-maxpool × (depth-1), then the dense layer; the first
    convolution's prior arguments, the later ones' and the dense layer's"""
    assert depth >= 2, "We can't have less than two layers"
    layers = [ImageInput(in_channels, img_height),
              Conv2dPrior(in_channels, width, kernel_size=3, padding=1,
                          **first_kw),
              ReLU(), MaxPool2d(2)]
    for _ in range(depth - 2):
        layers += [Conv2dPrior(width, width, kernel_size=3, padding=1,
                               **later_kw),
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
              weight_prior_params=weight_prior_params,
              bias_prior_params=bias_prior_params)
    return _conv_net(in_channels, img_height, out_features, width, depth,
                     softmax_temp, kw, kw, kw)


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
    conv_kw = dict(kw, prior_w=prior_w)
    return _conv_net(in_channels, img_height, out_features, width, depth,
                     softmax_temp, dict(conv_kw, weight_prior_params=wp1),
                     dict(conv_kw, weight_prior_params=wp2),
                     dict(kw, prior_w=prior.Normal,
                          weight_prior_params=dense_params))


class PreActBlock(nn.Module):
    """Pre-activation BasicBlock (JAX `conv_nets.py:127-165`): bn1, relu,
    conv1, bn2, relu, conv2, plus the shortcut, a 1x1 convolution of the
    post-relu activation where the stride or the width changes, else the
    input. The convolutions have no bias; `bn=False` puts identities in
    the batchnorms' places."""
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, bn=True,
                 prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
                 prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                 scaling_fn=None, weight_prior_params={}, bias_prior_params={}):
        super().__init__()
        batchnorm = BatchNorm2d if bn else (lambda c: Identity())
        kw = dict(prior_w=prior_w, loc_w=loc_w, std_w=std_w, prior_b=None,
                  scaling_fn=scaling_fn, weight_prior_params=weight_prior_params,
                  bias_prior_params=bias_prior_params)
        self.bn1 = batchnorm(in_planes)
        self.conv1 = Conv2dPrior(in_planes, planes, kernel_size=3,
                                 stride=stride, padding=1, **kw)
        self.bn2 = batchnorm(planes)
        self.conv2 = Conv2dPrior(planes, planes, kernel_size=3, stride=1,
                                 padding=1, **kw)
        self.has_shortcut = stride != 1 or in_planes != self.expansion * planes
        if self.has_shortcut:
            self.shortcut = Sequential(
                Conv2dPrior(in_planes, self.expansion * planes, kernel_size=1,
                            stride=stride, **kw))

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = self.shortcut(out) if self.has_shortcut else x
        out = self.conv2(F.relu(self.bn2(self.conv1(out))))
        return out + shortcut


class PreActResNet(nn.Module):
    """conv1 (3 input channels), four stages of `block`s at widths
    in_planes·(1, 2, 4, 8), the spatial mean, then `linear` (JAX
    `conv_nets.py:167-220`). The dense layer's prior is `prior_w`, except
    that the kernel-shaped priors become their elementwise kin:
    ConvCorrelatedNormal and FixedCovNormal a Normal, FixedCovGenNorm a
    GenNorm."""

    def __init__(self, block, num_blocks, num_classes=10, bn=True,
                 prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
                 prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                 in_planes=64, scaling_fn=None,
                 weight_prior_params={}, bias_prior_params={}):
        super().__init__()
        self.in_planes = in_planes
        kw = dict(bn=bn, prior_w=prior_w, loc_w=loc_w, std_w=std_w,
                  prior_b=prior_b, loc_b=loc_b, std_b=std_b,
                  scaling_fn=scaling_fn, weight_prior_params=weight_prior_params,
                  bias_prior_params=bias_prior_params)
        if prior_w in (prior.ConvCorrelatedNormal, prior.FixedCovNormal):
            dense_prior_w = prior.Normal
        elif prior_w is prior.FixedCovGenNorm:
            dense_prior_w = prior.GenNorm
        else:
            dense_prior_w = prior_w
        self.conv1 = Conv2dPrior(3, in_planes, kernel_size=3, stride=1,
                                 padding=1, prior_b=None, prior_w=prior_w,
                                 loc_w=loc_w, std_w=std_w, scaling_fn=scaling_fn,
                                 weight_prior_params=weight_prior_params,
                                 bias_prior_params=bias_prior_params)
        self.layer1 = self._make_layer(block, in_planes, num_blocks[0], 1, kw)
        self.layer2 = self._make_layer(block, 2 * in_planes, num_blocks[1], 2,
                                       kw)
        self.layer3 = self._make_layer(block, 4 * in_planes, num_blocks[2], 2,
                                       kw)
        self.layer4 = self._make_layer(block, 8 * in_planes, num_blocks[3], 2,
                                       kw)
        self.linear = LinearPrior(8 * in_planes, num_classes,
                                  prior_w=dense_prior_w, loc_w=loc_w,
                                  std_w=std_w, prior_b=prior_b, loc_b=loc_b,
                                  std_b=std_b, scaling_fn=scaling_fn,
                                  weight_prior_params=weight_prior_params,
                                  bias_prior_params=bias_prior_params)

    def _make_layer(self, block, planes, num_blocks, stride, kw):
        layers = []
        for s in [stride] + [1] * (num_blocks - 1):
            layers.append(block(self.in_planes, planes, s, **kw))
            self.in_planes = planes * block.expansion
        return Sequential(*layers)

    def forward(self, x):
        out = self.conv1(x)
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        # the mean over the 4x4 map: avg_pool2d(4) at 32x32 inputs
        return self.linear(out.mean(dim=(2, 3)))


def PreActResNet18(softmax_temp=1.0, width=64, prior_w=prior.Normal,
                   loc_w=0.0, std_w=2 ** 0.5, prior_b=prior.Normal, loc_b=0.0,
                   std_b=1.0, scaling_fn=None, bn=True,
                   weight_prior_params={}, bias_prior_params={}):
    """[2, 2, 2, 2] blocks at `width` (JAX `conv_nets.py:222-240`);
    `weight_prior_params["lengthscale_dict_file"]` loads fitted per-layer
    lengthscales into the convolutions' priors (`load_lengthscales`)"""
    file = weight_prior_params.get("lengthscale_dict_file")
    weight_prior_params = {k: v for k, v in weight_prior_params.items()
                           if k != "lengthscale_dict_file"}
    model = ClassificationModel(
        PreActResNet(PreActBlock, [2, 2, 2, 2], bn=bn, prior_w=prior_w,
                     loc_w=loc_w, std_w=std_w, prior_b=prior_b, loc_b=loc_b,
                     std_b=std_b, scaling_fn=scaling_fn, in_planes=width,
                     weight_prior_params=weight_prior_params,
                     bias_prior_params=bias_prior_params),
        softmax_temp)
    if file is not None:
        from .data_driven import load_lengthscales
        load_lengthscales(model, file)
    return model


def ThinPreActResNet18(softmax_temp=1.0, prior_w=prior.Normal, loc_w=0.0,
                       std_w=2 ** 0.5, prior_b=prior.Normal, loc_b=0.0,
                       std_b=1.0, scaling_fn=None, bn=True,
                       weight_prior_params={}, bias_prior_params={}):
    "PreActResNet18 at width 16 (JAX `conv_nets.py:243-249`)"
    return PreActResNet18(softmax_temp, 16, prior_w, loc_w, std_w, prior_b,
                          loc_b, std_b, scaling_fn, bn, weight_prior_params,
                          bias_prior_params)


def PreActResNet34(softmax_temp=1.0, prior_w=prior.Normal, loc_w=0.0,
                   std_w=2 ** 0.5, prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                   scaling_fn=None, bn=True, weight_prior_params={},
                   bias_prior_params={}):
    "[3, 4, 6, 3] blocks at width 64 (JAX `conv_nets.py:252-262`)"
    return ClassificationModel(
        PreActResNet(PreActBlock, [3, 4, 6, 3], bn=bn, prior_w=prior_w,
                     loc_w=loc_w, std_w=std_w, prior_b=prior_b, loc_b=loc_b,
                     std_b=std_b, scaling_fn=scaling_fn,
                     weight_prior_params=weight_prior_params,
                     bias_prior_params=bias_prior_params),
        softmax_temp)
