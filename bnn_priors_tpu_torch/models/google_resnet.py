"""CIFAR ResNet-20 ("googleresnet") from the cold-posterior paper
(counterpart of `bnn_priors_tpu/models/google_resnet.py:22-87`): depth
6n+2, filters 16→32→64, post-activation BasicBlocks.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .. import priors as prior
from .base import ClassificationModel
from .conv_nets import Conv2dPrior
from .dense_nets import LinearPrior
from .layers import AvgPool2d, BatchNorm2d, Flatten, Identity, ReLU, Sequential

__all__ = ("BasicBlock", "ResNet")


class BasicBlock(nn.Module):
    def __init__(self, in_filters, filters, stride, conv_kwargs, batchnorm):
        super().__init__()
        self.main = Sequential(
            Conv2dPrior(in_filters, filters, kernel_size=3, padding=1,
                        stride=stride, **conv_kwargs),
            batchnorm(filters),
            ReLU(),
            Conv2dPrior(filters, filters, kernel_size=3, padding=1, stride=1,
                        **conv_kwargs),
            batchnorm(filters))
        if stride == 1:
            self.shortcut = Identity()
        else:
            self.shortcut = Sequential(
                Conv2dPrior(in_filters, filters, kernel_size=1, padding=0,
                            stride=stride, **conv_kwargs),
                batchnorm(filters))

    def forward(self, x):
        return F.relu(self.main(x) + self.shortcut(x))


def ResNet(softmax_temp=1.0, depth=20, num_classes=10,
           prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
           prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
           scaling_fn=None, bn=True, conv_prior_w=prior.Normal):
    conv_kwargs = dict(prior_w=conv_prior_w, loc_w=loc_w, std_w=std_w,
                       prior_b=None, scaling_fn=scaling_fn)
    batchnorm = BatchNorm2d if bn else (lambda c: Identity())

    if (depth - 2) % 6 != 0:
        raise ValueError("depth must be 6n+2 (e.g. 20, 32, 44).")
    num_res_blocks = (depth - 2) // 6
    filters = 16

    layers = [
        Conv2dPrior(3, filters, kernel_size=3, padding=1, stride=1,
                    **conv_kwargs),
        batchnorm(filters),
        ReLU()]
    for stack in range(3):
        stride = 1 if stack == 0 else 2
        prev_filters = filters
        filters *= stride
        layers.append(BasicBlock(prev_filters, filters, stride, conv_kwargs,
                                 batchnorm))
        for _ in range(num_res_blocks - 1):
            layers.append(BasicBlock(filters, filters, 1, conv_kwargs,
                                     batchnorm))
    layers += [
        AvgPool2d(8),
        Flatten(),
        LinearPrior(filters, num_classes, prior_w=prior_w, loc_w=loc_w,
                    std_w=std_w, prior_b=prior_b, loc_b=loc_b, std_b=std_b,
                    scaling_fn=scaling_fn)]
    return ClassificationModel(Sequential(*layers), softmax_temp=softmax_temp)
