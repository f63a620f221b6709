"""NN layers parameterized by priors (counterpart of
`bnn_priors_tpu/models/layers.py`).

Layers are `nn.Module`s whose forward pulls the effective weight from their
`weight_prior` child. Inputs are NCHW and convolution weights OIHW, as in the
JAX package's public API and storage, so weights carry over unchanged (the
JAX package computes NHWC internally; here the convolution runs NCHW).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..priors.base import Prior

__all__ = ("Linear", "Conv2d", "Sequential", "ReLU", "AvgPool2d", "Flatten",
           "Identity", "BatchNorm2d")

# children named "0", "1", ... as in the JAX package's Sequential
Sequential = nn.Sequential
ReLU = nn.ReLU
Identity = nn.Identity


class Linear(nn.Module):
    def __init__(self, weight_prior: Prior, bias_prior: Optional[Prior] = None):
        super().__init__()
        self.out_features, self.in_features = weight_prior.shape
        self.weight_prior = weight_prior
        self.bias_prior = bias_prior

    def forward(self, x):
        b = self.bias_prior() if self.bias_prior is not None else None
        return F.linear(x, self.weight_prior(), b)


class Conv2d(nn.Module):
    """2D convolution, weight shape (O, I/groups, kH, kW) like torch."""

    def __init__(self, weight_prior: Prior, bias_prior: Optional[Prior] = None,
                 stride: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0,
                 dilation: Union[int, Sequence[int]] = 1, groups: int = 1):
        super().__init__()
        as_pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)
        self.stride = as_pair(stride)
        self.padding = as_pair(padding)
        self.dilation = as_pair(dilation)
        self.groups = groups
        self.out_channels, in_channels, kh, kw = weight_prior.shape
        self.in_channels = in_channels * groups
        self.kernel_size = (kh, kw)
        self.weight_prior = weight_prior
        self.bias_prior = bias_prior

    def forward(self, x):
        b = self.bias_prior() if self.bias_prior is not None else None
        return F.conv2d(x, self.weight_prior(), b, self.stride, self.padding,
                        self.dilation, self.groups)


class Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class AvgPool2d(nn.Module):
    def __init__(self, kernel_size: int, stride: Optional[int] = None,
                 padding: int = 0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.padding = padding

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            count_include_pad=True)


class BatchNorm2d(nn.Module):
    """Batchnorm with torch semantics: batch statistics in training (biased
    variance for normalisation, unbiased n/(n-1) for the running update,
    `momentum` 0.1, `eps` 1e-5), running statistics at eval. The running
    statistics are module buffers, updated in place in train mode, and are
    part of every saved sample.

    Batch statistics are taken in float32 for float32 and lower-precision
    inputs (bfloat16 compute), and in float64 for float64 inputs. (The JAX
    package takes them in float32 even under x64, `layers.py:213-218`.)
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self):
        "initial state: unit scale, zero shift, fresh running statistics"
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.dtype != self.running_mean.dtype:
            # reduced-precision compute: affine parameters join the float32
            # statistics (mixed-type batch_norm), output stays in x.dtype
            w, b = w.to(self.running_mean.dtype), b.to(self.running_mean.dtype)
        if self.training:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, self.running_mean, self.running_var, w, b,
                            self.training, self.momentum, self.eps)
