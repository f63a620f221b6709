"""NN layers parameterized by priors (counterpart of
`bnn_priors_tpu/models/layers.py`).

Layers are `nn.Module`s whose forward pulls the effective weight from their
`weight_prior` child. Inputs are NCHW and convolution weights OIHW, as in the
JAX package's public API and storage, so weights carry over unchanged (the
JAX package computes NHWC internally; here the convolution runs NCHW).

K chains in one pass. When a layer's parameters carry a leading chain axis
(`torch.func.functional_call` with `(K, ...)` tensors, see
`Model.net_apply_chains`), the chains are folded into channel groups: the
activations are `(B, K·C, H, W)` with chain k's channels at
`[k·C, (k+1)·C)`, a convolution runs with `groups=K·groups` on the
`(K·O, I, kH, kW)` weights, batchnorm normalises the K·C channels with the
chains' `(K, C)` running statistics viewed as `(K·C,)` (updated in place in
train mode, so they stay one cuDNN call), and a dense layer is one batched
matmul over the chains. This is what XLA makes of the JAX package's vmapped
convolution. It was chosen over `torch.func.vmap` of the single-chain
network: vmap's convolution batching rule makes the same grouped
convolution, but vmap refuses the in-place update of the module's own
running statistics, so it would need a batchnorm that takes and returns
them; folded, batchnorm stays one call that updates every chain's
statistics in place.

Matmul precision. Under `precision.matmul_precision` in a bf16 or f16
mode, `Linear` and `Conv2d` run their products on float32 operands cast
to that type (`reduced_operand`), forward and backward, and add the bias
after, in float32; their result is float32, rounded once to the operand
type by the product (see `precision.py`). The K-chain `Linear` then adds
the bias outside its batched product.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..precision import operand_dtype
from ..priors.base import Prior

__all__ = ("Linear", "Conv2d", "Sequential", "ReLU", "MaxPool2d", "AvgPool2d",
           "Flatten", "FlattenHWC", "ImageInput", "Identity", "BatchNorm2d")

# children named "0", "1", ... as in the JAX package's Sequential
Sequential = nn.Sequential
ReLU = nn.ReLU
Identity = nn.Identity


def reduced_operand(x, w):
    """the type the product of `x` and `w` runs on under the matmul
    precision: bf16 or f16 for float32 operands in those modes, else None
    (the product as it is)"""
    dt = operand_dtype()
    if dt is None or x.dtype != torch.float32 or w.dtype != torch.float32:
        return None
    return dt


class Linear(nn.Module):
    def __init__(self, weight_prior: Prior, bias_prior: Optional[Prior] = None):
        super().__init__()
        self.out_features, self.in_features = weight_prior.shape
        self.weight_prior = weight_prior
        self.bias_prior = bias_prior

    def forward(self, x):
        w = self.weight_prior()
        b = self.bias_prior() if self.bias_prior is not None else None
        dt = reduced_operand(x, w)
        if w.ndim == 3:  # K chains: (B, K·F) -> (B, K·O)
            K, B = w.shape[0], x.shape[0]
            xk = x.reshape(B, K, -1).transpose(0, 1)       # (K, B, F)
            if dt is not None:
                out = torch.bmm(xk.to(dt), w.to(dt).transpose(1, 2)).float()
                if b is not None:
                    out = out + b[:, None, :]
                return out.transpose(0, 1).reshape(B, -1)
            if b is not None:
                # the bias as one more column of the product: its gradient
                # is then a product a chain, whatever K (a broadcast add's
                # is a reduction whose order depends on K·O)
                xk = torch.cat([xk, xk.new_ones(K, B, 1)], -1)
                w = torch.cat([w, b[:, :, None]], -1)
            out = torch.bmm(xk, w.transpose(1, 2))          # (K, B, O)
            return out.transpose(0, 1).reshape(B, -1)
        if dt is not None:
            out = F.linear(x.to(dt), w.to(dt)).float()
            return out if b is None else out + b
        return F.linear(x, w, b)


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
        w = self.weight_prior()
        b = self.bias_prior() if self.bias_prior is not None else None
        groups = self.groups
        if w.ndim == 5:  # K chains: (K, O, I, kH, kW) as K channel groups
            K = w.shape[0]
            w = w.reshape(K * w.shape[1], *w.shape[2:])
            b = None if b is None else b.reshape(-1)
            groups *= K
        dt = reduced_operand(x, w)
        if dt is not None:
            out = F.conv2d(x.to(dt), w.to(dt), None, self.stride,
                           self.padding, self.dilation, groups).float()
            return out if b is None else out + b[:, None, None]
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                        groups)


class Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class FlattenHWC(nn.Module):
    """Flatten NCHW activations in (h, w, c) order: the JAX package computes
    NHWC and its `Flatten` reads the NHWC activation, so a dense weight
    after it takes its columns in that order. On the chain fold (B, K·C,
    H, W) becomes (B, K·H·W·C), chain k's features contiguous, as the
    chain `Linear` reads them; K is the channels over `channels`."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels

    def forward(self, x):
        B, KC, H, W = x.shape
        x = x.reshape(B, KC // self.channels, self.channels, H, W)
        return x.permute(0, 1, 3, 4, 2).reshape(B, -1)


class ImageInput(nn.Module):
    """Flat inputs (B, C·H·W) as square images (B, C, H, W) (the conv nets'
    input, `conv_nets.py:44-55` of the JAX package); on the chain fold
    (B, K·C·H·W) becomes (B, K·C, H, W), chain k's channels contiguous.
    Image inputs pass through."""

    def __init__(self, in_channels: int, img_height: int):
        super().__init__()
        self.in_channels = in_channels
        self.img_height = img_height

    def forward(self, x):
        if x.ndim == 2:
            x = x.reshape(x.shape[0], -1, self.img_height, self.img_height)
        return x


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size: int, stride: Optional[int] = None,
                 padding: int = 0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.padding = padding

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


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
        mean, var = self.running_mean, self.running_var
        if w.ndim == 2:  # K chains: (K, C) rows as the K·C channel groups
            w, b = w.reshape(-1), b.reshape(-1)
            mean, var = mean.view(-1), var.view(-1)  # views: updated in place
        if w.dtype != mean.dtype:
            # reduced-precision compute: affine parameters join the float32
            # statistics (mixed-type batch_norm), output stays in x.dtype
            w, b = w.to(mean.dtype), b.to(mean.dtype)
        if self.training:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, mean, var, w, b, self.training, self.momentum,
                            self.eps)
