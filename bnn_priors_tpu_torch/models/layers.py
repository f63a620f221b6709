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

Matmul precision. Under `precision.matmul_precision` in a mode that
changes the arithmetic of float32 products (`product_mode`), `Linear` and
`Conv2d` run their forward product, dgrad and wgrad in it and add the
bias after, in float32; the K-chain `Linear` then adds the bias outside
its batched product. A split mode (bf16 or f16 parts, `precision.py`)
runs each of the three as ONE library product in float32 over the
operands' parts, written by `ops.split_operand` side by side along the
product's contraction axis, so that the product sums the mode's pairs:

| product | convolution | dense (K chains batched, K = 1 for one) |
|---|---|---|
| forward x·w | input channels within a group | F of x (B, K, P·F) and w (K, O, P·F) |
| dgrad g·w | output channels within a group | O of g (B, K, P·O) and w (K, P·O, F) |
| wgrad g·x | the batch | the batch, (K, P·B, ·) |

(P pairs; with one part every layout is the operand's own, so the
forward's rounded operands serve the backward and the gradient is split
once.) A cast mode (f16 result, float64) casts the operands, runs the
product in that type and casts its result to float32; autograd then
casts the incoming gradient likewise.

Split ahead. A weight is a view of the chain's flat position, and its
parts are a function of the position alone, so a runner splits every
layer's weight once an evaluation (a minibatch step, an exact pass, a
test pass), in one launch of the table form (`split_weights`), instead of
once a layer a call; in the dgrad's layout too only where the evaluation
takes a gradient. A layer finds its weight's parts by the tensor it
was given: the same address, shape and strides in the position the
evaluation split, unchanged since. A prior that transforms its leaf
(`LogNormal`, `PositiveImproper`, the transformed priors) hands the layer
a fresh tensor, so it is not found, and the layer splits as it does
without a runner; so does the K-chain fold (a reshaped weight) and every
caller outside the runners. Within the evaluation a forward input that
two products take in one layout (ResNet-20's projection shortcut and its
block's first convolution read the same x) is split once: the last two
inputs split are kept, by identity and version. The gradient for w stays
the product's gradient, straight through the rounding.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.split_operand import SplitTable, split_operand, split_table
from ..precision import active_mode
from ..priors.base import Prior, join

__all__ = ("Linear", "Conv2d", "Sequential", "ReLU", "MaxPool2d", "AvgPool2d",
           "Flatten", "FlattenHWC", "ImageInput", "Identity", "BatchNorm2d",
           "split_weights")

# children named "0", "1", ... as in the JAX package's Sequential
Sequential = nn.Sequential
ReLU = nn.ReLU
Identity = nn.Identity


def product_mode(x, w):
    """the matmul precision's mode for the product of `x` and `w` where it
    changes their arithmetic: a split or cast mode and float32 operands;
    else None (the product as it is)"""
    mode = active_mode()
    if (mode is None or mode.operand is None or x.dtype != torch.float32
            or w.dtype != torch.float32):
        return None
    return mode


_SELECTS: dict = {}


def _select(mode, side):
    """the part that side 0 (the left operand) or 1 (the right) takes in
    each of the mode's pairs"""
    key = (mode.name, side)
    sel = _SELECTS.get(key)
    if sel is None:
        sel = _SELECTS[key] = tuple(pair[side] for pair in mode.pairs)
    return sel


def _parts(t, mode, rows, side):
    """t's parts as (rows, P, ·) (`split_operand`): block p the part that
    side `side` takes in the mode's pair p"""
    return split_operand(t, mode.parts, mode.operand, _select(mode, side),
                         rows)


# the evaluation's operands split ahead (`split_weights`), or None
_SPLIT: contextvars.ContextVar = contextvars.ContextVar("split_operands",
                                                        default=None)
# {model: {packer: {mode name: _WeightPlan}}}, built at first use
_PLANS = weakref.WeakKeyDictionary()


def _base_of(position):
    "the tensor that holds a position's leaves: itself, a SegVec's buffer"
    return position if torch.is_tensor(position) else getattr(
        position, "base", None)


class _WeightPlan:
    """a model's weights in a packer's layout under one split mode: the
    table of their layouts (forward, and at P > 1 dgrad where `backward`),
    and where each leaf lies in the position, {(offset, shape, strides):
    {rows: entry}}"""

    def __init__(self, model, packer, position, mode, backward):
        views, base = packer.unpack(position), _base_of(position)
        P = len(mode.pairs)
        ops, self.where = [], {}
        for path, layer in model.named_modules():
            if not isinstance(layer, (Conv2d, Linear)):
                continue
            name = join(path, "weight_prior.p")
            if (type(layer.weight_prior).forward is not Prior.forward
                    or name not in views):
                continue  # a transformed leaf: the layer splits it itself
            v = views[name]
            off = v.data_ptr() - base.data_ptr()
            if (v.dtype != torch.float32 or not v.is_contiguous()
                    or v.untyped_storage().data_ptr()
                    != base.untyped_storage().data_ptr() or off % 4):
                continue
            key = (off // 4, tuple(v.shape), v.stride())
            if key in self.where:
                continue
            # forward: a row an output channel; dgrad: a row a group
            rows = (1,) if P == 1 else tuple(dict.fromkeys((
                v.shape[0], layer.groups if isinstance(layer, Conv2d)
                else 1)[:1 + backward]))
            self.where[key] = {r: len(ops) + i for i, r in enumerate(rows)}
            ops += [(off // 4, r, v.numel() // r) for r in rows]
        self.one_part = P == 1
        self.table = (SplitTable(ops, mode.parts, mode.operand,
                                 _select(mode, 1)) if ops else None)


class _Split:
    """one evaluation's operands split ahead: the weights' parts (one
    launch), and the last two forward inputs split"""

    def __init__(self, plan, base):
        self.plan, self.base = plan, base
        self.version, self.ptr = base._version, base.data_ptr()
        self.arena = split_table(base, plan.table)
        self.inputs = []

    def weight(self, w, rows):
        "w's parts as (rows, P, M), split ahead; None where w is not found"
        off = w.data_ptr() - self.ptr
        if off % 4 or self.base._version != self.version:
            return None
        layouts = self.plan.where.get((off // 4, w.shape, w.stride()))
        if layouts is None or w.device != self.base.device:
            return None
        table = self.plan.table
        if self.plan.one_part:  # every layout is the weight's own
            return table.view(self.arena, layouts[1]).view(rows, 1, -1)
        i = layouts.get(rows)
        return None if i is None else table.view(self.arena, i)

    def input(self, x, mode, rows):
        "x's left-side parts in `rows` rows, split once an evaluation"
        for t, version, r, parts in self.inputs:
            if t is x and version == x._version and r == rows:
                return parts
        parts = _parts(x, mode, rows, 0)
        self.inputs = [(x, x._version, rows, parts)] + self.inputs[:1]
        return parts


@contextlib.contextmanager
def split_weights(model, packer, position, backward=True):
    """the block as one evaluation of `model` at `position` (one chain,
    in `packer`'s layout) under the active split mode: every multiplying
    layer's weight that is a view of the position is split once, in one
    launch, and the layers take those parts; with `backward` false
    (an evaluation that takes no gradient) only in the forward's layout.
    The position must not change inside the block. A plain block where
    no split mode is active."""
    mode, base = active_mode(), _base_of(position)
    if (mode is None or not mode.parts or base is None
            or base.dtype != torch.float32 or base.ndim != 1
            or not base.is_contiguous() or packer.lead_of(position) != ()):
        yield None
        return
    plans = _PLANS.setdefault(model, weakref.WeakKeyDictionary())
    per = plans.get(packer)
    if per is None:
        per = plans[packer] = {}
    key = (mode.name, bool(backward))
    plan = per.get(key)
    if plan is None:
        plan = per[key] = _WeightPlan(model, packer, position, mode,
                                      bool(backward))
    if plan.table is None:
        yield None
        return
    split = _Split(plan, base)
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)


def _weight_parts(split, w, mode, rows):
    "w's right-side parts in `rows` rows: split ahead, else now"
    parts = None if split is None else split.weight(w, rows)
    return _parts(w, mode, rows, 1) if parts is None else parts


def _input_parts(split, x, mode, rows):
    "x's left-side parts in `rows` rows, once an evaluation under `split`"
    return (_parts(x, mode, rows, 0) if split is None
            else split.input(x, mode, rows))


class SplitConv2d(torch.autograd.Function):
    """`F.conv2d(x, w, None, stride, padding, dilation, groups)` under a
    split mode: forward, dgrad and wgrad each one float32 convolution over
    its operands' parts (see the module's docstring). `split`: the
    evaluation's operands split ahead (`split_weights`), or None."""

    @staticmethod
    def forward(ctx, x, w, mode, split, stride, padding, dilation, groups):
        B, C = x.shape[:2]
        P = len(mode.pairs)
        xs = _input_parts(split, x, mode, B * groups).view(
            B, P * C, *x.shape[2:])
        ws = _weight_parts(split, w, mode, w.shape[0]).view(
            w.shape[0], P * w.shape[1], *w.shape[2:])
        # the dgrad's layout, looked up here: the backward runs outside
        # the evaluation's context
        ctx.wd = None if P == 1 or split is None else split.weight(w, groups)
        ctx.mode, ctx.shapes = mode, (x.shape, w.shape)
        ctx.conv = (stride, padding, dilation, groups)
        ctx.save_for_backward(*((xs, ws) if P == 1 else (x, w)))
        return F.conv2d(xs, ws, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        a, b = ctx.saved_tensors
        mode, (xshape, wshape) = ctx.mode, ctx.shapes
        stride, padding, dilation, groups = ctx.conv
        B, O = gy.shape[:2]
        P = len(mode.pairs)
        gy = gy.contiguous()
        need_x, need_w = ctx.needs_input_grad[:2]
        back = lambda g, x, w, mask: torch.ops.aten.convolution_backward(
            g, x, w, None, stride, padding, dilation, False, [0, 0], groups,
            mask)
        if P == 1:  # the saved parts and the gradient's serve both products
            g = _parts(gy, mode, 1, 0).view(gy.shape)
            dx, dw, _ = back(g, a, b, (need_x, need_w, False))
            return dx, dw, None, None, None, None, None, None
        dx = dw = None
        if need_x:
            gs = _parts(gy, mode, B * groups, 0).view(B, P * O, *gy.shape[2:])
            wd = ctx.wd if ctx.wd is not None else _parts(b, mode, groups, 1)
            wd = wd.view(P * O, *wshape[1:])
            dx = back(gs, gs.new_empty(1).expand(xshape), wd,
                      (True, False, False))[0]
        if need_w:
            gw = _parts(gy, mode, 1, 0).view(P * B, *gy.shape[1:])
            xw = _parts(a, mode, 1, 1).view(P * B, *xshape[1:])
            dw = back(gw, xw, gw.new_empty(1).expand(wshape),
                      (False, True, False))[1]
        return dx, dw, None, None, None, None, None, None


class SplitLinear(torch.autograd.Function):
    """The layers' dense product under a split mode: x (B, F) by w (O, F)
    into (B, O), or K chains' x (B, K·F) by w (K, O, F) into (B, K·O), each
    chain's product batched; forward, dgrad and wgrad each one float32
    product over its operands' parts (see the module's docstring).
    `split`: the evaluation's operands split ahead, or None."""

    @staticmethod
    def forward(ctx, x, w, mode, split):
        K = w.shape[0] if w.ndim == 3 else 1
        (O, Fi), B, P = w.shape[-2:], x.shape[0], len(mode.pairs)
        xs = _input_parts(split, x, mode, B * K)         # (B·K, P, F)
        ws = _weight_parts(split, w, mode, K * O)        # (K·O, P, F)
        ctx.wd = None if P == 1 or split is None else split.weight(w, K)
        if w.ndim == 2:
            out = F.linear(xs.view(B, P * Fi), ws.view(O, P * Fi))
        else:
            out = torch.bmm(xs.view(B, K, P * Fi).transpose(0, 1),
                            ws.view(K, O, P * Fi).transpose(1, 2))
            out = out.transpose(0, 1).reshape(B, K * O)
        ctx.mode = mode
        ctx.save_for_backward(*((xs.view_as(x), ws.view_as(w)) if P == 1
                                else (x, w)))
        return out

    @staticmethod
    def backward(ctx, gy):
        a, b = ctx.saved_tensors
        mode = ctx.mode
        K = b.shape[0] if b.ndim == 3 else 1
        (O, Fi), B, P = b.shape[-2:], gy.shape[0], len(mode.pairs)
        gy = gy.contiguous()
        g1 = _parts(gy, mode, 1, 0) if P == 1 else None
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gs, wd = (g1, b) if P == 1 else (
                _parts(gy, mode, B * K, 0),
                ctx.wd if ctx.wd is not None else _parts(b, mode, K, 1))
            dx = torch.bmm(gs.view(B, K, P * O).transpose(0, 1),
                           wd.view(K, P * O, Fi))
            dx = dx.transpose(0, 1).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            gw, xw = (g1, a) if P == 1 else (_parts(gy, mode, 1, 0),
                                             _parts(a, mode, 1, 1))
            dw = torch.bmm(gw.view(P * B, K, O).permute(1, 2, 0),
                           xw.view(P * B, K, Fi).transpose(0, 1))
            dw = dw.view(b.shape)
        return dx, dw, None, None


def _dense(x, w, mode):
    """x (B, F) by w (O, F), or K chains' x (B, K·F) by w (K, O, F), under
    a split or cast mode, no bias: (B, O) or (B, K·O) float32"""
    if mode.parts:
        return SplitLinear.apply(x, w, mode, _SPLIT.get())
    xc, wc = x.to(mode.operand), w.to(mode.operand)
    if w.ndim == 2:
        return F.linear(xc, wc).float()
    K, B = w.shape[0], x.shape[0]
    out = torch.bmm(xc.reshape(B, K, -1).transpose(0, 1), wc.transpose(1, 2))
    return out.float().transpose(0, 1).reshape(B, -1)


class Linear(nn.Module):
    def __init__(self, weight_prior: Prior, bias_prior: Optional[Prior] = None):
        super().__init__()
        self.out_features, self.in_features = weight_prior.shape
        self.weight_prior = weight_prior
        self.bias_prior = bias_prior

    def forward(self, x):
        w = self.weight_prior()
        b = self.bias_prior() if self.bias_prior is not None else None
        mode = product_mode(x, w)
        if mode is not None:
            lead = x.shape[:-1] if w.ndim == 2 else x.shape[:1]
            out = _dense(x.reshape(-1, x.shape[-1]), w, mode)
            out = out.reshape(*lead, out.shape[-1])
            return out if b is None else out + b.reshape(-1)
        if w.ndim == 3:  # K chains: (B, K·F) -> (B, K·O)
            K, B = w.shape[0], x.shape[0]
            xk = x.reshape(B, K, -1).transpose(0, 1)       # (K, B, F)
            if b is not None:
                # the bias as one more column of the product: its gradient
                # is then a product a chain, whatever K (a broadcast add's
                # is a reduction whose order depends on K·O)
                xk = torch.cat([xk, xk.new_ones(K, B, 1)], -1)
                w = torch.cat([w, b[:, :, None]], -1)
            out = torch.bmm(xk, w.transpose(1, 2))          # (K, B, O)
            return out.transpose(0, 1).reshape(B, -1)
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
        mode = product_mode(x, w)
        if mode is None:
            return F.conv2d(x, w, b, self.stride, self.padding,
                            self.dilation, groups)
        if mode.parts:
            out = SplitConv2d.apply(x, w, mode, _SPLIT.get(), self.stride,
                                    self.padding, self.dilation, groups)
        else:
            dt = mode.operand
            out = F.conv2d(x.to(dt), w.to(dt), None, self.stride,
                           self.padding, self.dilation, groups).float()
        return out if b is None else out + b[:, None, None]


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
