"""Matmul precision on the card: the JAX key `matmul_precision`
(`jax_default_matmul_precision`; the JAX runner wraps every dispatch in
`jax.default_matmul_precision`, `bnn_priors_tpu/inference/runner.py:
59,109-113,202-215`) as a mode of the port's two multiplying layers,
`models/layers.py`'s `Linear` and `Conv2d`.

| JAX value | On the TPU | On the card |
|---|---|---|
| `float32`, `highest`, `F32_F32_F32` | ≈ f32 | f32 operands, TF32 off for cuBLAS and cuDNN |
| `tensorfloat32`, `high`, `TF32_TF32_F32` | 3-pass bf16 | TF32 on for cuBLAS and cuDNN |
| `bfloat16`, `default`, `BF16_BF16_F32` | 1-pass bf16, f32 accumulation | bf16 operands, f32 accumulation, f32 activations between layers |
| `F16_F16_F32` | — | f16 operands, f32 accumulation |

Every other value JAX takes raises ValueError, naming the families above:
the F8 presets, the split-bf16 presets (`_X3`, `_X6`, `_X9`),
`F16_F16_F16`, `BF16_BF16_BF16` and `F64_F64_F64` ask for what the card
cannot do through PyTorch. None leaves the process as it is, as in JAX.

`matmul_precision(value)` is the mode as a context. In the bf16 and f16
modes the two layers cast float32 operands (the input, the weight and, in
the backward pass, the incoming gradient) to that type, so the forward
product, dgrad and wgrad all run on them; the bias is added after, in
float32, and the gradient reaching a float32 parameter is float32.
PyTorch's convolution writes its result in the operands' type, so each
product's float32 accumulator is rounded to bf16 (f16) once on the way
out and widened again: that rounding is part of the mode (relative error
at most 2^-8 in bf16). cuBLAS's reduced-precision split-K reduction is
turned off in these modes, so products accumulate in float32 throughout.
Everything else (activations, batchnorm, the likelihood, the prior, the
chain update) stays float32, as JAX's key touches only dots and
convolutions. Products of float64 or of lower-precision operands (a
`compute_dtype` run) are left as they are, as JAX's key applies to 32-bit
inputs only.

The mode's operand type is context-local (a `ContextVar`): a thread that
did not enter the mode does not see it. The TF32 and reduction flags are
PyTorch's process-wide backend flags; the context sets them on entry and
restores their previous values on exit, after an exception too.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch

__all__ = ("Mode", "MODES", "VALUES", "mode_of", "matmul_precision",
           "operand_dtype")


class Mode(NamedTuple):
    name: str
    #: the operand type of float32 products in the two layers (None: f32)
    operand: Optional[torch.dtype]
    #: the backend flags the mode sets: {(owner, attribute): value}
    flags: dict


_MATMUL, _CUDNN = torch.backends.cuda.matmul, torch.backends.cudnn
MODES = {
    "float32": Mode("float32", None, {(_MATMUL, "allow_tf32"): False,
                                      (_CUDNN, "allow_tf32"): False}),
    "tensorfloat32": Mode("tensorfloat32", None,
                          {(_MATMUL, "allow_tf32"): True,
                           (_CUDNN, "allow_tf32"): True}),
    "bfloat16": Mode("bfloat16", torch.bfloat16, {
        (_MATMUL, "allow_bf16_reduced_precision_reduction"): False}),
    "float16": Mode("float16", torch.float16, {
        (_MATMUL, "allow_fp16_reduced_precision_reduction"): False}),
}
#: every JAX value the card honours -> the name of its mode
VALUES = {"float32": "float32", "highest": "float32",
          "F32_F32_F32": "float32",
          "tensorfloat32": "tensorfloat32", "high": "tensorfloat32",
          "TF32_TF32_F32": "tensorfloat32",
          "bfloat16": "bfloat16", "default": "bfloat16",
          "BF16_BF16_F32": "bfloat16",
          "F16_F16_F32": "float16"}

_OPERAND: contextvars.ContextVar = contextvars.ContextVar(
    "matmul_operand_dtype", default=None)


def mode_of(value) -> Optional[Mode]:
    "the card's mode for a JAX `matmul_precision` value; None for None"
    if value is None:
        return None
    name = VALUES.get(value) if isinstance(value, str) else None
    if name is None:
        families = "; ".join(
            f"{m}: {', '.join(v for v, n in VALUES.items() if n == m)}"
            for m in MODES)
        raise ValueError(
            f"matmul_precision={value!r} cannot be honoured on the card; "
            f"it takes None or one of these families ({families})")
    return MODES[name]


def operand_dtype() -> Optional[torch.dtype]:
    "the type the two layers cast float32 operands to now (None: none)"
    return _OPERAND.get()


@contextlib.contextmanager
def matmul_precision(value):
    """the block under the mode of `value` (see the table above); a plain
    block for None. Yields the mode."""
    mode = mode_of(value)
    if mode is None:
        yield None
        return
    saved = {key: getattr(*key) for key in mode.flags}
    token = _OPERAND.set(mode.operand)
    try:
        for (owner, attr), v in mode.flags.items():
            setattr(owner, attr, v)
        yield mode
    finally:
        for (owner, attr), v in saved.items():
            setattr(owner, attr, v)
        _OPERAND.reset(token)
