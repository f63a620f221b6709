"""Matmul precision on the card: the JAX key `matmul_precision`
(`jax_default_matmul_precision`; the JAX runner wraps every dispatch in
`jax.default_matmul_precision`, `bnn_priors_tpu/inference/runner.py:
59,109-113,202-215`) as a mode of the port's two multiplying layers,
`models/layers.py`'s `Linear` and `Conv2d`.

| JAX value | On the TPU | On the card |
|---|---|---|
| `float32`, `highest`, `F32_F32_F32` | ≈ f32 | f32 operands, TF32 off for cuBLAS and cuDNN |
| `tensorfloat32`, `high`, `TF32_TF32_F32` | 3-pass bf16 | TF32 on for cuBLAS and cuDNN |
| `bfloat16`, `default`, `BF16_BF16_F32` | 1-pass bf16, f32 accumulation | operands rounded to bf16 (one part), f32 accumulation, f32 result |
| `F16_F16_F32` | — | operands rounded to f16 (one part), f32 accumulation, f32 result |
| `BF16_BF16_F32_X3` | 3-pass bf16 | two bf16 parts a operand: hi·hi + hi·lo + lo·hi, f32 accumulation |
| `BF16_BF16_F32_X6` | 6-pass bf16 | three bf16 parts: X3's pairs + mid·mid + hi·lo₂ + lo₂·hi |
| `F16_F16_F16` | — | f16 operands, f32 accumulation, the result rounded to f16 |
| `F64_F64_F64` | — | float64 operands and products, the result rounded to f32 |

Every other value raises ValueError, naming the families above: the
four F8 presets, `BF16_BF16_F32_X9`, `TF32_TF32_F32_X3` and
`BF16_BF16_BF16`. JAX's CPU backend, the reference the port's tests hold
every mode against, refuses them (`dot_general` on CPU), so nothing
could hold the port to them. None leaves the process as it is, as in JAX.

`matmul_precision(value)` is the mode as a context. Two kinds of mode
change the arithmetic of a product of float32 operands in the two layers
(its forward product, dgrad and wgrad alike; the incoming gradient is an
operand of the last two):
- split modes (`parts` ≥ 1): each operand is cut into `parts` float32
  tensors of bf16- (f16-) exact values (`ops/split_operand.py`; part k
  is the residual the first k leave, rounded to nearest even), and the
  product is the sum over `pairs` of the products of parts. Each part
  product runs in float32 with TF32 allowed: a bf16 or f16 value is exact
  in TF32, and a product of two such values in float32, so each is exact
  and only the float32 accumulation rounds. The result stays float32.
- cast modes (`parts` = 0, an `operand` type): the operands are cast to
  that type and the product runs on them, its result in that type (f16's
  rounding of the float32 accumulator; float64's own) cast back to
  float32. cuBLAS's reduced-precision split-K reduction is off for f16.
The bias is added after, in float32, and the gradient reaching a float32
parameter is float32. Everything else (activations, batchnorm, the
likelihood, the prior, the chain update) stays float32, as JAX's key
touches only dots and convolutions. Products of float64 or of
lower-precision operands (a `compute_dtype` run) are left as they are,
as JAX's key applies to 32-bit inputs only.

The mode is context-local (a `ContextVar`): a thread that did not enter
it does not see it. The TF32 and reduction flags are PyTorch's
process-wide backend flags; the context sets them on entry and restores
their previous values on exit, after an exception too.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch

__all__ = ("Mode", "MODES", "VALUES", "mode_of", "matmul_precision",
           "active_mode", "operand_dtype")


class Mode(NamedTuple):
    name: str
    #: the part type of a split mode, the cast type of a cast mode (None:
    #: float32's own product)
    operand: Optional[torch.dtype]
    #: the backend flags the mode sets: {(owner, attribute): value}
    flags: dict
    #: parts an operand is split into (0: not a split mode)
    parts: int = 0
    #: the (lhs part, rhs part) pairs whose products are summed; each set
    #: holds (j, i) with (i, j), so either operand may take the left
    pairs: tuple = ()


_MATMUL, _CUDNN = torch.backends.cuda.matmul, torch.backends.cudnn
_TF32 = {(_MATMUL, "allow_tf32"): True, (_CUDNN, "allow_tf32"): True}
# split modes: part products in TF32 (exact on the parts); a product of
# bf16 or f16 operands under them (the K-chain evaluation's) accumulates in
# float32 throughout
_SPLIT_FLAGS = {**_TF32,
                (_MATMUL, "allow_bf16_reduced_precision_reduction"): False,
                (_MATMUL, "allow_fp16_reduced_precision_reduction"): False}
X3_PAIRS = ((0, 0), (0, 1), (1, 0))
X6_PAIRS = X3_PAIRS + ((1, 1), (0, 2), (2, 0))
MODES = {
    "float32": Mode("float32", None, {(_MATMUL, "allow_tf32"): False,
                                      (_CUDNN, "allow_tf32"): False}),
    "tensorfloat32": Mode("tensorfloat32", None, _TF32),
    "bfloat16": Mode("bfloat16", torch.bfloat16, _SPLIT_FLAGS, 1,
                     ((0, 0),)),
    "float16": Mode("float16", torch.float16, _SPLIT_FLAGS, 1, ((0, 0),)),
    "bf16x3": Mode("bf16x3", torch.bfloat16, _SPLIT_FLAGS, 2, X3_PAIRS),
    "bf16x6": Mode("bf16x6", torch.bfloat16, _SPLIT_FLAGS, 3, X6_PAIRS),
    "float16_out": Mode("float16_out", torch.float16, {
        (_MATMUL, "allow_fp16_reduced_precision_reduction"): False}),
    "float64": Mode("float64", torch.float64, {}),
}
#: every JAX value the port runs -> the name of its mode
VALUES = {"float32": "float32", "highest": "float32",
          "F32_F32_F32": "float32",
          "tensorfloat32": "tensorfloat32", "high": "tensorfloat32",
          "TF32_TF32_F32": "tensorfloat32",
          "bfloat16": "bfloat16", "default": "bfloat16",
          "BF16_BF16_F32": "bfloat16",
          "F16_F16_F32": "float16",
          "BF16_BF16_F32_X3": "bf16x3", "BF16_BF16_F32_X6": "bf16x6",
          "F16_F16_F16": "float16_out", "F64_F64_F64": "float64"}

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "matmul_precision_mode", default=None)


def mode_of(value) -> Optional[Mode]:
    "the port's mode for a JAX `matmul_precision` value; None for None"
    if value is None:
        return None
    name = VALUES.get(value) if isinstance(value, str) else None
    if name is None:
        families = "; ".join(
            f"{m}: {', '.join(v for v, n in VALUES.items() if n == m)}"
            for m in MODES)
        raise ValueError(
            f"matmul_precision={value!r} is not run: JAX's CPU backend, the "
            f"reference the port is held against, refuses it too "
            f"(dot_general on CPU), so nothing could hold it; it takes None "
            f"or one of these families ({families})")
    return MODES[name]


def active_mode() -> Optional[Mode]:
    "the mode the block runs under now (None: none)"
    return _ACTIVE.get()


def operand_dtype() -> Optional[torch.dtype]:
    "the part or cast type of the mode now (None: none, or a float32 mode)"
    mode = _ACTIVE.get()
    return None if mode is None else mode.operand


@contextlib.contextmanager
def matmul_precision(value):
    """the block under the mode of `value` (see the table above); a plain
    block for None. Yields the mode."""
    mode = mode_of(value)
    if mode is None:
        yield None
        return
    saved = {key: getattr(*key) for key in mode.flags}
    token = _ACTIVE.set(mode)
    try:
        for (owner, attr), v in mode.flags.items():
            setattr(owner, attr, v)
        yield mode
    finally:
        for (owner, attr), v in saved.items():
            setattr(owner, attr, v)
        _ACTIVE.reset(token)
