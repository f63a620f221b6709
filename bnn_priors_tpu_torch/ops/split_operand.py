"""An operand's bf16- (or f16-) exact parts, for the split matmul
precisions (`precision.py`): one CUDA C++ kernel for Hopper (sm_90a),
`csrc/split_operand.cu`, its plain PyTorch version, and the wrapper that
picks between them.

Replaces no TPU kernel: on the TPU the MXU runs JAX's split-bf16 dot
algorithms (`BF16_BF16_F32_X3`, `_X6`) itself. On the card the layers run
each product of parts in float32 with TF32 allowed, which is exact on
bf16 and f16 values, so an operand is first cut into float32 tensors that
hold such values. Part 0 is x rounded to the part type (to nearest even),
part k the residual the first k leave, rounded likewise; the residuals
are exact in float32, so n parts sum to x within 2^-8n·|x| in bf16
(2^-11n in f16, inside its range). In torch ops that is 2n + 1 launches
an operand; the kernel is one, whatever n and the layout.

Layout. `x` is read as `rows` rows of M = x.numel() / rows values, and
the result is (rows, P, M): block p of row r holds part `select[p]` of
row r. The layers use it to stand a mode's parts side by side along a
product's contraction axis, so that one library product sums all its
pairs (`models/layers.py`).

Bound: 4 B read and 4·P B written an element, the memory rate.
"""
from __future__ import annotations

import torch

from . import _cuda_lib

__all__ = ("split_operand", "split_operand_reference")

# Launches of the CUDA kernel since import (or since a caller reset them):
# the wrapper adds one where it launches its kernel and nowhere else.
launches = 0

MAX_SELECT = 6  # blocks a row (csrc/split_operand.cu's kMaxSelect)
_HALF = {torch.bfloat16: 0, torch.float16: 1}


def _checked(x, n, part_dtype, select, rows):
    "the selection as a tuple, after checking the arguments"
    if x.dtype is not torch.float32:
        raise TypeError(f"split_operand takes float32, got {x.dtype}")
    if part_dtype not in _HALF:
        raise ValueError(f"parts of type {part_dtype}: bfloat16 or float16")
    if n not in (1, 2, 3):
        raise ValueError(f"n = {n} parts: 1, 2 or 3")
    select = tuple(range(n)) if select is None else tuple(select)
    if not 1 <= len(select) <= MAX_SELECT or not all(
            0 <= s < n for s in select):
        raise ValueError(f"select {select}: 1 to {MAX_SELECT} part indices "
                         f"below n = {n}")
    if rows < 0 or (x.numel() % rows if rows else x.numel()):
        raise ValueError(f"{x.numel()} elements in {rows} rows")
    return select


def split_operand(x, n: int, part_dtype, select=None, rows: int = 1):
    """The n ∈ {1, 2, 3} parts of float32 `x` as float32 tensors of
    `part_dtype`-exact values (bfloat16 or float16), in one launch.

    Returns a fresh (rows, P, x.numel() // rows) float32 tensor: x read as
    `rows` rows, block p of row r part `select[p]` of row r (select: P ≤ 6
    part indices, default range(n); an empty x may have 0 rows). A CUDA tensor launches the CUDA
    kernel; a CPU tensor goes to the plain version; anything else
    raises."""
    global launches
    select = _checked(x, n, part_dtype, select, rows)
    if x.device.type == "cpu":
        return split_operand_reference(x, n, part_dtype, select, rows)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    dev, M = x.device, x.numel() // rows if rows else 0
    out = torch.empty((rows, len(select), M), dtype=torch.float32,
                      device=dev)
    if x.numel() == 0:
        return out
    lib = _cuda_lib.split_lib or _cuda_lib.load("split_operand")
    code = sum(s << (4 * p) for p, s in enumerate(select))
    rc = lib.bnn_split_operand(
        x.data_ptr(), out.data_ptr(), rows, M, n, len(select), code,
        _HALF[part_dtype], dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"split_operand launch on {dev} failed: CUDA error"
                           f" {rc} ({lib.bnn_split_error_string(rc).decode()})")
    launches += 1
    return out


def split_operand_reference(x, n: int, part_dtype, select=None,
                            rows: int = 1):
    """Plain PyTorch version of `split_operand`, same signature and
    result, any device: each part a cast to `part_dtype` and back, each
    residual a float32 subtraction."""
    select = _checked(x, n, part_dtype, select, rows)
    parts, res, M = [], x, x.numel() // rows if rows else 0
    for _ in range(n):
        part = res.to(part_dtype).float()
        parts.append(part.reshape(rows, M))
        res = res - part
    return torch.stack([parts[s] for s in select], 1)
