"""Operands' bf16- (or f16-) exact parts, for the split matmul precisions
(`precision.py`): one CUDA C++ kernel for Hopper (sm_90a),
`csrc/split_operand.cu`, its plain PyTorch version, and the wrappers that
pick between them, for one operand (`split_operand`) and for a table of
operands of one flat source in one launch (`split_table`).

Replaces no TPU kernel: on the TPU the MXU runs JAX's split-bf16 dot
algorithms (`BF16_BF16_F32_X3`, `_X6`) itself. On the card the layers run
each product of parts in float32 with TF32 allowed, which is exact on
bf16 and f16 values, so an operand is first cut into float32 tensors that
hold such values. Part 0 is x rounded to the part type (to nearest even),
part k the residual the first k leave, rounded likewise; the residuals
are exact in float32, so n parts sum to x within 2^-8n·|x| in bf16
(2^-11n in f16, inside its range). In torch ops that is 2n + 1 launches
an operand; the kernel is one, whatever n and the layout, and one for a
whole table (a model's weights, `models/layers.py::split_weights`).

Layout. An operand is read as `rows` rows of M values, and its parts are
(rows, P, M): block p of row r holds part `select[p]` of row r. The
layers use it to stand a mode's parts side by side along a product's
contraction axis, so that one library product sums all its pairs
(`models/layers.py`).

Bound: 4 B read and 4·P B written an element, the memory rate.
"""
from __future__ import annotations

import ctypes
import operator

import numpy as np
import torch

from . import _cuda_lib

__all__ = ("split_operand", "split_operand_reference", "SplitTable",
           "split_table", "split_table_reference")

# Launches of the CUDA kernel since import (or since a caller reset them):
# the wrappers add one for each kernel they launch and nowhere else.
launches = 0
# Calls of `split_operand` and `split_table` on any device, the plain
# versions' included: what a caller asks of the kernel, countable on the
# CPU.
calls = 0

MAX_SELECT = 6  # blocks a row (csrc/split_operand.cu's kMaxSelect)
_HALF = {torch.bfloat16: 0, torch.float16: 1}
# (n, select) -> (select as a tuple, its 4-bit code), checked once
_LAYOUTS: dict = {}


def _layout(n, select):
    "(select tuple, code) of a layout, checked at its first use"
    key = (n, select if select is None or type(select) is tuple
           else tuple(select))
    hit = _LAYOUTS.get(key)
    if hit is None:
        if n not in (1, 2, 3):
            raise ValueError(f"n = {n} parts: 1, 2 or 3")
        sel = tuple(range(n) if select is None else map(operator.index,
                                                        select))
        if not 1 <= len(sel) <= MAX_SELECT or not all(
                0 <= s < n for s in sel):
            raise ValueError(f"select {sel}: 1 to {MAX_SELECT} part indices "
                             f"below n = {n}")
        hit = _LAYOUTS[key] = (sel, sum(s << (4 * p)
                                        for p, s in enumerate(sel)))
    return hit


def _checked(x, n, part_dtype, select, rows):
    "the layout (select tuple, code), after checking the arguments"
    if x.dtype is not torch.float32:
        raise TypeError(f"split_operand takes float32, got {x.dtype}")
    if part_dtype not in _HALF:
        raise ValueError(f"parts of type {part_dtype}: bfloat16 or float16")
    layout = _layout(n, select)
    if rows < 0 or (x.numel() % rows if rows else x.numel()):
        raise ValueError(f"{x.numel()} elements in {rows} rows")
    return layout


def _out(out, shape, like):
    "a fresh result of `shape`, or the caller's `out` once checked"
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=like.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype is not torch.float32
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"out: a contiguous float32 {tuple(shape)} tensor "
                         f"on {like.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def _raise(lib, rc, what, dev):
    raise RuntimeError(f"{what} launch on {dev} failed: CUDA error {-rc} "
                       f"({lib.bnn_split_error_string(-rc).decode()})")


def split_operand(x, n: int, part_dtype, select=None, rows: int = 1,
                  out=None):
    """The n ∈ {1, 2, 3} parts of float32 `x` as float32 tensors of
    `part_dtype`-exact values (bfloat16 or float16), in one launch.

    Returns a (rows, P, x.numel() // rows) float32 tensor, fresh or `out`:
    x read as `rows` rows, block p of row r part `select[p]` of row r
    (select: P ≤ 6 part indices, default range(n); an empty x may have 0
    rows). A CUDA tensor launches the CUDA kernel; a CPU tensor goes to
    the plain version; anything else raises."""
    global launches, calls
    select, code = _checked(x, n, part_dtype, select, rows)
    calls += 1
    if x.device.type == "cpu":
        return _reference(x, n, part_dtype, select, rows, out)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    dev, M = x.device, x.numel() // rows if rows else 0
    out = _out(out, (rows, len(select), M), x)
    if x.numel() == 0:
        return out
    lib = _cuda_lib.split_lib or _cuda_lib.load("split_operand")
    rc = lib.bnn_split_operand(
        x.data_ptr(), out.data_ptr(), rows, M, n, len(select), code,
        _HALF[part_dtype], dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc < 0:
        _raise(lib, rc, "split_operand", dev)
    launches += rc
    return out


def split_operand_reference(x, n: int, part_dtype, select=None,
                            rows: int = 1, out=None):
    """Plain PyTorch version of `split_operand`, same signature and
    result, any device: each part a cast to `part_dtype` and back, each
    residual a float32 subtraction."""
    select, _ = _checked(x, n, part_dtype, select, rows)
    return _reference(x, n, part_dtype, select, rows, out)


def _reference(x, n, part_dtype, select, rows, out=None):
    parts, res, M = [], x, x.numel() // rows if rows else 0
    for _ in range(n):
        part = res.to(part_dtype).float()
        parts.append(part.reshape(rows, M))
        res = res - part
    if out is None:
        return torch.stack([parts[s] for s in select], 1)
    out = _out(out, (rows, len(select), M), x)
    return torch.stack([parts[s] for s in select], 1, out=out)


class SplitTable:
    """Operands of one flat float32 source, split in one layout and one
    launch (`split_table`). `operands` holds (offset, rows, M) an operand:
    `rows` rows of M values from element `offset` of the source. Operand
    i's parts, (rows, P, M), start at element `dst[i]` of the result, a
    multiple of ALIGN (256 bytes, as a fresh tensor's start); the result
    holds `size` floats, and the kernel leaves the gaps between operands
    as they are. Built once for a fixed set of operands; `view` gives an
    operand's parts in a result."""

    ALIGN = 64

    def __init__(self, operands, n: int, part_dtype, select=None):
        if part_dtype not in _HALF:
            raise ValueError(f"parts of type {part_dtype}: bfloat16 or "
                             f"float16")
        self.select, self.code = _layout(n, select)
        self.n, self.part_dtype, self.P = n, part_dtype, len(self.select)
        self.operands = tuple((int(o), int(r), int(m))
                              for o, r, m in operands)
        if any(o < 0 or r < 1 or m < 1 for o, r, m in self.operands):
            raise ValueError(f"operands {self.operands}: offsets >= 0, "
                             f"rows and M >= 1")
        at, dst = 0, []
        for _, r, m in self.operands:
            at = -(-at // self.ALIGN) * self.ALIGN
            dst.append(at)
            at += r * self.P * m
        self.dst = tuple(dst)
        self.size = at
        self.extent = max((o + r * m for o, r, m in self.operands),
                          default=0)
        ops = np.asarray([(o, d, r, m) for (o, r, m), d
                          in zip(self.operands, self.dst)], dtype=np.int64)
        self._ops = ops.reshape(-1)
        self._c = None  # the C array of ops, at the first launch

    def __len__(self):
        return len(self.operands)

    def view(self, out, i: int):
        "operand i's parts in a result `out`: (rows, P, M)"
        _, r, m = self.operands[i]
        d = self.dst[i]
        return out[d:d + r * self.P * m].view(r, self.P, m)

    def c_ops(self):
        if self._c is None:
            self._c = (ctypes.c_int64 * len(self._ops))(*self._ops.tolist())
        return self._c


def _table_checked(src, table):
    if src.dtype is not torch.float32:
        raise TypeError(f"split_table takes float32, got {src.dtype}")
    if src.ndim != 1 or not src.is_contiguous():
        raise ValueError(f"split_table takes a contiguous 1-d source, got "
                         f"shape {tuple(src.shape)}")
    if src.numel() < table.extent:
        raise ValueError(f"a source of {src.numel()} elements; the table "
                         f"reads up to {table.extent}")


def split_table(src, table: SplitTable, out=None):
    """Every operand of `table` split from the flat float32 `src`, in one
    launch (several only past the kernel's 64 entries): a (table.size,)
    float32 tensor, fresh or `out`, operand i's parts at `table.view(out,
    i)`. A CUDA tensor launches the CUDA kernel; a CPU tensor goes to the
    plain version; anything else raises."""
    global launches, calls
    _table_checked(src, table)
    calls += 1
    if src.device.type == "cpu":
        return _table_reference(src, table, out)
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    dev = src.device
    out = _out(out, (table.size,), src)
    if not len(table):
        return out
    lib = _cuda_lib.split_lib or _cuda_lib.load("split_operand")
    rc = lib.bnn_split_table(
        src.data_ptr(), out.data_ptr(), table.c_ops(), len(table), table.n,
        table.P, table.code, _HALF[table.part_dtype], dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc < 0:
        _raise(lib, rc, "split_table", dev)
    launches += rc
    return out


def split_table_reference(src, table: SplitTable, out=None):
    """Plain PyTorch version of `split_table`, same signature and result,
    any device: `split_operand_reference` an operand (the gaps zero in a
    fresh result)."""
    _table_checked(src, table)
    return _table_reference(src, table, out)


def _table_reference(src, table, out=None):
    out = src.new_zeros(table.size) if out is None else _out(
        out, (table.size,), src)
    for i, (o, r, m) in enumerate(table.operands):
        _reference(src[o:o + r * m], table.n, table.part_dtype, table.select,
                   r, table.view(out, i))
    return out
