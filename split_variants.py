#!/usr/bin/env python3
"""What the split kernel's compile-time layouts and its table type buy, on
one NVIDIA GPU.

    python3 split_variants.py

Builds variants of `bnn_priors_tpu_torch/csrc/split_operand.cu` by text
substitution (into build/variants/, one nvcc each, all at once), holds
each bit for bit against the plain version into outputs filled with NaN,
and times each as `chip_smoke.py`'s phase 25 (a) does: device µs a launch
in a CUDA graph of 50 launches over a ring of inputs and outputs larger
than L2, and host µs a call of the C entry point. The shapes are the main
path's: ResNet-20's and resnet18's widest activations (batch 128, 16 and
64 channels, 32x32) in one part and X3's and X6's layouts, and both
models' weight tables at one part, X3 and X6. Two rounds, the second in
the reverse order. The variants:

  as_is      the kernel as it is
  run_time   every layout read at run time: no layout a template parameter
  x6_left    X6's left-side layout a template parameter too
  one_entry  a table type of one entry (a table launch takes one operand;
             timed on one operand only)

It prints the card's name and power limit, one line a variant and shape,
and a last line `VARIANTS {json}`.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from bnn_priors_tpu_torch.ops import _cuda_lib
from bnn_priors_tpu_torch.ops import split_operand as so

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                   "variants")
X6_RIGHT = "  BNN_SPLIT_LAYOUT(3, 6, 0x021010u)     // X6, right: 0 1 0 1 2 0\n"
CAP = "constexpr int kTableCap = 64;"
# (tag, n, select) of the one-operand shapes: rows of one image at P > 1
LAYOUTS = (("one part", 1, (0,)), ("X3 left", 2, (0, 0, 1)),
           ("X6 left", 3, (0, 0, 1, 1, 0, 2)),
           ("X6 right", 3, (0, 1, 0, 1, 2, 0)))
TABLE_MODES = (("one part", "BF16_BF16_F32"), ("X3", "BF16_BF16_F32_X3"),
               ("X6", "BF16_BF16_F32_X6"))


def variant_sources():
    with open(_cuda_lib.SOURCES["split_operand"]) as f:
        src = f.read()
    for part in (X6_RIGHT, CAP):
        assert part in src, part
    lines = [l for l in src.splitlines(True)
             if l.startswith("  BNN_SPLIT_LAYOUT(")]
    run_time = src
    for l in lines:
        run_time = run_time.replace(l, "")
    return {"as_is": src, "run_time": run_time,
            "x6_left": src.replace(X6_RIGHT, X6_RIGHT.replace(
                "0x021010u)     // X6, right: 0 1 0 1 2 0",
                "0x201100u)     // X6, left: 0 0 1 1 0 2") + X6_RIGHT),
            "one_entry": src.replace(CAP, "constexpr int kTableCap = 1;")}


def build(sources):
    "{name: the bound library}, one nvcc a variant, all started at once"
    os.makedirs(OUT, exist_ok=True)
    nvcc, procs = _cuda_lib.find_nvcc(), {}
    for name, text in sources.items():
        cu = os.path.join(OUT, f"split_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda_lib.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = _cuda_lib.bind_split(
            ctypes.CDLL(os.path.join(OUT, f"split_{name}.so")))
    return libs


def launcher(lib, rg, table):
    "fn(i): one launch of `table` from copy i of the ring `rg`"
    def fn(i):
        src, out = rg[i % len(rg)]
        rc = lib.bnn_split_table(
            src.data_ptr(), out.data_ptr(), table.c_ops(), len(table),
            table.n, table.P, table.code, 0, src.device.index,
            torch.cuda.current_stream().cuda_stream)
        if rc < 0:
            raise RuntimeError(f"launch failed: CUDA error {-rc}")
    return fn


def cases():
    "(tag, flat source, table, byte bound ms, one operand?) a shape"
    gen = torch.Generator().manual_seed(17)
    out = []
    for name, shape in cs.SPLIT_SHAPES:
        x = (torch.randn(shape, generator=gen) * torch.exp(
            torch.randn(shape, generator=gen))).reshape(-1).cuda()
        for tag, n, sel in LAYOUTS:
            rows = 1 if len(sel) == 1 else shape[0]
            table = so.SplitTable([(0, rows, x.numel() // rows)], n,
                                  torch.bfloat16, sel)
            out.append((f"{name}/{tag}", x, table,
                        cs.split_bound_ms(x.numel(), len(sel)), True))
    for name, model_name in cs.SPLIT_TABLE_MODELS:
        pos, by_mode = cs.weight_tables(model_name)
        for tag, value in TABLE_MODES:
            table = by_mode[value]
            out.append((f"{name} weights/{tag}", pos, table,
                        cs.table_bound_ms(table), False))
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("split_variants.py needs a CUDA device")
    card = cs.card_line()
    print(card, flush=True)
    libs = build(variant_sources())
    shapes, res = cases(), {}
    for turn, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            for tag, src, table, bound, one in shapes:
                if name == "one_entry" and not one:
                    continue
                ref = so.split_table_reference(src, table)
                rg = cs.ring(src, torch.full((table.size,), float("nan"),
                                             device="cuda"))
                fn = launcher(libs[name], rg, table)
                fn(0)
                torch.cuda.synchronize()
                for i in range(len(table)):
                    cs.check(torch.equal(table.view(rg[0][1], i),
                                         table.view(ref, i)),
                             f"{name} {tag} operand {i}: kernel != plain")
                us = cs.graph_us(fn)
                host = cs.enqueue_us(lambda: fn(0), 500)
                del rg
                res.setdefault(tag, {}).setdefault(name, []).append(
                    {"us": us, "host_us": host, "bound_us": 1e3 * bound})
                print(f"round {turn} {name:9s} {tag:24s}: {us:8.2f} us a "
                      f"launch ({1e3 * bound / us:.0%} of {1e3 * bound:.2f} "
                      f"us), host {host:.2f} us a call on {card}", flush=True)
    print("VARIANTS " + json.dumps(res))


if __name__ == "__main__":
    main()
