#!/usr/bin/env python3
"""What each part of the segments kernel costs, in its present design and
in its earlier one, on one NVIDIA GPU.

    python3 segment_variants.py [--earlier FILE] [variant ...]

Builds variants of `bnn_priors_tpu_torch/csrc/fused_update_segments.cu` by
text substitution into build/variants/segments/ (one nvcc each, all at
once), holds the kernel as it is within 1e-5 of the plain version at
noise_std 1, and times every variant as `chip_smoke.py`'s phase 16 (a)
does: device µs a launch in a CUDA graph of 50 launches, launch i on copy i
of a ring of the five buffers larger than L2 ("ring"), and on one copy
("hot"). The forms: ResNet-20's hybrid and segmented states at one chain
and at K=8, resnet18's at one chain. Two rounds, the second in the reverse
order, so that two variants named alone run in turns (a, b, b, a).

`--earlier FILE` names a source of the earlier design (a binary search
over the segments a block and over the runs an element, one element a
thread at a time with 4-byte accesses), which the repo no longer holds:
for example `git show <commit>:bnn_priors_tpu_torch/csrc/
fused_update_segments.cu > build/earlier.cu` for a commit before the
redesign. Its `earlier*` variants run only with it, and it is held bit for
bit against the present kernel. The variants (all of them, the `earlier*`
ones given the file, when none is named):

  earlier                  the earlier kernel as it is
  earlier_no_noise         without Philox and Box–Muller (ξ a cheap
                           function of the flat index)
  earlier_no_run_search    every element in its segment's first run (no
                           search over the runs)
  earlier_no_block_search  each block reads its segment's row at blockIdx.x
                           from a table of one row a block (no search)
  as_is                    the kernel as it is
  no_noise                 without Philox and Box–Muller
  scalar                   every access element by element (the launch's
                           alignment bits 0)
  flat_layout              θ, m, v and g at their flat index (the flat
                           packing's (K, T) banks, the table's buffer
                           positions rewritten): every piece's quads
                           16-byte aligned, as an `Arena` laid out in the
                           flat order would have them; M as it is
  even_rounds              where a group is one piece and the blocks' last
                           round of groups is short (ResNet-20 at K=8: 331
                           groups over 66 blocks, one block a chain takes
                           a sixth), the pieces of that round left out:
                           the price of the short round (0.4% fewer bytes)
  group_a_block            one block a group of pieces at every K (the
                           grid the partials' order alone asks for)
  no_prefetch              each piece's row read when it is reached, not
                           while the piece before it is worked
  waves5, waves6           5 or 6 blocks a multiprocessor (launch bounds
                           asking at most 48 or 40 registers; 5 or 6
                           groups a multiprocessor)
  stream_stores            θ', m', v' stored with the evict-first hint
                           (`__stcs`)
  flat                     the flat kernel (`csrc/fused_update.cu`) on the
                           flat packing of the same leaves: the yardstick
  copy                     a device-to-device copy (`Tensor.copy_`) that
                           reads and writes as many bytes as the form's
                           bound counts: the rate a plain stream reaches
                           at this launch's size

A variant without noise or a search computes wrong values: only its time
is read. The script prints the card's name and power limit, one line a
variant and form, and a last line `VARIANTS {json}`.
"""
import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from bnn_priors_tpu_torch.ops import _cuda_lib
from bnn_priors_tpu_torch.ops import fused_update as fu

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                   "variants", "segments")
FORMS = (("ResNet-20", "googleresnet", "hybrid", 1),
         ("ResNet-20", "googleresnet", "segmented", 1),
         ("ResNet-20", "googleresnet", "hybrid", cs.K_CHAINS),
         ("ResNet-20", "googleresnet", "segmented", cs.K_CHAINS),
         ("resnet18", "resnet18", "hybrid", 1),
         ("resnet18", "resnet18", "segmented", 1))

EARLIER_NOISE = "xi = normal_at(run[1] + p - run[0], k0, k1);"
EARLIER_RUN_SEARCH = """      int lo = 0, hi = n_runs - 1;  // the run holding p
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (runs[(first_run + mid) * kRunCols] <= p) lo = mid;
        else hi = mid - 1;
      }
"""
EARLIER_BLOCK_SEARCH = """    int lo = 0, hi = n_segs - 1;  // the last segment starting at or before b
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (segs[mid * kSegCols + kFirstBlock] <= blockIdx.x) lo = mid;
      else hi = mid - 1;
    }
"""
MIN_BLOCKS = "constexpr int kMinBlocks = 4;"
PIECE_LOOP = """      int64_t i = gi;
      Piece pc = load_piece(pieces, i);
      for (;;) {
        const int64_t next = i + n_groups;
        Piece pn = pc;
        if (next < n_pieces) pn = load_piece(pieces, next);
        update_piece(th, m, v, g, M, pc, k, aligned, k0, k1, c, acc);
        if (next >= n_pieces) break;
        i = next;
        pc = pn;
      }
"""
NO_PREFETCH = """      for (int64_t i = gi; i < n_pieces; i += n_groups)
        update_piece(th, m, v, g, M, load_piece(pieces, i), k, aligned, k0,
                     k1, c, acc);
"""
STORES = (("      *reinterpret_cast<float4*>(p) = x;",
           "      __stcs(reinterpret_cast<float4*>(p), x);"),
          ("      reinterpret_cast<float2*>(p)[0] = make_float2(x.x, x.y);",
           "      __stcs(reinterpret_cast<float2*>(p), make_float2(x.x, x.y));"),
          ("      reinterpret_cast<float2*>(p + 2)[0] = make_float2(x.z, x.w);",
           "      __stcs(reinterpret_cast<float2*>(p + 2), "
           "make_float2(x.z, x.w));"),
          ("  if (lo <= 0 && 0 < hi) p[0] = x.x;",
           "  if (lo <= 0 && 0 < hi) __stcs(p, x.x);"),
          ("  if (lo <= 1 && 1 < hi) p[1] = x.y;",
           "  if (lo <= 1 && 1 < hi) __stcs(p + 1, x.y);"),
          ("  if (lo <= 2 && 2 < hi) p[2] = x.z;",
           "  if (lo <= 2 && 2 < hi) __stcs(p + 2, x.z);"),
          ("  if (lo <= 3 && 3 < hi) p[3] = x.w;",
           "  if (lo <= 3 && 3 < hi) __stcs(p + 3, x.w);"))
NOISE = """    const uint4 w = philox4x32_10(static_cast<uint32_t>(q),
                                  static_cast<uint32_t>(q >> 32), k0, k1);
    const float2 n01 = box_muller(w.x, w.y), n23 = box_muller(w.z, w.w);
    xi = make_float4(n01.x, n01.y, n23.x, n23.y);
"""


def nvcc_libraries(sources, out_dir):
    """{name: ctypes library} of {name: CUDA source text}: one nvcc a
    source, all started together, with the port's flags and `csrc/` on the
    include path, into `out_dir`"""
    csrc = os.path.dirname(_cuda_lib.SOURCES["fused_update"])
    os.makedirs(out_dir, exist_ok=True)
    nvcc, procs = _cuda_lib.find_nvcc(), {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda_lib.NVCC_FLAGS, "-I", csrc, "-o", cu[:-3] + ".so",
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed on {name}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"build {name}: {ln.split('ptxas info    : ')[-1]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs


def bind_earlier(cdll):
    "the earlier segments library's entry point"
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    fn = cdll.bnn_fused_langevin_update_segments
    fn.argtypes = [p, p, p, p, p, p, i64, p, i64, p, p, p, p, p, i64, f32,
                   i64, i64, f32, f32, f32, f32, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return cdll


def earlier_table(pk, lead, one_row_a_block=False):
    """the earlier kernel's table of `pk` for `lead` on the card: (segs
    (n_segs × 9: x offset, chain stride, size, M's offset, chain and
    element strides, first block, first run, runs), runs (× 2: start in
    the segment, start in the flat packing), blocks a chain). With
    `one_row_a_block`, segs holds each segment's row once a block of it
    (the variant that reads its row at blockIdx.x)"""
    x_arena, p_arena = pk.arena(lead), pk.pre_arena(lead)
    segs, runs, first_block = [], [], 0
    for s, seg_runs in enumerate(pk.seg_runs):
        size = x_arena.sizes[s]
        scalar = len(p_arena.shapes[s]) == 0
        row = [x_arena.offsets[s], size, size, p_arena.offsets[s],
               p_arena.sizes[s], 0 if scalar else 1, first_block, len(runs),
               len(seg_runs)]
        blocks = -(-size // 1024)
        segs += [row] * (blocks if one_row_a_block else 1)
        first_block += blocks
        runs += [[start, int(pk.offsets[leaf])]
                 for leaf, start, _ in seg_runs]
    as_card = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                        device="cuda")
    return as_card(segs), as_card(runs), first_block


def earlier_launcher(lib, pk, lead, one_row_a_block=False):
    """fn(th, m, v, g, M, seeds, sigmas, seed, sigma, seed_offset, c4):
    one launch of the earlier kernel (K chains' seeds and sigmas, or None
    and the scalars) on the current stream; returns the (K, 3) partials"""
    segs, runs, nb = earlier_table(pk, lead, one_row_a_block)
    K = math.prod(lead)
    rows = torch.empty(K * nb * 3, device="cuda")
    tickets = torch.zeros(K, dtype=torch.int32, device="cuda")
    ptr = lambda t: None if t is None else t.data_ptr()

    def fn(th, m, v, g, M, seeds, sigmas, seed, sigma, seed_offset, c4):
        partials = torch.empty((K, 3), device="cuda")
        rc = lib.bnn_fused_langevin_update_segments(
            th.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            M.data_ptr(), segs.data_ptr(), len(segs), runs.data_ptr(), nb,
            rows.data_ptr(), tickets.data_ptr(), partials.data_ptr(),
            ptr(seeds), ptr(sigmas), seed, sigma, seed_offset, K, *c4,
            th.device.index, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"earlier segments kernel: CUDA error {rc}")
        return partials
    return fn


def variant_sources(earlier_file=None):
    """{name: (design, source text)} of every text variant; the earlier
    design's only with its source file"""
    with open(_cuda_lib.SOURCES["fused_update_segments"]) as f:
        now = f.read()
    for part in (NOISE, PIECE_LOOP, MIN_BLOCKS) + tuple(
            a for a, _ in STORES):
        assert part in now, part
    stream_stores = now
    for a, b in STORES:
        stream_stores = stream_stores.replace(a, b)
    out = {}
    if earlier_file is not None:
        with open(earlier_file) as f:
            earlier = f.read()
        for part in (EARLIER_NOISE, EARLIER_RUN_SEARCH, EARLIER_BLOCK_SEARCH):
            assert part in earlier, part
        out = {
            "earlier": ("earlier", earlier),
            "earlier_no_noise": ("earlier", earlier.replace(
                EARLIER_NOISE,
                "xi = static_cast<float>(run[1] + p - run[0]) * 1e-30f;")),
            "earlier_no_run_search": ("earlier", earlier.replace(
                EARLIER_RUN_SEARCH, "      const int lo = 0;\n")),
            "earlier_no_block_search": ("earlier", earlier.replace(
                EARLIER_BLOCK_SEARCH,
                "    const int lo = blockIdx.x;  // a row a block\n"))}
    return {
        **out,
        "as_is": ("now", now),
        "no_noise": ("now", now.replace(
            NOISE, "    xi = make_float4(q * 1e-30f, 0.0f, 0.0f, 0.0f);\n")),
        "stream_stores": ("now", stream_stores),
        "no_prefetch": ("now", now.replace(PIECE_LOOP, NO_PREFETCH)),
        **{f"bounds{w}": ("now", now.replace(
            MIN_BLOCKS, MIN_BLOCKS.replace("4", str(w)))) for w in (5, 6)},
    }


# the launch variants of the present kernel: (text variant, launch options)
LAUNCH_VARIANTS = {"scalar": ("as_is", {"aligned": 0}),
                   "flat_layout": ("as_is", {"flat_layout": True}),
                   "even_rounds": ("as_is", {"even_rounds": True}),
                   "group_a_block": ("as_is", {"group_a_block": True}),
                   "waves5": ("bounds5", {"waves": 5}),
                   "waves6": ("bounds6", {"waves": 6})}


def form_inputs(model_name, packing, K, gen):
    """(packer, lead, [θ, m, v, g, M] buffers on the card, and the flat
    packing's (K, T) banks): random, v > 0, M positive (a scalar a leaf in
    the segments)"""
    from bnn_priors_tpu_torch.exp_utils import get_model
    from bnn_priors_tpu_torch.mcmc.segmented import make_packer
    params = {k: v.detach() for k, v in get_model(model_name).params().items()}
    pk = make_packer(packing, params)
    lead = () if K == 1 else (K,)
    n = pk.arena(lead).length
    rnd = lambda: torch.randn(n, generator=gen, device="cuda")
    M = pk.expand(0.5 + torch.rand(*lead, pk.n_leaves, generator=gen,
                                   device="cuda")).base
    bank = lambda: torch.randn(*lead, pk.flat_padded, generator=gen,
                               device="cuda")
    flats = [bank(), bank(), bank().abs() + 0.1, 0.05 * bank(),
             0.5 + bank().abs()]
    return pk, lead, [rnd(), rnd(), rnd().abs() + 0.1, 0.05 * rnd(), M], flats


def flat_launcher(pk, lead):
    "the flat kernel's wrapper on the flat banks, in the same signature"
    def fn(th, m, v, g, M, seeds, sigmas, seed, sigma, seed_offset, c4):
        if not lead:
            return fu.fused_langevin_update(
                th, m, v, g, M, seed, (c4[0], c4[1], sigma, c4[2], c4[3]),
                total=pk.total)[3]
        return fu.fused_langevin_update_chains(
            th, m, v, g, M, seeds, sigmas, c4, total=pk.total,
            seed_offset=seed_offset)[3]
    return fn


def now_launcher(lib, pk, lead, aligned=None, group_a_block=False,
                 waves=fu.WAVES, flat_layout=False, even_rounds=False):
    """fn(th, m, v, g, M, seeds, sigmas, seed, sigma, seed_offset, c4): one
    launch of the present kernel through its C entry point. With
    `flat_layout`, θ, m, v and g are the flat packing's (K, T) banks: each
    piece's buffer position is its flat index, the chain stride T"""
    table = pk.kernel_table(lead, "cuda", lib.bnn_segments_chunk())
    if flat_layout:
        pieces = table.pieces.clone()
        pieces[:, 2] = pieces[:, 0]  # the columns `x` and `x_stride`
        pieces[:, 3] = pk.flat_padded
        table = argparse.Namespace(pieces=pieces, n_pieces=table.n_pieces,
                                   n_chains=table.n_chains)
    K, dev = table.n_chains, torch.device("cuda", torch.cuda.current_device())
    n_groups, nb = fu.segment_grid(table, dev, K)
    if waves != fu.WAVES:
        cap = waves * torch.cuda.get_device_properties(
            dev).multi_processor_count
        n_groups = max(1, min(table.n_pieces, cap))
        nb = max(-(-n_groups // fu.SEGMENT_SLOTS), min(n_groups, -(-cap // K)))
    if group_a_block:
        nb = n_groups
    if even_rounds and table.n_pieces == n_groups and n_groups % nb:
        n_groups -= n_groups % nb  # one piece a group: drop the short round
        table = argparse.Namespace(pieces=table.pieces[:n_groups],
                                   n_pieces=n_groups, n_chains=K)
    rows = torch.empty(K * n_groups * 3, device="cuda")
    tickets = torch.zeros(K, dtype=torch.int32, device="cuda")
    ptr = lambda t: None if t is None else t.data_ptr()

    def fn(th, m, v, g, M, seeds, sigmas, seed, sigma, seed_offset, c4):
        bits = (int(fu._aligned16(th, m, v, g)) | 2 * int(fu._aligned16(M))
                if aligned is None else aligned)
        partials = torch.empty((K, 3), device="cuda")
        rc = lib.bnn_fused_langevin_update_segments(
            th.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            M.data_ptr(), table.pieces.data_ptr(), table.n_pieces, n_groups,
            nb, bits, rows.data_ptr(), tickets.data_ptr(), partials.data_ptr(),
            ptr(seeds), ptr(sigmas), seed, sigma, seed_offset, K, *c4,
            dev.index, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"segments kernel: CUDA error {rc}")
        return partials
    return fn


def launcher(name, libs, pk, lead):
    if name == "flat":
        return flat_launcher(pk, lead)
    if name == "copy":
        return lambda src, dst, *_: dst.copy_(src)
    text, opts = LAUNCH_VARIANTS.get(name, (name, {}))
    design = "earlier" if text.startswith("earlier") else "now"
    if design == "earlier":
        return earlier_launcher(
            libs[text], pk, lead,
            one_row_a_block=text == "earlier_no_block_search")
    return now_launcher(libs[text], pk, lead, **opts)


def coefficients(K, sigma):
    "(seeds, sigmas, seed, sigma, offset, c4) of a launch at noise_std σ"
    c = cs.coefficient_sets(0.01, cs.N_TRAIN, 0.994, 0.99)["ggmc_mid"]
    c4 = (c[0], c[1], c[3], c[4])
    if K == 1:
        return None, None, 7, sigma, 0, c4
    return (cs.chain_seeds(K), torch.full((K,), sigma, device="cuda"), 0,
            0.0, 5, c4)


def check_designs(libs, pk, lead, bufs, tag):
    """the earlier and the present kernel bit for bit against each other
    and within 1e-5 of the plain version, at noise_std 1"""
    K = math.prod(lead)
    seeds, sigmas, seed, sigma, off, c4 = coefficients(K, 1.0)
    out = {}
    for name in ("earlier", "as_is"):
        if name not in libs:
            continue
        b = [t.clone() for t in bufs]
        launcher(name, libs, pk, lead)(*b, seeds, sigmas, seed, sigma, off,
                                       c4)
        out[name] = b
    ref = [t.clone() for t in bufs]
    table = pk.kernel_table(lead, "cuda", fu.SEGMENT_CHUNK)
    if K == 1:
        fu.fused_langevin_update_segments_reference(
            *ref, seed, (c4[0], c4[1], sigma, c4[2], c4[3]), table=table)
    else:
        fu.fused_langevin_update_segments_chains_reference(
            *ref, seeds, sigmas, c4, table=table, seed_offset=off)
    torch.cuda.synchronize()
    for name, b in out.items():  # the gaps between segments stay as they are
        err = max(float((x - r).abs().max()) for x, r in zip(b[:3], ref[:3]))
        cs.check(err <= 1e-5, f"{name} {tag}: off the plain version by {err}")
        print(f"{name} {tag}: max |d| from the plain version {err:.2e}")
    if len(out) == 2:
        cs.check(all(torch.equal(a, b) for a, b in
                     zip(out["earlier"][:3], out["as_is"][:3])),
                 f"{tag}: the two designs differ")
        print(f"{tag}: theta, m, v of the two designs bit for bit equal")


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="a source of the earlier design")
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("segment_variants.py needs a CUDA device")
    card = cs.card_line()
    print(card, flush=True)
    sources = variant_sources(args.earlier)
    unknown = (set(args.names) - set(sources) - set(LAUNCH_VARIANTS)
               - {"flat", "copy"})
    if unknown:
        sys.exit(f"unknown variants {sorted(unknown)} (the earlier* ones "
                 "need --earlier)")
    names = args.names or list(sources) + list(LAUNCH_VARIANTS) + ["flat",
                                                                   "copy"]
    texts = {LAUNCH_VARIANTS.get(n, (n,))[0] for n in names} - {"flat",
                                                                "copy"}
    libs = nvcc_libraries({n: sources[n][1] for n in texts}, OUT)
    for n, lib in libs.items():
        if sources[n][0] == "earlier":
            bind_earlier(lib)
        else:
            _cuda_lib.bind_segments(lib)
    gen = torch.Generator(device="cuda").manual_seed(19)
    forms = []
    for label, model_name, packing, K in FORMS:
        pk, lead, bufs, flats = form_inputs(model_name, packing, K, gen)
        tag = f"{label} {packing} K={K}"
        check_designs(libs, pk, lead, bufs, tag)
        bound_ms, nbytes = cs.segment_bound_ms(pk, lead)
        half = lambda: torch.empty(nbytes // 8, device="cuda")
        forms.append((tag, pk, lead, bufs, flats, [half(), half()],
                      1e3 * bound_ms))
    res = {}
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            for tag, pk, lead, segs, flats, copy, bound_us in forms:
                fn = launcher(name, libs, pk, lead)
                bufs = {"flat": flats, "flat_layout": flats[:4] + segs[4:],
                        "copy": copy}.get(name, segs)
                c = coefficients(math.prod(lead), 0.5)
                rg = cs.ring(*bufs)
                ring_us = cs.graph_us(lambda i: fn(*rg[i % len(rg)], *c))
                hot_us = cs.graph_us(lambda i: fn(*bufs, *c))
                del rg
                res.setdefault(tag, {}).setdefault(name, []).append(
                    {"ring_us": ring_us, "hot_us": hot_us,
                     "bound_us": bound_us})
                print(f"round {turn} {name:23s} {tag:26s}: ring "
                      f"{ring_us:8.2f} us ({bound_us / ring_us:.0%} of "
                      f"{bound_us:.2f} us), hot {hot_us:8.2f} us "
                      f"({bound_us / hot_us:.0%}) on {card}", flush=True)
    print("VARIANTS " + json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1:])
