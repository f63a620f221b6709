"""Builds and loads the port's CUDA C++ kernels at first use:
`csrc/fused_update.cu` (the packed `(T,)` and `(K, T)` update) and
`csrc/fused_update_segments.cu` (the segmented and hybrid states' update),
both including `csrc/langevin.cuh`, and `csrc/split_operand.cu` (the
bf16- or f16-exact parts of an operand, or of a table of operands in one
launch, for the split matmul precisions).

`nvcc` compiles each source for Hopper (`sm_90a`) into a shared library
with a plain C interface under `build/kernels/` beside the package, named
by a hash of the source, the shared header and the flags, so a stale build
is never loaded. A library is written under a temporary name and moved
into place, so a build cut short leaves nothing that a later call would
load. `ptxas`'s report (registers, shared memory, spills) is kept beside it
as `<name>.log`. `build_all` starts one nvcc a source, all at once.

A missing `nvcc` or a failed build raises with the compiler's output: the
kernels have no fallback. Nothing here runs on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", name + ".cu")
           for name in ("fused_update", "fused_update_segments",
                        "split_operand")}
SOURCE = SOURCES["fused_update"]
HEADERS = (os.path.join(_PKG, "csrc", "langevin.cuh"),)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# the segments kernel's (chunk of flat elements, int64 columns a row of its
# table, groups of pieces a block takes at most), which the packers' tables
# and the wrapper assume; `bind_segments` checks the library against them
SEGMENT_LAYOUT = (1024, 8, 16)

# the loaded libraries, once `load` has run: `lib` is fused_update's,
# `seg_lib` fused_update_segments', `split_lib` split_operand's
lib = None
seg_lib = None
split_lib = None


def find_nvcc() -> str:
    "nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda; raises if none"
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda"
                       "/bin): the CUDA kernel cannot be built")


def library_path(build_dir: str = None, name: str = "fused_update") -> str:
    "where the library of the current source, header and flags is built"
    digest = hashlib.sha256()
    for path in (SOURCES[name],) + HEADERS:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR if build_dir is None else build_dir,
                        f"{name}_{digest.hexdigest()[:16]}.so")


def _start(build_dir, name):
    "(library path, None) if built, else (path, (tmp, cmd, running nvcc))"
    out = library_path(build_dir, name)
    if os.path.exists(out):
        return out, None
    nvcc = find_nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, (tmp, cmd, proc)


def _finish(out, job) -> str:
    "wait for a started build; move its library into place or raise"
    if job is None:
        return out
    tmp, cmd, proc = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{stdout}{stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(stdout + stderr)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)
    return out


def build(build_dir: str = None, name: str = "fused_update") -> str:
    """compile the source unless its library exists; returns the path.
    Raises RuntimeError with nvcc's output if nvcc is missing or fails."""
    return _finish(*_start(build_dir, name))


def build_all(build_dir: str = None) -> dict:
    "every source's library, one nvcc a source started together: {name: path}"
    jobs = {name: _start(build_dir, name) for name in SOURCES}
    errors, out = [], {}
    for name, job in jobs.items():
        try:
            out[name] = _finish(*job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(build_dir: str = None, name: str = "fused_update") -> str:
    "nvcc's and ptxas's report of the library's build"
    with open(library_path(build_dir, name) + ".log") as f:
        return f.read()


def load(name: str = "fused_update") -> ctypes.CDLL:
    "the library, built and bound at the first call"
    global lib, seg_lib, split_lib
    if name == "fused_update":
        if lib is None:
            lib = bind(ctypes.CDLL(build()))
        return lib
    if name == "split_operand":
        if split_lib is None:
            split_lib = bind_split(ctypes.CDLL(build(name=name)))
        return split_lib
    if seg_lib is None:
        seg_lib = bind_segments(ctypes.CDLL(build(name=name)))
    return seg_lib


def bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    "set argtypes and restype of each C entry point (64-bit pointers, ints)"
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    cdll.bnn_fused_update_threads.argtypes = []
    cdll.bnn_fused_update_threads.restype = ctypes.c_int
    cdll.bnn_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.bnn_cuda_error_string.restype = ctypes.c_char_p
    cdll.bnn_fused_langevin_update.argtypes = [
        p, p, p, p, p,            # th, m, v, g, M
        p, p, p,                  # rows, tickets, partials
        p, p,                     # seeds, sigmas (or null)
        i64, f32, i64,            # seed, sigma, seed_offset
        i64, i64, i64, i64,       # K, T, total, blocks_per_chain
        f32, f32, f32, f32,       # mom_decay, grad_lr, pos_c, alpha
        ctypes.c_int, p]          # device, stream
    cdll.bnn_fused_langevin_update.restype = ctypes.c_int
    return cdll


def bind_segments(cdll: ctypes.CDLL) -> ctypes.CDLL:
    "the segments library's entry points"
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    for fn in (cdll.bnn_segments_threads, cdll.bnn_segments_chunk,
               cdll.bnn_segments_piece_cols, cdll.bnn_segments_slots):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    cdll.bnn_segments_error_string.argtypes = [ctypes.c_int]
    cdll.bnn_segments_error_string.restype = ctypes.c_char_p
    cdll.bnn_fused_langevin_update_segments.argtypes = [
        p, p, p, p, p,            # th, m, v, g, M (the buffers)
        p, i64, i64,              # pieces, n_pieces, n_groups
        i64, ctypes.c_int,        # blocks_per_chain, aligned
        p, p, p,                  # rows, tickets, partials
        p, p,                     # seeds, sigmas (or null)
        i64, f32, i64, i64,       # seed, sigma, seed_offset, K
        f32, f32, f32, f32,       # mom_decay, grad_lr, pos_c, alpha
        ctypes.c_int, p]          # device, stream
    cdll.bnn_fused_langevin_update_segments.restype = ctypes.c_int
    got = (cdll.bnn_segments_chunk(), cdll.bnn_segments_piece_cols(),
           cdll.bnn_segments_slots())
    if got != SEGMENT_LAYOUT:
        raise RuntimeError(f"the segments kernel takes (chunk, columns, "
                           f"slots) {got}, the wrapper {SEGMENT_LAYOUT}")
    return cdll


def bind_split(cdll: ctypes.CDLL) -> ctypes.CDLL:
    "the split library's entry points"
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (cdll.bnn_split_threads, cdll.bnn_split_max_select,
               cdll.bnn_split_max_entries):
        fn.argtypes = []
        fn.restype = c_int
    cdll.bnn_split_error_string.argtypes = [c_int]
    cdll.bnn_split_error_string.restype = ctypes.c_char_p
    # both return the launches made, or -(CUDA error)
    cdll.bnn_split_operand.argtypes = [
        p, p, i64, i64,           # x, out, rows, M
        c_int, c_int, ctypes.c_uint, c_int,  # n, P, select, half
        c_int, p]                 # device, stream
    cdll.bnn_split_operand.restype = c_int
    cdll.bnn_split_table.argtypes = [
        p, p, ctypes.POINTER(i64), i64,  # src, dst, ops (4 an operand), count
        c_int, c_int, ctypes.c_uint, c_int,  # n, P, select, half
        c_int, p]                 # device, stream
    cdll.bnn_split_table.restype = c_int
    return cdll
