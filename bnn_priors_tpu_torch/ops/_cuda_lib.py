"""Builds and loads the port's CUDA C++ kernel (`csrc/fused_update.cu`) at
first use.

`nvcc` compiles the source for Hopper (`sm_90a`) into a shared library with
a plain C interface under `build/kernels/` beside the package, named by a
hash of the source and the flags, so a stale build is never loaded. The
library is written under a temporary name and moved into place, so a build
cut short leaves nothing that a later call would load. `ptxas`'s report
(registers, shared memory, spills) is kept beside it as `<name>.log`.

A missing `nvcc` or a failed build raises with the compiler's output: the
kernel has no fallback. Nothing here runs on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_update.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# the loaded library, once `load` has run
lib = None


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


def library_path(build_dir: str = None) -> str:
    "where the library of the current source and flags is built"
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR if build_dir is None else build_dir,
                        f"fused_update_{digest.hexdigest()[:16]}.so")


def build(build_dir: str = None) -> str:
    """compile the source unless its library exists; returns the path.
    Raises RuntimeError with nvcc's output if nvcc is missing or fails."""
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)
    return out


def build_log(build_dir: str = None) -> str:
    "nvcc's and ptxas's report of the library's build"
    with open(library_path(build_dir) + ".log") as f:
        return f.read()


def load() -> ctypes.CDLL:
    "the library, built and bound at the first call"
    global lib
    if lib is None:
        lib = bind(ctypes.CDLL(build()))
    return lib


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
