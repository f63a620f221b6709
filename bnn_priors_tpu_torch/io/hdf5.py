"""HDF5 persistence: metrics time-series and posterior-sample bank
(counterpart of `bnn_priors_tpu/io/hdf5.py`, a copy of its own).

Format-compatible re-implementation of the reference's `HDF5Metrics` and
`HDF5ModelSaver` (`bnn_priors/exp_utils.py:409-536`): append-only resizable
chunked datasets (one per metric / state_dict key) plus `steps` and
`timestamps`, fletcher32 checksums, and SWMR mode so readers can attach to
a live run. The files are the JAX package's: the same datasets, dtypes,
shapes, chunks and filters, so either package reads the other's.

h5py is optional at import: the package imports without it, and a saver
(or `load_samples`) raises ImportError when it is absent.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np

try:
    import h5py
    HAVE_H5PY = True
except ImportError:  # pragma: no cover
    HAVE_H5PY = False


def _require_h5py():
    if not HAVE_H5PY:
        raise ImportError("h5py is not installed: the HDF5 metrics and "
                          "sample files need it (pip install h5py)")


class HDF5Metrics:
    "Chunked in-memory cache of scalars keyed by monotonically increasing step."

    def __init__(self, path, mode="w", chunk_size=8 * 1024):
        _require_h5py()
        self.f = h5py.File(path, mode, libver="latest")
        self.chunk_size = chunk_size
        self.step = -(2 ** 62)
        self.last_flush = time.time()
        self._cache: Dict[str, list] = {}
        self._cache_steps: list = []
        self._datasets: Dict[str, h5py.Dataset] = {}
        self._swmr_started = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_scalar(self, name, value, step):
        if step > self.step:
            self.step = step
            self._cache_steps.append(step)
            for vals in self._cache.values():
                vals.append(_nan_for(vals))
        elif step < self.step:
            raise ValueError(f"step went backwards ({self.step} -> {step})")
        elif not self._cache_steps:
            # same step logged again right after a full flush
            self._cache_steps.append(step)
            for vals in self._cache.values():
                vals.append(_nan_for(vals))
        if name not in self._cache:
            # backfill with NaN for all prior cached steps
            self._cache[name] = [_nan_value(value)] * len(self._cache_steps)
        self._cache[name][-1] = value
        return self

    def add_rows(self, columns: Dict[str, "np.ndarray"], steps):
        """Vectorized `add_scalar`: append a whole block of rows at once.
        `steps` is strictly increasing; `columns` maps metric name to a
        `(len(steps),)` value array. A first row at the current
        (still-cached) step merges into it — that is how a per-epoch metric
        block joins the previous epoch's boundary/eval row, which lives at
        the same step index. Orders of magnitude fewer Python calls than
        per-scalar writes for wide metric schemas (e.g. the per-parameter
        temperature series of a ResNet)."""
        steps = np.asarray(steps, dtype=np.int64)
        n = int(steps.size)
        if n == 0:
            return self
        assert np.all(np.diff(steps) > 0), "steps must be strictly increasing"
        cols = {}
        for name, vals in columns.items():
            arr = np.asarray(vals)
            assert arr.shape == (n,), (name, arr.shape, n)
            cols[name] = arr
        start = 0
        first = int(steps[0])
        if first < self.step:
            raise ValueError(f"step went backwards ({self.step} -> {first})")
        if first == self.step:
            if not self._cache_steps:  # row was just flushed; re-open it
                self._cache_steps.append(self.step)
                for vals in self._cache.values():
                    vals.append(_nan_for(vals))
            for name, arr in cols.items():
                if name not in self._cache:
                    self._cache[name] = ([_nan_scalar(arr.dtype)]
                                         * len(self._cache_steps))
                self._cache[name][-1] = arr[0]
            start = 1
        if n - start == 0:
            return self
        base = len(self._cache_steps)
        self._cache_steps.extend(int(s) for s in steps[start:])
        filler_n = n - start
        for name, vals in self._cache.items():
            if name in cols:
                vals.extend(cols[name][start:])
            else:
                vals.extend([_nan_for(vals)] * filler_n)
        for name, arr in cols.items():
            if name not in self._cache:
                self._cache[name] = ([_nan_scalar(arr.dtype)] * base
                                     + list(arr[start:]))
        self.step = int(steps[-1])
        return self

    def flush(self, every_s: float = 0, keep_last_row: bool = False):
        """Write cached rows to disk. With `keep_last_row`, the most recent
        step's row stays in cache (it may still receive metrics)."""
        if time.time() - self.last_flush < every_s:
            return
        self.last_flush = time.time()
        n_new = len(self._cache_steps) - (1 if keep_last_row else 0)
        if n_new <= 0:
            return
        self._append("steps",
                     np.asarray(self._cache_steps[:n_new], dtype=np.int64))
        self._append("timestamps",
                     np.full(n_new, time.time(), dtype=np.float64))
        for name, vals in self._cache.items():
            arr = np.asarray(vals[:n_new])
            ds = self._ensure(name, arr.dtype)
            cur = self._datasets["steps"].shape[0] - n_new
            if ds.shape[0] < cur:
                pad = np.full(cur - ds.shape[0], _nan_scalar(arr.dtype),
                              dtype=arr.dtype)
                self._append(name, pad, dtype=arr.dtype)
            self._append(name, arr, dtype=arr.dtype)
            del vals[:n_new]
        del self._cache_steps[:n_new]
        self.f.flush()
        if not self._swmr_started:
            try:
                self.f.swmr_mode = True
                self._swmr_started = True
            except Exception:
                pass

    def _ensure(self, name, dtype):
        if name not in self._datasets:
            if name in self.f:
                self._datasets[name] = self.f[name]
            else:
                self._datasets[name] = self.f.create_dataset(
                    name, shape=(0,), maxshape=(None,), dtype=dtype,
                    chunks=(self.chunk_size,), fletcher32=True)
        return self._datasets[name]

    def _append(self, name, arr, dtype=None):
        ds = self._ensure(name, dtype or arr.dtype)
        n0 = ds.shape[0]
        ds.resize(n0 + len(arr), axis=0)
        ds[n0:] = arr
        return ds

    def close(self):
        self.flush()
        self.f.close()


def _nan_value(like):
    if isinstance(like, (bool, np.bool_)):
        return False
    if isinstance(like, (int, np.integer)):
        return np.int64(-(2 ** 63))  # int64 NaN quirk, like the reference
    return math.nan


def _nan_for(vals):
    return _nan_value(vals[-1]) if vals else math.nan


def _nan_scalar(dtype):
    if np.issubdtype(dtype, np.integer):
        return np.int64(-(2 ** 63))
    if np.issubdtype(dtype, np.bool_):
        return False
    return math.nan


class HDF5ModelSaver:
    "Append state_dicts (one resizable dataset per key) with steps/timestamps."

    def __init__(self, path, mode="w"):
        _require_h5py()
        self.f = h5py.File(path, mode, libver="latest")
        self._n = 0
        self._swmr_started = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_state_dict(self, state_dict: Dict[str, np.ndarray], step: int):
        for k, v in state_dict.items():
            v = np.asarray(v)
            ds = self._ensure(k, v.shape, v.dtype)
            ds.resize(self._n + 1, axis=0)
            ds[self._n] = v
        self._ensure("steps", (), np.int64).resize(self._n + 1, axis=0)
        self.f["steps"][self._n] = step
        self._ensure("timestamps", (), np.float64).resize(self._n + 1, axis=0)
        self.f["timestamps"][self._n] = time.time()
        self._n += 1

    def _ensure(self, name, shape, dtype):
        if name not in self.f:
            self.f.create_dataset(
                name, shape=(0,) + tuple(shape),
                maxshape=(None,) + tuple(shape), dtype=dtype,
                chunks=(1,) + tuple(shape) if shape else (1024,),
                fletcher32=True)
        return self.f[name]

    def flush(self):
        self.f.flush()
        if not self._swmr_started:
            try:
                self.f.swmr_mode = True
                self._swmr_started = True
            except Exception:
                pass

    def load_samples(self, keep_steps=True):
        out = {k: np.asarray(self.f[k]) for k in self.f.keys()
               if k != "timestamps" and (keep_steps or k != "steps")}
        return out

    def close(self):
        self.flush()
        self.f.close()


def load_samples(path, keep_steps=False):
    """Load a sample bank from HDF5 (reference exp_utils.py:539-551)."""
    _require_h5py()
    with h5py.File(path, "r", libver="latest", swmr=True) as f:
        return {k: np.asarray(f[k]) for k in f.keys()
                if k != "timestamps" and (keep_steps or k != "steps")}


def load_metrics(path, keys):
    "the named series of a metrics file that it holds, as numpy arrays"
    _require_h5py()
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in keys if k in f}
