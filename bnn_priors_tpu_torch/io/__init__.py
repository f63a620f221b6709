"""Persistence: HDF5 metrics time-series and sample banks (chain
checkpoints are not ported yet)."""
from .hdf5 import (HAVE_H5PY, HDF5Metrics, HDF5ModelSaver, load_metrics,
                   load_samples)

__all__ = ("HAVE_H5PY", "HDF5Metrics", "HDF5ModelSaver", "load_metrics",
           "load_samples")
