"""Persistence: HDF5 metrics time-series and sample banks, and full
chain-state checkpoints."""
from .checkpoint import (load_chain_checkpoint, restore_chain_checkpoint,
                         save_chain_checkpoint)
from .hdf5 import (HAVE_H5PY, HDF5Metrics, HDF5ModelSaver, load_metrics,
                   load_samples)

__all__ = ("HAVE_H5PY", "HDF5Metrics", "HDF5ModelSaver", "load_metrics",
           "load_samples", "load_chain_checkpoint", "restore_chain_checkpoint",
           "save_chain_checkpoint")
