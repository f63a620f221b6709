"""CIFAR-10 (counterpart of `bnn_priors_tpu/data/cifar.py`).

Only the channel-stats normalisation (`CIFAR10._save_datasets`) and the
synthetic `FakeCIFAR10` are ported: the real CIFAR-10 files are not in the
repository, so loading them, augmentation and the CIFAR-10-C/SVHN variants
wait for a later slice. The arrays are made and normalised with numpy
exactly as the JAX package makes them (same `RandomState(seed)`), then
placed on `device`.
"""
from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .base import DataContainer, Dataset

__all__ = ("CIFAR10", "FakeCIFAR10")


class CIFAR10(DataContainer):
    def _save_datasets(self, xtr, xte, ytr, yte, device):
        "NCHW layout with per-channel train-set normalisation (cifar.py:35-60)"
        X_unnorm = np.concatenate([xtr, xte])
        y = np.concatenate([ytr, yte]).astype(np.int64)
        index_train = np.arange(len(xtr))
        index_test = np.arange(len(xtr), len(xtr) + len(xte))
        self.unnorm = Dataset(X_unnorm, y, index_train, index_test, device)
        X_std = np.std(X_unnorm[index_train], axis=(0, 2, 3), keepdims=True,
                       ddof=1)
        X_mean = np.mean(X_unnorm[index_train], axis=(0, 2, 3), keepdims=True)
        self.X_std, self.X_mean = X_std, X_mean
        X_norm = (X_unnorm - X_mean) / X_std
        self.norm = Dataset(X_norm, y, index_train, index_test, device)


class FakeCIFAR10(CIFAR10):
    "Synthetic CIFAR-shaped data for tests and runs without the files."

    def __init__(self, dtype="float32", n_train=50000, n_test=10000, seed=0,
                 device="cuda"):
        device = resolve_device(device)
        rng = np.random.RandomState(seed)
        n = n_train + n_test
        y = rng.randint(0, 10, n).astype(np.int64)
        x = rng.randint(0, 256, (n, 3, 32, 32)).astype(dtype)
        for c in range(10):
            x[y == c, :, 2 + c, :] = 255.0
        self._save_datasets(x[:n_train], x[n_train:], y[:n_train], y[n_train:],
                            device)
