"""Dataset containers (counterpart of `bnn_priors_tpu/data/base.py`).

A `Dataset` holds the full X/y on one device with train/test index splits:
the runners want the whole training set resident on the card and gather
minibatches there.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ("Dataset", "DataContainer")


def _on(a, device):
    "a tensor (moved) or an array (copied) on `device`"
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


class Dataset:
    """Full dataset on `device` (the card unless the caller asks for the
    CPU); train/test views via index arrays. X and y are arrays or
    tensors."""

    def __init__(self, X, y, index_train, index_test, device="cuda"):
        self.X = _on(X, device)
        self.y = _on(y, device)
        index_train = torch.as_tensor(np.asarray(index_train, dtype=np.int64),
                                      device=device)
        index_test = torch.as_tensor(np.asarray(index_test, dtype=np.int64),
                                     device=device)
        self.train_X = self.X[index_train]
        self.train_y = self.y[index_train]
        self.test_X = self.X[index_test]
        self.test_y = self.y[index_test]

    @property
    def train(self):
        return (self.train_X, self.train_y)

    @property
    def test(self):
        return (self.test_X, self.test_y)


class DataContainer:
    """Common base for named datasets: a `norm`/`unnorm` Dataset pair,
    mirroring the reference API (`.norm.train` etc.)."""

    norm: Dataset
    unnorm: Dataset
