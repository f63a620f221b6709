"""UCI regression datasets (counterpart of `bnn_priors_tpu/data/uci.py`).

Nine datasets × 20 train/test splits as text files: `data.txt`,
`index_features.txt`, `index_target.txt`, `index_train_<split>.txt` and
`index_test_<split>.txt` under `<root>/<dataset>/`. The root is
`data_root`, else `$BNN_PRIORS_DATA/UCI`, else the splits that ship in the
repository (`bnn_priors_tpu/data/UCI/`), read there by path as data. Inputs
and targets are normalised with the training split's mean and standard
deviation (ddof=1); targets are (N, 1).
"""
from __future__ import annotations

import os

import numpy as np

from ..device import resolve_device
from .base import DataContainer, Dataset

__all__ = ("UCI", "UCI_DATASETS", "BUNDLED_UCI")

UCI_DATASETS = ("boston", "concrete", "energy", "kin8nm", "naval", "power",
                "protein", "wine", "yacht")
BUNDLED_UCI = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "bnn_priors_tpu", "data", "UCI")


def _find_root(data_root):
    if data_root is not None:
        return data_root
    env = os.environ.get("BNN_PRIORS_DATA")
    for root in ((os.path.join(env, "UCI"),) if env else ()) + (BUNDLED_UCI,):
        if os.path.isdir(root):
            return root
    raise FileNotFoundError(
        "UCI data not found; set BNN_PRIORS_DATA or pass data_root")


class UCI(DataContainer):
    def __init__(self, dataset: str, split: int, dtype="float32",
                 data_root=None, device="cuda"):
        device = resolve_device(device)
        d = os.path.join(_find_root(data_root), dataset)
        load = lambda name: np.loadtxt(os.path.join(d, name))
        data = load("data.txt").astype(dtype)
        index_features = load("index_features.txt").astype(int)
        index_target = int(load("index_target.txt"))
        X_unnorm = data[:, index_features]
        y_unnorm = data[:, index_target:index_target + 1]
        index_train = load(f"index_train_{split}.txt").astype(int)
        index_test = load(f"index_test_{split}.txt").astype(int)
        self.unnorm = Dataset(X_unnorm, y_unnorm, index_train, index_test,
                              device)

        train_X, train_y = X_unnorm[index_train], y_unnorm[index_train]
        X_std = np.std(train_X, 0, ddof=1)
        X_std[X_std == 0] = 1.0
        self.X_std, self.X_mean = X_std, np.mean(train_X, 0)
        self.y_mean = np.mean(train_y)
        self.y_std = np.std(train_y, ddof=1)
        X_norm = (X_unnorm - self.X_mean) / self.X_std
        y_norm = (y_unnorm - self.y_mean) / self.y_std
        self.norm = Dataset(X_norm, y_norm, index_train, index_test, device)
