"""Toy datasets (counterpart of `bnn_priors_tpu/data/toy.py`): uniform
random regression data, and its out-of-distribution variant whose test
points lie outside the training range. Both draw from
`np.random.RandomState(seed)` in the JAX package's order, so one seed gives
its points exactly; the registry pins `seed` to the run's config seed.
`Synthetic` takes a dataset's inputs and draws its labels from a model's
predictive there."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .base import DataContainer, Dataset

__all__ = ("RandomData", "RandomOODTestData", "Synthetic")

# points a forward pass of `Synthetic`'s model: bounds the activations'
# memory on the card (the CNN on 70,000 MNIST images in one pass would hold
# gigabytes of them)
SYNTHETIC_CHUNK = 10000


class RandomData(DataContainer):
    "Uniform[-1,1] inputs/targets, half train / half test (toy_data.py:11-52)."

    def __init__(self, dim=20, n_points=2000, dtype="float32", seed=None,
                 device="cuda"):
        rng = np.random.RandomState(seed)
        X_unnorm = rng.uniform(-1, 1, [n_points, dim]).astype(dtype)
        y_unnorm = rng.uniform(-1, 1, [n_points, 1]).astype(dtype)
        self._build(X_unnorm, y_unnorm, n_points // 2, device)

    def _build(self, X_unnorm, y_unnorm, len_train, device):
        """the first `len_train` points train, the rest test; inputs and
        targets normalised by the training points' mean and std (ddof=1), a
        constant input column by 1"""
        device = resolve_device(device)
        n_points = len(X_unnorm)
        index_train = np.arange(len_train)
        index_test = np.arange(len_train, n_points)
        self.unnorm = Dataset(X_unnorm, y_unnorm, index_train, index_test,
                              device)
        X_std = np.std(X_unnorm[index_train], 0, ddof=1)
        X_std[X_std == 0] = 1.0
        self.X_std, self.X_mean = X_std, np.mean(X_unnorm[index_train], 0)
        self.y_mean = np.mean(y_unnorm[index_train])
        self.y_std = np.std(y_unnorm[index_train], ddof=1)
        X_norm = (X_unnorm - self.X_mean) / self.X_std
        y_norm = (y_unnorm - self.y_mean) / self.y_std
        self.norm = Dataset(X_norm, y_norm, index_train, index_test, device)


class RandomOODTestData(RandomData):
    "train Uniform[-1,1], test Uniform[1,2] (toy_data.py:55-91)"

    def __init__(self, dim=20, n_points=2000, dtype="float32", seed=None,
                 device="cuda"):
        rng = np.random.RandomState(seed)
        len_train = n_points // 2
        X = np.concatenate([
            rng.uniform(-1, 1, [len_train, dim]),
            rng.uniform(1, 2, [n_points - len_train, dim])]).astype(dtype)
        y = np.concatenate([
            rng.uniform(-1, 1, [len_train, 1]),
            rng.uniform(1, 2, [n_points - len_train, 1])]).astype(dtype)
        self._build(X, y, len_train, device)


class Synthetic(DataContainer):
    """Labels drawn from `model`'s predictive at `dataset`'s inputs, for
    posterior-recovery experiments (toy.py:54-78): categorical over the
    logits for a classification model (Gumbel-max), mean + std·ε
    otherwise. The model runs on the dataset's device, in eval mode, over
    `SYNTHETIC_CHUNK` points at a time; the noise (Gumbel or ε) is drawn
    in float64 on the CPU from `generator`, so one seed gives the same
    draws on any device. The first len(train) points train and the rest
    test, as in the JAX package; the inputs are the dataset's own (`norm`
    and `unnorm`), both with the new labels."""

    def __init__(self, dataset, model,
                 generator: Optional[torch.Generator] = None):
        from ..models.base import ClassificationModel
        X = dataset.norm.X
        device = X.device
        with torch.no_grad():
            f = torch.cat([
                model.net_apply(None, X[s:s + SYNTHETIC_CHUNK], train=False)
                for s in range(0, X.shape[0], SYNTHETIC_CHUNK)])
            if isinstance(model, ClassificationModel):
                logits = model._logits(f).double().cpu()
                u = torch.rand(logits.shape, generator=generator,
                               dtype=torch.float64)
                new_y = (logits - torch.log(-torch.log(u))).argmax(-1)
            else:
                eps = torch.randn(f.shape, generator=generator,
                                  dtype=torch.float64)
                new_y = f + model._noise_std(None, f) * eps.to(device,
                                                               f.dtype)
        new_y = new_y.to(device)
        len_train = dataset.norm.train_X.shape[0]
        index_train = np.arange(len_train)
        index_test = np.arange(len_train, X.shape[0])
        self.unnorm = Dataset(dataset.unnorm.X, new_y, index_train,
                              index_test, device)
        self.norm = Dataset(X, new_y, index_train, index_test, device)
