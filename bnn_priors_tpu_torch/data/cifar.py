"""CIFAR-10 (counterpart of `bnn_priors_tpu/data/cifar.py`).

Ported: the channel-stats normalisation (`CIFAR10._save_datasets`), the
synthetic `FakeCIFAR10` and the train-time augmentation (random crop with
zero padding plus horizontal flip, `random_crop_flip`). The real CIFAR-10
files are not in the repository, so loading them and the CIFAR-10-C/SVHN
variants wait for a later slice. The arrays are made and normalised with
numpy exactly as the JAX package makes them (same `RandomState(seed)`),
then placed on `device`.

Augmentation runs on the images' device: the offsets and flips are drawn
there from an explicit `torch.Generator` (one integer a image encodes all
three), and the crop and flip are one zero padding plus one gather for the
whole batch. `crop_flip` is the plain function of the draws, so the same
draws give the JAX function's images.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .base import DataContainer, Dataset

__all__ = ("CIFAR10", "CIFAR10Augmented", "FakeCIFAR10", "crop_flip",
           "draw_crop_flip", "random_crop_flip")


def crop_flip(x, dy, dx, flip, pad=4):
    """x (..., C, H, W) zero-padded by `pad` on each side of H and W, then
    each image cropped back to H×W at its offset (dy, dx) and, where
    `flip`, mirrored along W (`random_crop_flip`, cifar.py:77-90, for
    given draws). dy, dx, flip have x's leading shape."""
    *lead, C, H, W = x.shape
    xp = F.pad(x.reshape(-1, C, H, W), (pad, pad, pad, pad))
    dy, dx, flip = (t.reshape(-1, 1).to(x.device) for t in (dy, dx, flip))
    cols = torch.arange(W, device=x.device)
    rows = dy + torch.arange(H, device=x.device)             # (L, H)
    cols = dx + torch.where(flip, W - 1 - cols, cols)        # (L, W)
    img = torch.arange(xp.shape[0], device=x.device)
    out = xp[img[:, None, None, None],
             torch.arange(C, device=x.device)[None, :, None, None],
             rows[:, None, :, None], cols[:, None, None, :]]
    return out.reshape(x.shape)


def draw_crop_flip(shape, generator: torch.Generator, pad=4):
    """(dy, dx, flip) of `shape` from one draw on the generator's device:
    v uniform on [0, 2·(2·pad+1)²) gives dy = v mod n, dx = (v div n) mod n
    (n = 2·pad+1) and flip = v ≥ n², independent and uniform"""
    n = 2 * pad + 1
    v = torch.randint(0, 2 * n * n, tuple(shape), generator=generator,
                      device=generator.device)
    return v % n, (v // n) % n, v >= n * n


def random_crop_flip(x, generator: Union[torch.Generator,
                                         Sequence[torch.Generator]], pad=4):
    """RandomCrop(32, padding=4) + RandomHorizontalFlip on a batch x
    (..., C, H, W) on the device. `generator`: one generator on x's device,
    or a sequence of them, one a row of x's leading axis (one stream a
    chain for a (K, B, C, H, W) batch)."""
    lead = x.shape[:-3]
    if isinstance(generator, torch.Generator):
        dy, dx, flip = draw_crop_flip(lead, generator, pad)
    else:
        draws = [draw_crop_flip(lead[1:], g, pad) for g in generator]
        dy, dx, flip = (torch.stack(t) for t in zip(*draws))
    return crop_flip(x, dy, dx, flip, pad)


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


class CIFAR10Augmented(CIFAR10):
    """CIFAR-10 with train-time RandomCrop(32, padding=4)+HFlip (reference
    cifar.py:136-172): holds the on-device `augment_fn(x, generator)`,
    which `FakeCIFAR10` shares (loading the CIFAR-10 files is not ported)"""

    @staticmethod
    def augment_fn(x, generator):
        return random_crop_flip(x, generator, pad=4)


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

    augment_fn = staticmethod(CIFAR10Augmented.augment_fn)
