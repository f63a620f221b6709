"""CIFAR-10, CIFAR-10-C and SVHN (counterpart of
`bnn_priors_tpu/data/cifar.py`).

Ported: CIFAR-10 from its python pickle batches (`CIFAR10`,
`CIFAR10Augmented`, `CIFAR10Small`: torchvision's `cifar-10-batches-py`
layout under `data_root`, by default `$BNN_PRIORS_DATA/CIFAR`), the
channel-stats normalisation (`CIFAR10._save_datasets`), the synthetic
`FakeCIFAR10` and the train-time augmentation (random crop with zero
padding plus horizontal flip, `random_crop_flip`). `CIFAR10_C` keeps the
clean CIFAR-10 training set and its normalisation, with a corrupted test
set from `<root>/cifar10-c/CIFAR-10-C/<corruption>.npy` (or
`<root>/CIFAR-10-C/<corruption>.npy`; NHWC uint8, `labels.npy` beside it).
`SVHN` reads `train_32x32.mat` and `test_32x32.mat` under
`$BNN_PRIORS_DATA/SVHN` and is normalised by its own training split. The
`write_*` functions write synthetic files in each layout. The arrays are
read and normalised with numpy exactly as the JAX package does it, then
placed on `device`.

Augmentation runs on the images' device: the offsets and flips are drawn
there from an explicit `torch.Generator` (one integer a image encodes all
three), and the crop and flip are one zero padding plus one gather for the
whole batch. `crop_flip` is the plain function of the draws, so the same
draws give the JAX function's images.
"""
from __future__ import annotations

import os
import pickle
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .base import DataContainer, Dataset

__all__ = ("CIFAR10", "CIFAR10Augmented", "CIFAR10Small", "CIFAR10_C",
           "SVHN", "FakeCIFAR10", "crop_flip", "draw_crop_flip",
           "random_crop_flip", "write_cifar10_batches", "write_cifar10_c",
           "write_svhn")


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


def _default_root(name="CIFAR"):
    return os.path.join(os.environ.get("BNN_PRIORS_DATA", "data"), name)


def _load_cifar10_batches(data_root):
    """(train_x, train_y, test_x, test_y) from the five training batches
    and the test batch, uint8 NCHW images and int labels (cifar.py:29-50)"""
    d = os.path.join(data_root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        d = data_root
    train_x, train_y = [], []
    for i in range(1, 6):
        p = os.path.join(d, f"data_batch_{i}")
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found; place the CIFAR-10 python batches under "
                f"{data_root} or use FakeCIFAR10")
        with open(p, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        train_x.append(batch[b"data"])
        train_y.extend(batch[b"labels"])
    with open(os.path.join(d, "test_batch"), "rb") as f:
        batch = pickle.load(f, encoding="bytes")
    test_x = batch[b"data"].reshape(-1, 3, 32, 32)
    test_y = np.asarray(batch[b"labels"])
    train_x = np.concatenate(train_x).reshape(-1, 3, 32, 32)
    return train_x, np.asarray(train_y), test_x, test_y


def write_cifar10_batches(data_root, train_x, train_y, test_x, test_y):
    """write uint8 images (N, 3, 32, 32) and labels in CIFAR-10's python
    layout: five training batches and a test batch under
    `data_root/cifar-10-batches-py` (synthetic files for tests and runs
    without the real ones)"""
    d = os.path.join(data_root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    parts = np.array_split(np.arange(len(train_x)), 5)
    batches = [(f"data_batch_{i + 1}", train_x[p], train_y[p])
               for i, p in enumerate(parts)]
    for name, x, y in batches + [("test_batch", test_x, test_y)]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": np.asarray(x, np.uint8).reshape(len(x), -1),
                         b"labels": [int(v) for v in y]}, f)
    return d


def _cifar10_c_dir(data_root):
    "the corruptions' directory: cifar10-c/CIFAR-10-C, else CIFAR-10-C"
    d = os.path.join(data_root, "cifar10-c", "CIFAR-10-C")
    return d if os.path.isdir(d) else os.path.join(data_root, "CIFAR-10-C")


def write_cifar10_c(data_root, corruption, images, labels, nested=True):
    """write uint8 images (N, 32, 32, 3) (NHWC, as the real files) and
    their labels as `<corruption>.npy` and `labels.npy` under
    `data_root/cifar10-c/CIFAR-10-C` (`nested`) or `data_root/CIFAR-10-C`"""
    d = (os.path.join(data_root, "cifar10-c", "CIFAR-10-C") if nested
         else os.path.join(data_root, "CIFAR-10-C"))
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, f"{corruption}.npy"),
            np.asarray(images, np.uint8))
    np.save(os.path.join(d, "labels.npy"), np.asarray(labels, np.uint8))
    return d


def write_svhn(data_root, train_x, train_y, test_x, test_y):
    """write uint8 images (N, 3, 32, 32) and labels 0-9 as SVHN's
    `train_32x32.mat` and `test_32x32.mat` under `data_root`: X of shape
    (32, 32, 3, N), y of shape (N, 1) with the digit 0 as label 10"""
    from scipy.io import savemat
    os.makedirs(data_root, exist_ok=True)
    for name, x, y in (("train", train_x, train_y), ("test", test_x, test_y)):
        y = np.asarray(y, np.uint8).reshape(-1, 1)
        savemat(os.path.join(data_root, f"{name}_32x32.mat"),
                {"X": np.asarray(x, np.uint8).transpose(2, 3, 1, 0),
                 "y": np.where(y == 0, 10, y).astype(np.uint8)})
    return data_root


class CIFAR10(DataContainer):
    """CIFAR-10 from its python batches under `data_root` (default
    `$BNN_PRIORS_DATA/CIFAR`), normalised, on `device`"""

    def __init__(self, dtype="float32", data_root=None, device="cuda"):
        self._load(dtype, data_root, device)

    def _load(self, dtype, data_root, device, n_train=None):
        "the files' first `n_train` (default all) training points"
        device = resolve_device(device)
        xtr, ytr, xte, yte = _load_cifar10_batches(data_root or
                                                   _default_root())
        self._save_datasets(xtr[:n_train].astype(dtype), xte.astype(dtype),
                            ytr[:n_train], yte, device)

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
    which `FakeCIFAR10` shares"""

    @staticmethod
    def augment_fn(x, generator):
        return random_crop_flip(x, generator, pad=4)


class CIFAR10Small(CIFAR10):
    "the first `n_train` (5,000) training points (reference cifar.py:175-184)"

    def __init__(self, dtype="float32", data_root=None, n_train=5000,
                 device="cuda"):
        self._load(dtype, data_root, device, n_train)


class CIFAR10_C(CIFAR10):
    """CIFAR-10 with a corrupted test set (Hendrycks & Dietterich, 19
    corruptions; reference cifar.py:63-110): the training set and its
    normalisation are the clean CIFAR-10's. `severity` 1-5 takes that
    severity's 10,000 rows of the file, None all of them"""

    def __init__(self, corruption, dtype="float32", data_root=None,
                 severity=None, device="cuda"):
        device = resolve_device(device)
        data_root = data_root or _default_root()
        xtr, ytr, _, _ = _load_cifar10_batches(data_root)
        cdir = _cifar10_c_dir(data_root)
        xc = np.load(os.path.join(cdir, f"{corruption}.npy"))
        yc = np.load(os.path.join(cdir, "labels.npy"))
        xc = xc.transpose(0, 3, 1, 2)  # NHWC files -> NCHW
        if severity is not None:
            sl = slice((severity - 1) * 10000, severity * 10000)
            xc, yc = xc[sl], yc[sl]
        self._save_datasets(xtr.astype(dtype), xc.astype(dtype), ytr,
                            yc.astype(np.int64), device)


class SVHN(DataContainer):
    """SVHN from its .mat files under `data_root` (default
    `$BNN_PRIORS_DATA/SVHN`), label 10 read as the digit 0, normalised by
    the per-channel mean and std (ddof=1) of SVHN's own training split, as
    the JAX package's code does (its docstring names CIFAR-10's
    statistics; ROADMAP §3)"""

    def __init__(self, dtype="float32", data_root=None, device="cuda"):
        from scipy.io import loadmat
        device = resolve_device(device)
        data_root = data_root or _default_root("SVHN")

        def read(name):
            m = loadmat(os.path.join(data_root, f"{name}_32x32.mat"))
            return (m["X"].transpose(3, 2, 0, 1).astype(dtype),
                    m["y"].astype(np.int64).ravel() % 10)
        xtr, ytr = read("train")
        xte, yte = read("test")
        X_unnorm = np.concatenate([xtr, xte])
        y = np.concatenate([ytr, yte])
        index_train = np.arange(len(xtr))
        index_test = np.arange(len(xtr), len(xtr) + len(xte))
        self.unnorm = Dataset(X_unnorm, y, index_train, index_test, device)
        self.X_std = np.std(xtr, axis=(0, 2, 3), keepdims=True, ddof=1)
        self.X_mean = np.mean(xtr, axis=(0, 2, 3), keepdims=True)
        X_norm = (X_unnorm - self.X_mean) / self.X_std
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

    augment_fn = staticmethod(CIFAR10Augmented.augment_fn)
