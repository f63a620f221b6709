"""MNIST, FashionMNIST, RotatedMNIST and FakeMNIST (counterpart of
`bnn_priors_tpu/data/mnist.py`).

The IDX files (`train-images-idx3-ubyte`, `train-labels-idx1-ubyte`,
`t10k-images-idx3-ubyte`, `t10k-labels-idx1-ubyte`, plain or `.gz`) are
read from `data_root` or its `raw/` folder (torchvision's layout); the
default root is `$BNN_PRIORS_DATA/MNIST` (`FashionMNIST`) and nothing is
downloaded. Images become flat 784-wide rows scaled by 1/255, as in the
JAX package; `RotatedMNIST` appends two rotated copies of the test set
(±45° and ±90°, numpy seed 1337, `scipy.ndimage.rotate` on the host), so
both packages make the same arrays. The arrays are made with numpy, then
placed on `device`. `write_idx_files` writes synthetic files in the real
format, for tests and runs without the real ones.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..device import resolve_device
from .base import DataContainer, Dataset

__all__ = ("MNIST", "FashionMNIST", "RotatedMNIST", "FakeMNIST",
           "write_idx_files")

MNIST_FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
               "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def _read_idx(path):
    "an IDX file of unsigned bytes as an array of its shape"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _load_raw(data_root):
    "the four arrays, each from `data_root` or `data_root/raw`, plain or .gz"
    out = []
    for name in MNIST_FILES:
        found = [os.path.join(d, name + suffix)
                 for d in (data_root, os.path.join(data_root, "raw"))
                 for suffix in ("", ".gz")
                 if os.path.exists(os.path.join(d, name + suffix))]
        if not found:
            raise FileNotFoundError(
                f"{name} not found under {data_root}; place the IDX files "
                "there or use FakeMNIST for synthetic data")
        out.append(_read_idx(found[0]))
    return out


def write_idx_files(data_root, train_x, train_y, test_x, test_y, gz=False):
    """write uint8 images (N, H, W) and labels as the four MNIST IDX files
    under `data_root` (gzipped with `gz`)"""
    os.makedirs(data_root, exist_ok=True)
    for name, arr in zip(MNIST_FILES, (train_x, train_y, test_x, test_y)):
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
            ">" + "I" * arr.ndim, *arr.shape)
        path = os.path.join(data_root, name + (".gz" if gz else ""))
        with (gzip.open if gz else open)(path, "wb") as f:
            f.write(head + arr.tobytes())
    return data_root


class _MNISTBase(DataContainer):
    subdir = "MNIST"

    def __init__(self, dtype="float32", data_root=None, device="cuda"):
        if data_root is None:
            data_root = os.path.join(
                os.environ.get("BNN_PRIORS_DATA", "data"), self.subdir)
        xtr, ytr, xte, yte = _load_raw(data_root)
        self._build(xtr.astype(dtype), ytr.astype(np.int64),
                    xte.astype(dtype), yte.astype(np.int64),
                    resolve_device(device))

    def _arrays(self, xtr, ytr, xte, yte):
        "(X_unnorm (N, 784), y, index_train, index_test)"
        X_unnorm = np.concatenate([xtr, xte]).reshape(-1, 784)
        y = np.concatenate([ytr, yte])
        return (X_unnorm, y, np.arange(len(xtr)),
                np.arange(len(xtr), len(X_unnorm)))

    def _build(self, xtr, ytr, xte, yte, device):
        X_unnorm, y, index_train, index_test = self._arrays(xtr, ytr, xte,
                                                            yte)
        self.unnorm = Dataset(X_unnorm, y, index_train, index_test, device)
        self.norm = Dataset(X_unnorm / 255.0, y, index_train, index_test,
                            device)


class MNIST(_MNISTBase):
    subdir = "MNIST"


class FashionMNIST(_MNISTBase):
    subdir = "FashionMNIST"


class RotatedMNIST(_MNISTBase):
    "the test set + ±45° + ±90° rotations of it (JAX mnist.py:87-115)"

    def _arrays(self, xtr, ytr, xte, yte):
        from scipy import ndimage
        rng = np.random.RandomState(1337)
        imgs = xte.reshape(-1, 28, 28)

        def rotate_all(low, high):
            out = np.zeros_like(imgs)
            for i, img in enumerate(imgs):
                angle = rng.randint(low=low, high=high)
                out[i] = ndimage.rotate(img, angle, reshape=False)
            return out

        rot_small = rotate_all(-45, 45)
        rot_large = rotate_all(-90, 90)
        X_unnorm = np.concatenate(
            [xtr.reshape(-1, 784), xte.reshape(-1, 784),
             rot_small.reshape(-1, 784), rot_large.reshape(-1, 784)])
        y = np.concatenate([ytr, yte, yte, yte])
        return (X_unnorm, y, np.arange(len(xtr)),
                np.arange(len(xtr), len(xtr) + 3 * len(yte)))


class FakeMNIST(_MNISTBase):
    """Deterministic synthetic MNIST-shaped data (class-dependent rows of
    255), the JAX package's arrays from the same seed"""

    def __init__(self, dtype="float32", n_train=60000, n_test=10000, seed=0,
                 device="cuda"):
        device = resolve_device(device)
        rng = np.random.RandomState(seed)
        n = n_train + n_test
        y = rng.randint(0, 10, n).astype(np.int64)
        x = rng.randint(0, 256, (n, 28, 28)).astype(dtype)
        for c in range(10):
            x[y == c, 2 + c, :] = 255.0
        self._build(x[:n_train], y[:n_train], x[n_train:], y[n_train:],
                    device)
