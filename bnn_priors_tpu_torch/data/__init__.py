"""Datasets (CIFAR-10 and MNIST-family from local files, the bundled UCI
splits, synthetic CIFAR-10 and MNIST), CIFAR-10's augmentation."""
from .base import DataContainer, Dataset
from .cifar import (CIFAR10, CIFAR10Augmented, CIFAR10Small, FakeCIFAR10,
                    crop_flip, draw_crop_flip, random_crop_flip,
                    write_cifar10_batches)
from .mnist import (FakeMNIST, FashionMNIST, MNIST, RotatedMNIST,
                    write_idx_files)
from .uci import UCI, UCI_DATASETS

__all__ = ("DataContainer", "Dataset", "CIFAR10", "CIFAR10Augmented",
           "CIFAR10Small", "FakeCIFAR10", "crop_flip", "draw_crop_flip",
           "random_crop_flip", "write_cifar10_batches", "MNIST",
           "FashionMNIST", "RotatedMNIST", "FakeMNIST", "write_idx_files",
           "UCI", "UCI_DATASETS")
