"""Datasets (CIFAR-10, CIFAR-10-C, SVHN and MNIST-family from local files,
the bundled UCI splits, synthetic CIFAR-10 and MNIST, the toy random
datasets and labels drawn from a model), CIFAR-10's augmentation."""
from .base import DataContainer, Dataset
from .cifar import (CIFAR10, CIFAR10_C, SVHN, CIFAR10Augmented, CIFAR10Small,
                    FakeCIFAR10, crop_flip, draw_crop_flip, random_crop_flip,
                    write_cifar10_batches, write_cifar10_c, write_svhn)
from .mnist import (FakeMNIST, FashionMNIST, MNIST, RotatedMNIST,
                    write_idx_files)
from .toy import RandomData, RandomOODTestData, Synthetic
from .uci import UCI, UCI_DATASETS

__all__ = ("DataContainer", "Dataset", "CIFAR10", "CIFAR10Augmented",
           "CIFAR10Small", "CIFAR10_C", "SVHN", "FakeCIFAR10", "crop_flip",
           "draw_crop_flip", "random_crop_flip", "write_cifar10_batches",
           "write_cifar10_c", "write_svhn", "MNIST", "FashionMNIST",
           "RotatedMNIST", "FakeMNIST", "write_idx_files", "RandomData",
           "RandomOODTestData", "Synthetic", "UCI", "UCI_DATASETS")
