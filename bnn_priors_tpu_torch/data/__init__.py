"Datasets (CIFAR-10 from files, synthetic CIFAR-10), CIFAR-10's augmentation."
from .base import DataContainer, Dataset
from .cifar import (CIFAR10, CIFAR10Augmented, CIFAR10Small, FakeCIFAR10,
                    crop_flip, draw_crop_flip, random_crop_flip,
                    write_cifar10_batches)

__all__ = ("DataContainer", "Dataset", "CIFAR10", "CIFAR10Augmented",
           "CIFAR10Small", "FakeCIFAR10", "crop_flip", "draw_crop_flip",
           "random_crop_flip", "write_cifar10_batches")
