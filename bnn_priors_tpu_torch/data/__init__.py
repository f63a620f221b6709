"Datasets (synthetic CIFAR-10 so far) and CIFAR-10's augmentation."
from .base import DataContainer, Dataset
from .cifar import (CIFAR10, CIFAR10Augmented, FakeCIFAR10, crop_flip,
                    draw_crop_flip, random_crop_flip)

__all__ = ("DataContainer", "Dataset", "CIFAR10", "CIFAR10Augmented",
           "FakeCIFAR10", "crop_flip", "draw_crop_flip", "random_crop_flip")
