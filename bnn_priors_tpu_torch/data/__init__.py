"Datasets (synthetic CIFAR-10 so far)."
from .base import DataContainer, Dataset
from .cifar import CIFAR10, FakeCIFAR10

__all__ = ("DataContainer", "Dataset", "CIFAR10", "FakeCIFAR10")
