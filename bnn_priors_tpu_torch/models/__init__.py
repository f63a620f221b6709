"Models with priors (ResNet-20, its building blocks, prior-only models)."
from .base import ClassificationModel, Model
from .conv_nets import Conv2dPrior
from .dense_nets import LinearPrior
from .google_resnet import BasicBlock, CorrelatedResNet, ResNet
from .layers import (AvgPool2d, BatchNorm2d, Conv2d, Flatten, Identity,
                     Linear, ReLU, Sequential)
from .prior_only import GaussianModel, PriorOnlyModel

__all__ = ("Model", "ClassificationModel", "Conv2dPrior", "LinearPrior",
           "BasicBlock", "ResNet", "CorrelatedResNet", "AvgPool2d",
           "BatchNorm2d", "Conv2d", "Flatten", "Identity", "Linear", "ReLU",
           "Sequential", "PriorOnlyModel", "GaussianModel")
