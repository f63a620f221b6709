"Models with priors (ResNet-20, the MNIST CNNs and MLPs, dense regression, prior-only models)."
from .base import ClassificationModel, Model, RegressionModel
from .conv_nets import (ClassificationConvNet, Conv2dPrior,
                        CorrelatedClassificationConvNet)
from .dense_nets import (ClassificationDenseNet, DenseNet, LinearNealNormal,
                         LinearPrior, LinearRegression, LogisticRegression)
from .google_resnet import BasicBlock, CorrelatedResNet, ResNet
from .layers import (AvgPool2d, BatchNorm2d, Conv2d, Flatten, FlattenHWC,
                     Identity, ImageInput, Linear, MaxPool2d, ReLU,
                     Sequential)
from .prior_only import GaussianModel, PriorOnlyModel

__all__ = ("Model", "ClassificationModel", "RegressionModel", "Conv2dPrior",
           "ClassificationConvNet", "CorrelatedClassificationConvNet",
           "LinearNealNormal", "LinearPrior", "DenseNet",
           "ClassificationDenseNet", "LinearRegression", "LogisticRegression",
           "BasicBlock", "ResNet", "CorrelatedResNet", "AvgPool2d",
           "BatchNorm2d", "Conv2d", "Flatten", "FlattenHWC", "Identity",
           "ImageInput", "Linear", "MaxPool2d", "ReLU", "Sequential",
           "PriorOnlyModel", "GaussianModel")
