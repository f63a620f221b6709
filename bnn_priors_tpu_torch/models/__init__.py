"""Models with priors (ResNet-20, the PreAct ResNets, the MNIST CNNs and
MLPs, the data-driven models, dense regression, the Rao-Blackwellized
regressions, prior-only models)."""
from .base import ClassificationModel, Model, RegressionModel
from .conv_nets import (ClassificationConvNet, Conv2dPrior,
                        CorrelatedClassificationConvNet, PreActBlock,
                        PreActResNet, PreActResNet18, PreActResNet34,
                        ThinPreActResNet18)
from .data_driven import (DataDrivenDoubleGammaClassificationConvNet,
                          DataDrivenGaussianClassificationConvNet,
                          DataDrivenMVTGoogleResNet, DataDrivenPreActResNet18,
                          DecreasingMVTGoogleResNet, default_fits_root,
                          load_lengthscales, read_fit, replace_prior)
from .dense_nets import (ClassificationDenseNet, DenseNet, LinearNealNormal,
                         LinearPrior, LinearRegression, LogisticRegression)
from .google_resnet import BasicBlock, CorrelatedResNet, ResNet
from .layers import (AvgPool2d, BatchNorm2d, Conv2d, Flatten, FlattenHWC,
                     Identity, ImageInput, Linear, MaxPool2d, ReLU,
                     Sequential)
from .prior_only import (GaussianModel, NealFunnel, NealFunnelT,
                         PriorOnlyModel)
from .raob import RaoBDenseNet, RaoBLinearRegression, RaoBRegressionModel

__all__ = ("Model", "ClassificationModel", "RegressionModel", "Conv2dPrior",
           "ClassificationConvNet", "CorrelatedClassificationConvNet",
           "PreActBlock", "PreActResNet", "PreActResNet18", "PreActResNet34",
           "ThinPreActResNet18",
           "DataDrivenGaussianClassificationConvNet",
           "DataDrivenDoubleGammaClassificationConvNet",
           "DataDrivenMVTGoogleResNet", "DecreasingMVTGoogleResNet",
           "DataDrivenPreActResNet18", "replace_prior", "load_lengthscales",
           "default_fits_root", "read_fit",
           "LinearNealNormal", "LinearPrior", "DenseNet",
           "ClassificationDenseNet", "LinearRegression", "LogisticRegression",
           "BasicBlock", "ResNet", "CorrelatedResNet", "AvgPool2d",
           "BatchNorm2d", "Conv2d", "Flatten", "FlattenHWC", "Identity",
           "ImageInput", "Linear", "MaxPool2d", "ReLU", "Sequential",
           "PriorOnlyModel", "GaussianModel", "NealFunnel", "NealFunnelT",
           "RaoBRegressionModel", "RaoBDenseNet", "RaoBLinearRegression")
