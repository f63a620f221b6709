"""Dense (MLP) models with priors (counterpart of
`bnn_priors_tpu/models/dense_nets.py`): `LinearPrior`, the dense stack of
`DenseNet` (regression) and `ClassificationDenseNet` (the FCNN), and the
one-layer `LinearRegression` and `LogisticRegression`."""
from __future__ import annotations

from .. import priors as prior
from .base import ClassificationModel, RegressionModel
from .layers import Linear, ReLU, Sequential

__all__ = ("LinearNealNormal", "LinearPrior", "DenseNet",
           "ClassificationDenseNet", "LinearRegression", "LogisticRegression")


def LinearNealNormal(in_dim: int, out_dim: int, std_w: float, std_b: float):
    return Linear(prior.Normal((out_dim, in_dim), 0.0, std_w / in_dim ** 0.5),
                  prior.Normal((out_dim,), 0.0, std_b))


def LinearPrior(in_dim, out_dim, prior_w=prior.Normal, loc_w=0.0, std_w=1.0,
                prior_b=prior.Normal, loc_b=0.0, std_b=1.0, scaling_fn=None,
                weight_prior_params={}, bias_prior_params={}):
    if scaling_fn is None:
        def scaling_fn(std, dim):
            return std / dim ** 0.5
    return Linear(prior_w((out_dim, in_dim), loc_w, scaling_fn(std_w, in_dim),
                          **weight_prior_params),
                  prior_b((out_dim,), 0.0, std_b, **bias_prior_params))


def _dense_stack(in_features, out_features, width, depth, **kw):
    "linear-relu × (depth-1), then a linear layer (dense_nets.py:37-47)"
    layers = [LinearPrior(in_features, width, **kw), ReLU()]
    for _ in range(depth - 2):
        layers += [LinearPrior(width, width, **kw), ReLU()]
    layers.append(LinearPrior(width, out_features, **kw))
    return Sequential(*layers)


def DenseNet(in_features, out_features, width, depth=3, noise_std=1.0,
             prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
             prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
             scaling_fn=None, weight_prior_params={}, bias_prior_params={}):
    net = _dense_stack(in_features, out_features, width, depth,
                       prior_w=prior_w, loc_w=loc_w, std_w=std_w,
                       prior_b=prior_b, loc_b=loc_b, std_b=std_b,
                       scaling_fn=scaling_fn,
                       weight_prior_params=weight_prior_params,
                       bias_prior_params=bias_prior_params)
    return RegressionModel(net, noise_std)


def ClassificationDenseNet(in_features, out_features, width, depth=3,
                           softmax_temp=1.0, prior_w=prior.Normal, loc_w=0.0,
                           std_w=2 ** 0.5, prior_b=prior.Normal, loc_b=0.0,
                           std_b=1.0, scaling_fn=None,
                           weight_prior_params={}, bias_prior_params={}):
    net = _dense_stack(in_features, out_features, width, depth,
                       prior_w=prior_w, loc_w=loc_w, std_w=std_w,
                       prior_b=prior_b, loc_b=loc_b, std_b=std_b,
                       scaling_fn=scaling_fn,
                       weight_prior_params=weight_prior_params,
                       bias_prior_params=bias_prior_params)
    return ClassificationModel(net, softmax_temp)


def LinearRegression(in_features, out_features, noise_std=1.0,
                     prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
                     prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                     scaling_fn=None, weight_prior_params={},
                     bias_prior_params={}):
    return RegressionModel(
        LinearPrior(in_features, out_features, prior_w=prior_w, loc_w=loc_w,
                    std_w=std_w, prior_b=prior_b, loc_b=loc_b, std_b=std_b,
                    scaling_fn=scaling_fn,
                    weight_prior_params=weight_prior_params,
                    bias_prior_params=bias_prior_params),
        noise_std=noise_std)


def LogisticRegression(in_features, out_features, softmax_temp=1.0,
                       prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
                       prior_b=prior.Normal, loc_b=0.0, std_b=1.0,
                       scaling_fn=None, weight_prior_params={},
                       bias_prior_params={}):
    return ClassificationModel(
        LinearPrior(in_features, out_features, prior_w=prior_w, loc_w=loc_w,
                    std_w=std_w, prior_b=prior_b, loc_b=loc_b, std_b=std_b,
                    scaling_fn=scaling_fn,
                    weight_prior_params=weight_prior_params,
                    bias_prior_params=bias_prior_params),
        softmax_temp=softmax_temp)
