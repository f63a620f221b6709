"""Rao-Blackwellized Gaussian regression (counterpart of
`bnn_priors_tpu/models/raob.py`): the last layer's weights are integrated
out analytically.

With iid N(0, last_layer_std²) last-layer weights, the marginal likelihood
of y given features f = net(x) is N(y | 0, llv·ffᵀ + σ²I), evaluated via
the Woodbury identity with a float64 Cholesky:
    log p(y) = -D/2 [ N log 2π + (N-F) log σ² + tr(YᵀY)/(D σ²)
                      + log det(llv·fᵀf + σ²I) − ‖L⁻¹ fᵀy‖²·llv/(D σ²) ]
The predictive at new features marginalizes the conjugate posterior over
the last-layer weights.

`log_likelihood` is the marginal likelihood of the WHOLE training set
whatever minibatch it is given, and its features are the training set's,
as in the JAX package. So the models serve as a library (likelihood,
posterior, predictive); the CLIs refuse them, since the minibatch accuracy
cannot take whole-set features (ROADMAP §3).
"""
from __future__ import annotations

import math

import torch

from .. import priors as prior
from ..priors.base import Prior
from .base import RegressionModel
from .dense_nets import LinearPrior
from .layers import Identity, ReLU, Sequential

__all__ = ("RaoBRegressionModel", "RaoBDenseNet", "RaoBLinearRegression")


def _solve_lower(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


class RaoBRegressionModel(RegressionModel):
    """the training set (x_train (N, F_in), y_train (N, 1)) is held by the
    model and follows it in `.to(device/dtype)`; it is neither a parameter
    nor a buffer, so no sample or checkpoint carries it"""

    def __init__(self, x_train, y_train, noise_std, last_layer_std, net):
        assert x_train.ndim == 2
        assert x_train.shape[0] == y_train.shape[0]
        assert y_train.shape[1] == 1
        super().__init__(net, noise_std)
        self.x_train = torch.as_tensor(x_train)
        self.y_train = torch.as_tensor(y_train)
        self.last_layer_std = float(last_layer_std)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.x_train, self.y_train = fn(self.x_train), fn(self.y_train)
        return self

    def _std(self, params):
        "σ as a 0-d tensor (a prior's value, or the fixed number)"
        if isinstance(self.noise_std, Prior):
            return self.noise_std.forward(params, "noise_std")
        return torch.tensor(self.noise_std, dtype=self.y_train.dtype,
                            device=self.y_train.device)

    def log_likelihood(self, params, x, y, eff_num_data, train=False,
                       mask=None, compute_dtype=None, buffers=None):
        """(marginal log-likelihood of the training set, its features
        f (N, F)); `x`, `y`, `eff_num_data`, `mask` and `compute_dtype`
        are accepted and ignored (the f64 Woodbury form is delicate), as in
        the JAX package (raob.py:51-72)"""
        assert buffers is None, "RaoB models run one chain"
        f = self.net_apply(params, self.x_train, train)
        y_tr = self.y_train.to(f.dtype)
        N, D = y_tr.shape
        n_feat = f.shape[-1]
        sig = (self._std(params) ** 2).double()
        llv = self.last_layer_std ** 2
        constants = (N * math.log(2 * math.pi) + (N - n_feat) * torch.log(sig)
                     + (y_tr * y_tr).sum().double() / (D * sig))
        ff = ((f.T @ f) * llv).double()
        L = torch.linalg.cholesky(
            ff + sig * torch.eye(n_feat, dtype=ff.dtype, device=ff.device))
        logdet = 2 * torch.log(torch.diagonal(L)).sum()
        lfy = _solve_lower(L, (f.T @ y_tr).double())
        quad = (lfy * lfy).sum() * (llv / (D * sig))
        ll = (-D / 2) * (constants + logdet - quad)
        return ll.to(f.dtype), f

    def _posterior_w(self, params=None):
        """mean and lower-triangular precision Cholesky of the whitened
        p(w | X, y) (raob.py:74-83), in float64"""
        f = self.net_apply(params, self.x_train) * self.last_layer_std
        sig = (self._std(params) ** 2).double()
        f = f.double()
        A = (f.T @ f) / sig + torch.eye(f.shape[-1], dtype=f.dtype,
                                        device=f.device)
        L = torch.linalg.cholesky(A)
        white_mean = _solve_lower(L, f.T @ self.y_train.double())
        return white_mean / sig, L

    def posterior_w(self, params=None):
        """mean (F, 1) and root L of the covariance (Cov = Lᵀ L) of
        p(w | X, y), in float64 (raob.py:85-92)"""
        white_mean, L_w = self._posterior_w(params)
        mean = torch.linalg.solve_triangular(L_w.T, white_mean, upper=True)
        eye = torch.eye(L_w.shape[-1], dtype=L_w.dtype, device=L_w.device)
        return mean, _solve_lower(L_w, eye)

    def predictive(self, params, x):
        """p(y* | x*, X, y): mean (M, 1) and std (M, 1) at new inputs, in
        the features' dtype (raob.py:94-103)"""
        white_mean, L_w = self._posterior_w(params)
        f = self.net_apply(params, x) * self.last_layer_std
        lf = _solve_lower(L_w, f.T.double())
        mean = lf.T @ white_mean
        var = (lf * lf).sum(0) + self._std(params).double() ** 2
        return mean.to(f.dtype), var.sqrt().to(f.dtype)[:, None]


def RaoBDenseNet(x_train, y_train, width, noise_std=1.0,
                 prior_w=prior.Normal, loc_w=0.0, std_w=2 ** 0.5,
                 prior_b=prior.Normal, loc_b=0.0, std_b=1.0, scaling_fn=None):
    "two ReLU layers of `width`, the last layer integrated out (:105-116)"
    in_features = x_train.shape[-1]
    kw = dict(prior_w=prior_w, loc_w=loc_w, std_w=std_w, prior_b=prior_b,
              loc_b=loc_b, std_b=std_b, scaling_fn=scaling_fn)
    return RaoBRegressionModel(
        x_train, y_train, noise_std, last_layer_std=(2 / width) ** 0.5,
        net=Sequential(
            LinearPrior(in_features, width, **kw), ReLU(),
            LinearPrior(width, width, **kw), ReLU()))


def RaoBLinearRegression(x_train, y_train, noise_std=1.0, std_w=2 ** 0.5):
    "Bayesian linear regression on the inputs themselves (:118-123)"
    in_features = x_train.shape[-1]
    return RaoBRegressionModel(
        x_train, y_train, noise_std,
        last_layer_std=std_w * in_features ** -0.5, net=Identity())
