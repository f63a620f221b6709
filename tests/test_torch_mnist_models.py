"""The MNIST-family and regression models of the port against the JAX
package's: the CNN (`classificationconvnet`), the correlated CNN, the FCNN
(`classificationdensenet`), `densenet` with its sampled `noise_std`,
`linear` and `logistic`, built by both registries from the same data.

Parameters are the port's draws carried to JAX by name (the names are the
JAX package's, which the first test checks at full width). Comparisons are
in f64 at rtol 1e-9: forward pass, log-likelihood, log prior and the
potential's gradient; the conv nets' flatten order (JAX reads NHWC
activations); the K-chain fold against K single forwards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu_torch import exp_utils, models
from bnn_priors_tpu_torch.models import layers

from test_torch_models import torch_threads_per_worker  # noqa: F401

N, D_IMG = 20, 64            # 8x8 single-channel images, as flat rows
RTOL, ATOL = 1e-9, 1e-12
CLASSIFIERS = ("classificationconvnet", "correlatedclassificationconvnet",
               "classificationdensenet", "logistic")
REGRESSORS = ("densenet", "linear")


def _data(name, n=N, d=D_IMG, seed=0):
    "(x, y) from a numpy seed: labels 0-9 or (n, 1) regression targets"
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d)
    if name in REGRESSORS:
        return x, rng.randn(n, 1)
    y = rng.randint(0, 10, n)
    y[0] = 9
    return x, y


def _pair(name, x, y, width=4, depth=3, weight_prior="gaussian",
          weight_prior_params=None, seed=0):
    """(JAX model, port model in f64, its params as numpy) from the two
    registries with the same arguments"""
    wpp = dict(weight_prior_params or {})
    jm = jax_exp.get_model(jnp.asarray(x), jnp.asarray(y), name, width, depth,
                           weight_prior, 0.0, 2 ** 0.5, "gaussian", 0.0, 1.0,
                           True, wpp, {})
    tm = exp_utils.get_model(name, weight_prior=weight_prior,
                             weight_prior_params=wpp,
                             x_train=torch.as_tensor(x),
                             y_train=torch.as_tensor(y), width=width,
                             depth=depth, device="cpu", dtype=torch.float64,
                             seed=seed)
    params = {k: v.detach().numpy().copy() for k, v in tm.params().items()}
    return jm, tm, params


def _jax_shapes(jm):
    params, state = jax.eval_shape(lambda k: jm.init(k, dtype=jnp.float32),
                                   jax.random.key(0))
    return {k: tuple(v.shape) for k, v in {**params, **state}.items()}


@pytest.mark.parametrize("name,x_shape,y,count", [
    ("classificationconvnet", (2, 784), np.array([0, 9]), 47560),
    ("correlatedclassificationconvnet", (2, 784), np.array([0, 9]), 47560),
    ("classificationdensenet", (2, 784), np.array([0, 9]), 42310),
    ("densenet", (2, 13), np.zeros((2, 1)), 3302)])
def test_full_width_names_and_counts(name, x_shape, y, count):
    """width 50, depth 3 at MNIST's 784 features and UCI_boston's 13: the
    JAX init's leaf names and shapes, and its parameter count"""
    x = np.zeros(x_shape)
    jm = jax_exp.get_model(jnp.asarray(x), jnp.asarray(y), name, 50, 3,
                           "gaussian", 0.0, 2 ** 0.5, "gaussian", 0.0, 1.0,
                           True, {}, {})
    tm = exp_utils.get_model(name, x_train=torch.as_tensor(x),
                             y_train=torch.as_tensor(y), device="cpu")
    ours = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ours == _jax_shapes(jm)
    assert sum(v.numel() for v in tm.parameters()) == count
    if name == "densenet":
        assert ours["noise_std.p"] == ()


@pytest.mark.parametrize("name", CLASSIFIERS + REGRESSORS)
def test_forward_likelihood_prior_and_gradient_match_jax(name):
    x, y = _data(name)
    jm, tm, params = _pair(name, x, y)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jll, _, jf = jm.log_likelihood(jp, {}, jx, jy, 100.0)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tll, tf = tm.log_likelihood(tp, tx, ty, 100.0)
    close = lambda a, b, what: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)
    close(tf.detach().numpy(), jf, "f")
    close(float(tll.detach()), float(jll), "log_likelihood")
    close(float(tm.log_prior(tp).detach()), float(jm.log_prior(jp)),
          "log_prior")
    close(tm.likelihood_log_prob(tf, ty, tp).detach().numpy(),
          jm.likelihood_log_prob(jp, jf, jy), "per-point log-likelihood")
    close(tm.acc_fn(tf, ty).detach().numpy(), jm.acc_fn(jf, jy, jp), "acc")
    jg = jax.grad(lambda p: jm.potential(p, {}, jx, jy, 100.0)[0])(jp)
    pot = tm.potential(tp, tx, ty, 100.0)
    tg = dict(zip(tp, torch.autograd.grad(pot, list(tp.values()))))
    assert set(tg) == set(jg)
    for k in jg:
        close(tg[k].numpy(), jg[k], "grad " + k)


def test_dense_layer_reads_hwc_order(monkeypatch):
    """the CNN's dense layer reads its input in JAX's (h, w, c) order: with
    a (c, h, w) flatten in its place the same weights give another
    function"""
    x, y = _data("classificationconvnet")
    jm, tm, params = _pair("classificationconvnet", x, y)
    _, _, jf = jm.log_likelihood({k: jnp.asarray(v) for k, v in
                                  params.items()}, {}, jnp.asarray(x),
                                 jnp.asarray(y), 1.0)
    f = tm.net_apply(None, torch.as_tensor(x))
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf),
                               rtol=RTOL, atol=ATOL)
    assert isinstance(tm.net[7], layers.FlattenHWC)
    monkeypatch.setattr(layers.FlattenHWC, "forward",
                        lambda self, a: a.reshape(a.shape[0], -1))
    f_chw = tm.net_apply(None, torch.as_tensor(x))
    assert np.abs(f_chw.detach().numpy() - np.asarray(jf)).max() > 1e-3


@pytest.mark.parametrize("name", ("classificationconvnet",
                                  "classificationdensenet", "densenet"))
def test_chain_fold_equals_single_forwards(name):
    """K=3 chains in one folded pass (own params and minibatch a chain,
    `noise_std` (K,) for densenet) equal three single-chain passes"""
    K = 3
    x, y = _data(name, n=3 * N)
    tm = _pair(name, x[:N], y[:N])[1]
    per_chain = []
    for c in range(K):
        tm.init(torch.Generator().manual_seed(c))
        per_chain.append({k: v.detach().clone()
                          for k, v in tm.params().items()})
    bank = {k: torch.stack([p[k] for p in per_chain]) for k in per_chain[0]}
    xk = torch.as_tensor(x).reshape(K, N, -1)
    yk = torch.as_tensor(y).reshape(K, N, *y.shape[1:])
    ll, f = tm.log_likelihood(bank, xk, yk, 50.0, buffers={})
    assert ll.shape == (K,) and f.shape[:2] == (K, N)
    lp = tm.log_prior(bank)
    for c in range(K):
        llc, fc = tm.log_likelihood(per_chain[c], xk[c], yk[c], 50.0)
        np.testing.assert_allclose(f[c].detach().numpy(),
                                   fc.detach().numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(ll[c]), float(llc), rtol=RTOL)
        np.testing.assert_allclose(float(lp[c]),
                                   float(tm.log_prior(per_chain[c])),
                                   rtol=RTOL)


def test_correlated_cnn_lengthscales():
    """`lengthscale_1` reaches the first convolution's prior, `lengthscale_2`
    the second's, and the log prior is JAX's"""
    x, y = _data("correlatedclassificationconvnet")
    wpp = {"lengthscale_1": 0.7, "lengthscale_2": 2.5}
    jm, tm, params = _pair("correlatedclassificationconvnet", x, y,
                           weight_prior="convcorrnormal",
                           weight_prior_params=wpp)
    assert tm.net[1].weight_prior.hypers["lengthscale"] == 0.7
    assert tm.net[4].weight_prior.hypers["lengthscale"] == 2.5
    assert "lengthscale" not in tm.net[8].weight_prior.hypers
    jlp = float(jm.log_prior({k: jnp.asarray(v) for k, v in params.items()}))
    np.testing.assert_allclose(float(tm.log_prior().detach()), jlp,
                               rtol=RTOL)


def test_lengthscale_on_the_correlated_cnn_raises_in_both():
    """run_experiment.sh's convcorrnormal rows on MODEL=classificationconvnet
    run `correlatedclassificationconvnet` with a plain `lengthscale`, which
    goes to the dense layer's Normal: TypeError in both packages"""
    name = "correlatedclassificationconvnet"
    x, y = _data(name)
    with pytest.raises(TypeError, match="lengthscale"):
        _pair(name, x, y, weight_prior="convcorrnormal",
              weight_prior_params={"lengthscale": 1.0})
    with pytest.raises(TypeError, match="lengthscale"):
        jax_exp.get_model(jnp.asarray(x), jnp.asarray(y), name, 4, 3,
                          "convcorrnormal", 0.0, 2 ** 0.5, "gaussian", 0.0,
                          1.0, True, {"lengthscale": 1.0}, {})


def test_lengthscale_on_the_plain_cnn_reaches_every_layer():
    """on `classificationconvnet` every layer, the dense one too, takes the
    correlated prior and its `lengthscale`, in both packages"""
    x, y = _data("classificationconvnet")
    jm, tm, params = _pair("classificationconvnet", x, y,
                           weight_prior="convcorrnormal",
                           weight_prior_params={"lengthscale": 1.5})
    for i in (1, 4, 8):
        assert tm.net[i].weight_prior.hypers["lengthscale"] == 1.5
    jlp = float(jm.log_prior({k: jnp.asarray(v) for k, v in params.items()}))
    np.testing.assert_allclose(float(tm.log_prior().detach()), jlp,
                               rtol=RTOL)


@pytest.mark.parametrize("name", ("resnet18", "thin_resnet18", "resnet34",
                                  "raobdensenet", "datadriven_resnet18"))
def test_unported_models_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        exp_utils.get_model(name, x_train=torch.zeros(2, 784),
                            y_train=torch.zeros(2), device="cpu")


def test_data_shaped_models_need_the_data():
    with pytest.raises(ValueError, match="x_train"):
        exp_utils.get_model("classificationconvnet", device="cpu")


def test_max_pool_and_image_input_on_the_fold():
    """the image input folds (B, K·784) into (B, K, 28, 28); max pooling
    keeps the chains' channels apart"""
    x = torch.randn(2, 3 * 784, dtype=torch.float64)
    img = layers.ImageInput(1, 28)(x)
    assert img.shape == (2, 3, 28, 28)
    torch.testing.assert_close(img[:, 1], x[:, 784:1568].reshape(2, 28, 28))
    pooled = layers.MaxPool2d(2)(img)
    assert pooled.shape == (2, 3, 14, 14)
    torch.testing.assert_close(pooled[:, 2:3],
                               layers.MaxPool2d(2)(img[:, 2:3]))
    assert isinstance(models.ClassificationConvNet(1, 28, 10, 5).net[0],
                      layers.ImageInput)
