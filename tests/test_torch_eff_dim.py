"""The port's Hessian-spectrum toolkit (`bnn_priors_tpu_torch.eff_dim`)
against the JAX package's (`bnn_priors_tpu.eff_dim`) on the same numpy
inputs, in float64 on the CPU: Hessian-vector products on a quadratic, a
small MLP and a narrow ResNet-8 (weights carried across by
`interop.load_jax_state`), the dense Hessian, the Lanczos Ritz values and
the effective dimension.

The port's Lanczos start vector comes from a `torch.Generator`, JAX's from
a key, so the two agree on eigenvalues, not on Ritz vectors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import eff_dim as jax_eff_dim
from bnn_priors_tpu.mcmc.packing import Packer as JaxPacker
from bnn_priors_tpu_torch import eff_dim
from bnn_priors_tpu_torch.mcmc.packing import Packer
from test_torch_models import (N_EFF, _batch, _pair,  # noqa: F401
                               torch_threads_per_worker)

MLP_SHAPES = {"w1": (6, 8), "b1": (8,), "w2": (8, 1)}


def _quadratic(dim=24, seed=0):
    "A (PSD), θ and a direction, numpy f64"
    rng = np.random.RandomState(seed)
    B = rng.randn(dim, dim)
    A = B @ B.T / dim + 0.1 * np.eye(dim)
    return A, rng.randn(dim), rng.randn(dim)


def _mlp(seed=5):
    "params, a direction and the data of a small tanh MLP, numpy f64"
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s) * 0.5 for k, s in MLP_SHAPES.items()}
    params["b1"] = np.zeros(8)
    vec = {k: rng.randn(*s) for k, s in MLP_SHAPES.items()}
    X = rng.randn(32, 6)
    y = np.sin(X.sum(1, keepdims=True))
    return params, vec, X, y


def _mlp_loss(np_mod, X, y):
    "mean squared error of the MLP, for jnp (np_mod=jnp) or torch"
    def loss(p):
        h = np_mod.tanh(X @ p["w1"] + p["b1"])
        return ((h @ p["w2"] - y) ** 2).mean()
    return loss


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def mlp_jax():
    """the JAX package's dense Hessian, its eigenvalues and its Lanczos
    Ritz values of the MLP (num_iters = n + 64), shared by the cases"""
    params, _, X, y = _mlp()
    loss = _mlp_loss(jnp, jnp.asarray(X), jnp.asarray(y))
    H = np.asarray(jax_eff_dim.hessian(loss, _jax(params)))
    evals, _, _ = jax_eff_dim.hessian_eigs_positive_lanczos(
        loss, _jax(params), key=jax.random.key(6),
        num_iters=H.shape[0] + 64)
    return H, np.sort(np.linalg.eigvalsh(H)), np.sort(np.asarray(evals))


def test_hess_vec_prod_quadratic():
    A, w, v = _quadratic()
    jhv = jax_eff_dim.hess_vec_prod(
        lambda p: 0.5 * p["w"] @ jnp.asarray(A) @ p["w"], {"w": jnp.asarray(w)},
        {"w": jnp.asarray(v)})["w"]
    At = torch.as_tensor(A)
    thv = eff_dim.hess_vec_prod(lambda p: 0.5 * p["w"] @ At @ p["w"],
                                {"w": torch.as_tensor(w)},
                                {"w": torch.as_tensor(v)})["w"]
    np.testing.assert_allclose(thv.numpy(), np.asarray(jhv), rtol=1e-10)
    np.testing.assert_allclose(thv.numpy(), A @ v, rtol=1e-10)


def test_hess_vec_prod_mlp():
    params, vec, X, y = _mlp()
    jhv = jax_eff_dim.hess_vec_prod(
        _mlp_loss(jnp, jnp.asarray(X), jnp.asarray(y)), _jax(params),
        _jax(vec))
    thv = eff_dim.hess_vec_prod(
        _mlp_loss(torch, torch.as_tensor(X), torch.as_tensor(y)),
        _torch(params), _torch(vec))
    assert sorted(thv) == sorted(MLP_SHAPES)
    for k in MLP_SHAPES:
        np.testing.assert_allclose(thv[k].numpy(), np.asarray(jhv[k]),
                                   rtol=1e-10, atol=1e-14)


def test_hess_vec_prod_resnet8_eval():
    """googleresnet's ResNet-8 potential at train=False (running
    statistics, no batch statistics): H·v of the port against JAX's over
    the packed vector. Entries that cancel to ~0 have no meaningful
    relative error, hence the atol of 1e-8 of the largest entry."""
    jm, params, state, tm = _pair(8, torch.float64)
    x, y = _batch(n=8, seed=7)
    rng = np.random.RandomState(8)
    pk = Packer(tm.params())
    v = rng.randn(pk.total_padded)
    v[pk.total:] = 0.0
    jpk = JaxPacker(params)
    X, Y = jnp.asarray(x), jnp.asarray(y)
    jloss = lambda p: jm.potential(p, state, X, Y, N_EFF, train=False)[0]
    jhv = jax.jit(lambda p, u: jax_eff_dim.hess_vec_prod(jloss, p, u))(
        params, jpk.unpack(jnp.asarray(v)))
    jhv = np.asarray(jpk.pack(jhv))
    Xt, Yt = torch.as_tensor(x), torch.as_tensor(y)
    tloss = lambda p: tm.potential(p, Xt, Yt, N_EFF, train=False)
    thv = eff_dim.hess_vec_prod(tloss, tm.params(),
                                pk.unpack(torch.as_tensor(v)))
    thv = pk.pack(thv).numpy()
    assert np.all(np.isfinite(thv)) and np.abs(jhv).max() > 0
    np.testing.assert_allclose(thv, jhv, rtol=1e-8,
                               atol=1e-8 * np.abs(jhv).max())


def test_dense_hessian(mlp_jax):
    A, w, _ = _quadratic()
    At = torch.as_tensor(A)
    H = eff_dim.hessian(lambda p: 0.5 * p["w"] @ At @ p["w"],
                        {"w": torch.as_tensor(w)})
    np.testing.assert_allclose(H.numpy(), A, rtol=1e-10)
    params, _, X, y = _mlp()
    H = eff_dim.hessian(
        _mlp_loss(torch, torch.as_tensor(X), torch.as_tensor(y)),
        _torch(params)).numpy()
    n = sum(int(np.prod(s)) for s in MLP_SHAPES.values())
    assert H.shape == (n, n)
    np.testing.assert_allclose(H, mlp_jax[0], rtol=1e-10, atol=1e-14)


def test_unflatten_like():
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": np.arange(4.0),
            "c": np.arange(3.0)}
    flat = np.arange(13.0) + 0.5
    jout = jax_eff_dim.unflatten_like(jnp.asarray(flat), _jax(tree))
    tout = eff_dim.unflatten_like(torch.as_tensor(flat), _torch(tree))
    assert sorted(tout) == sorted(tree)
    for k in tree:
        assert tout[k].shape == tree[k].shape
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    # a packed vector round-trips
    pk = Packer(_torch(tree))
    back = eff_dim.unflatten_like(pk.pack(_torch(tree)), _torch(tree))
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_dataset_loss():
    params, _, X, y = _mlp()
    batches = [(X[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]

    def model_loss(np_mod, conv):
        return lambda p, xb, yb: _mlp_loss(np_mod, conv(xb), conv(yb))(p)
    jl = jax_eff_dim.dataset_loss(model_loss(jnp, jnp.asarray),
                                  batches)(_jax(params))
    tl = eff_dim.dataset_loss(model_loss(torch, torch.as_tensor),
                              iter(batches))(_torch(params))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-12)


def test_symeig_positive_lanczos_full_rank():
    "a full-rank run reproduces every eigenvalue of a PSD matrix"
    A, _, _ = _quadratic(dim=16, seed=3)
    jev, _, _ = jax_eff_dim.symeig_positive_lanczos(
        jnp.asarray(A), num_iters=16, key=jax.random.key(4))
    At = torch.as_tensor(A)
    evals, vecs, pos = eff_dim.symeig_positive_lanczos(
        At, num_iters=16, generator=torch.Generator().manual_seed(4))
    assert evals.shape == (16,) and vecs.shape == (16, 16)
    assert pos.dtype == torch.bool and bool(pos.all())
    ev = np.sort(evals.numpy())
    np.testing.assert_allclose(ev, np.sort(np.asarray(jev)), rtol=1e-6)
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(A), rtol=1e-6)
    # Ritz vectors diagonalise A
    for i in range(16):
        q = vecs[:, i]
        np.testing.assert_allclose((At @ q).numpy(),
                                   float(evals[i]) * q.numpy(), atol=1e-6)


def test_hessian_eigs_positive_lanczos_mlp(mlp_jax):
    "matrix-free Ritz values against JAX's and the dense Hessian's"
    H, dense, jev = mlp_jax
    params, _, X, y = _mlp()
    n = H.shape[0]
    evals, vecs, pos = eff_dim.hessian_eigs_positive_lanczos(
        _mlp_loss(torch, torch.as_tensor(X), torch.as_tensor(y)),
        _torch(params), generator=torch.Generator().manual_seed(6),
        num_iters=n + 64)
    assert evals.shape == (n + 64,) and vecs.shape == (1024, n + 64)
    np.testing.assert_array_equal(pos.numpy(), evals.numpy() > 1e-8)
    top = np.sort(evals.numpy())[-5:]
    np.testing.assert_allclose(top, jev[-5:], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(top, dense[-5:], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("z", [0.1, 1.0, 10.0])
def test_effective_dimension(z):
    lam = np.asarray([10.0, 1.0, 0.1, 0.0, -0.5])
    j = float(jax_eff_dim.effective_dimension(jnp.asarray(lam), z))
    t = float(eff_dim.effective_dimension(torch.as_tensor(lam), z))
    assert t == j
    pos = lam[lam > 0]
    np.testing.assert_allclose(t, np.sum(pos / (pos + z)), rtol=1e-15)
