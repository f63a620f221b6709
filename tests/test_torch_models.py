"""The port's ResNet, priors, data and experiment glue against the JAX
package's, with JAX-initialised weights carried over by name
(`bnn_priors_tpu_torch.interop.load_jax_state`).

A note on batchnorm. The JAX BatchNorm2d takes its batch statistics in f32
even for f64 input (`bnn_priors_tpu/models/layers.py:208-218`), and XLA's
f32 reductions round differently from any other order, which caps the
agreement of an f64 forward pass at about 1e-6. The port takes the
statistics in the input dtype when that is f64 (f32 otherwise, as JAX), so
for the algorithmic comparisons at rtol 1e-9 the JAX reference is built
with `F64StatsBatchNorm` below: the JAX layer's own arithmetic with the
statistics left in f64. `test_f64_potential_against_unmodified_jax_bn`
holds the port against the unmodified JAX layer at the tolerance that f32
statistics allow.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.mcmc.packing import Packer as JaxPacker
from bnn_priors_tpu.models import google_resnet as jax_gr
from bnn_priors_tpu.models import layers as jax_layers
from bnn_priors_tpu_torch import exp_utils, models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.interop import load_jax_state
from bnn_priors_tpu_torch.mcmc.packing import Packer

N_EFF = 1000.0


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    """One torch thread per pytest-xdist worker (restored after the module).
    torch's intra-op threads meet at a barrier after every op; with several
    workers sharing the cores, each of these tests' many small ops waits
    for threads that are descheduled, which made the port's tests up to
    60x slower in a 6-worker run on 4 cores. Every port test module imports
    this fixture; it is autouse there."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class F64StatsBatchNorm(jax_layers.BatchNorm2d):
    """JAX BatchNorm2d, train branch copied from layers.py:202-232 with the
    batch statistics kept in the input dtype instead of cast to f32."""

    def apply(self, params, state, prefix, x, train=False):
        if not train:
            return super().apply(params, state, prefix, x, train)
        join = jax_layers.join
        rm, rv, nb = (join(prefix, k) for k in
                      ("running_mean", "running_var", "num_batches_tracked"))
        axes = (0, 1, 2)
        mean = jnp.mean(x, axis=axes)
        var = jnp.maximum(jnp.mean(x * x, axis=axes) - mean * mean, 0.0)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        m = self.momentum
        state = dict(state)
        state[rm] = (1 - m) * state[rm] + m * mean
        state[rv] = (1 - m) * state[rv] + m * var * (n / max(n - 1, 1))
        state[nb] = state[nb] + 1
        y = (x - mean) * lax.rsqrt(var + self.eps)
        y = y * params[join(prefix, "weight")] + params[join(prefix, "bias")]
        return y, state


def _jax_resnet(depth, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(jax_gr, "BatchNorm2d", F64StatsBatchNorm)
    model = jax_gr.ResNet(depth=depth)
    if monkeypatch is not None:
        monkeypatch.undo()
    return model


@functools.lru_cache(maxsize=None)
def _jax_init_np(depth, jdt, seed):
    params, state = _jax_resnet(depth).init(jax.random.key(seed), dtype=jdt)
    params = jax_exp.he_initialize(params, jax.random.key(seed + 1))
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in state.items()})


def _jax_init(depth, jdt, seed=0):
    """JAX init + He init (the same for either batchnorm variant), as fresh
    JAX arrays: a runner may donate them"""
    params, state = _jax_init_np(depth, jdt, seed)
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in state.items()})


def _pair(depth, dtype, monkeypatch=None):
    "JAX model + its init, and the port model with those weights loaded"
    jm = _jax_resnet(depth, monkeypatch)
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    params, state = _jax_init(depth, jdt)
    tm = models.ResNet(depth=depth).to(dtype)
    load_jax_state(tm, *_jax_init_np(depth, jdt, 0))
    return jm, params, state, tm


def _batch(n=16, dtype=np.float64, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3, 32, 32).astype(dtype), rng.randint(0, 10, n)


def _jax_potential_and_grad(jm, params, state, x, y, **kw):
    def fn(p):
        return jm.potential_avg(p, state, jnp.asarray(x), jnp.asarray(y),
                                N_EFF, train=True, **kw)
    (pot, new_state), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params)
    return float(pot), new_state, np.asarray(JaxPacker(params).pack(g))


def _port_potential_and_grad(tm, x, y, **kw):
    pk = Packer(tm.params())
    theta = pk.pack({k: v.detach() for k, v in tm.params().items()})
    theta.requires_grad_()
    pot = tm.potential_avg(pk.unpack(theta), torch.as_tensor(x),
                           torch.as_tensor(y), N_EFF, train=True, **kw)
    g, = torch.autograd.grad(pot, theta)
    return float(pot.detach()), g.numpy()


def test_resnet8_layout_and_carry_over():
    jm, params, state, tm = _pair(8, torch.float64)
    sd = tm.state_dict()
    assert set(sd) == set(params) | set(state)
    assert len(params) == 29 and sum(v.size for v in params.values()) == 78042
    assert sorted(dict(tm.named_parameters())) == sorted(params)
    assert sorted(dict(tm.named_buffers())) == sorted(state)
    for k, v in {**params, **state}.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v))
    assert sd["net.1.num_batches_tracked"].dtype == torch.int64
    with pytest.raises(KeyError):
        load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()}, {})


def test_f64_prior_potential_gradient_and_bn_state(monkeypatch):
    jm, params, state, tm = _pair(8, torch.float64, monkeypatch)
    x, y = _batch()
    np.testing.assert_allclose(float(tm.log_prior().detach()),
                               float(jm.log_prior(params)), rtol=1e-12)
    jpot, jstate, jg = _jax_potential_and_grad(jm, params, state, x, y)
    tpot, tg = _port_potential_and_grad(tm, x, y)
    np.testing.assert_allclose(tpot, jpot, rtol=1e-9)
    # entries that cancel to ~0 have no meaningful relative error
    np.testing.assert_allclose(tg, jg, rtol=1e-9,
                               atol=1e-9 * np.abs(jg).max())
    np.testing.assert_array_equal(tg[Packer(tm.params()).total:], 0.0)
    # the train-mode pass updated the running statistics in place
    for k, v in tm.named_buffers():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]),
                                   rtol=1e-9, atol=1e-12)
    assert int(tm.state_dict()["net.1.num_batches_tracked"]) == 1


def test_f64_eval_logits(monkeypatch):
    jm, params, state, tm = _pair(8, torch.float64, monkeypatch)
    x, _ = _batch(seed=2)
    # running statistics that differ from the init values
    rng = np.random.RandomState(3)
    state = {k: (v if "num_batches" in k else
                 jnp.asarray(np.abs(rng.randn(*v.shape)) + 0.5))
             for k, v in state.items()}
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in state.items()})
    jf, _ = jm.net_apply(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        tf = tm.net_apply(None, torch.as_tensor(x), train=False)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9,
                               atol=1e-12)


def test_f64_masked_potential_matches_jax():
    "potential with a padding mask: masked rows count for nothing"
    jm, params, state, tm = _pair(8, torch.float64)
    x, y = _batch(n=12, seed=4)
    mask = np.r_[np.ones(9), np.zeros(3)]
    jpot, _ = jm.potential(params, state, jnp.asarray(x), jnp.asarray(y),
                           N_EFF, train=False, mask=jnp.asarray(mask))
    X, Y = torch.as_tensor(x), torch.as_tensor(y)
    with torch.no_grad():
        tpot = tm.potential(tm.params(), X, Y, N_EFF, train=False,
                            mask=torch.as_tensor(mask))
        head = tm.potential(tm.params(), X[:9], Y[:9], N_EFF, train=False)
    np.testing.assert_allclose(float(tpot), float(jpot), rtol=1e-9)
    np.testing.assert_allclose(float(tpot), float(head), rtol=1e-12)


def test_f64_potential_against_unmodified_jax_bn():
    """the unmodified JAX layer: its f32 batch statistics bound the
    agreement (measured: potential 1.8e-9 relative, gradient 1.1e-6 of its
    largest entry; the limits leave a 50-100x margin)"""
    jm, params, state, tm = _pair(8, torch.float64)
    x, y = _batch()
    jpot, _, jg = _jax_potential_and_grad(jm, params, state, x, y)
    tpot, tg = _port_potential_and_grad(tm, x, y)
    np.testing.assert_allclose(tpot, jpot, rtol=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-4 * np.abs(jg).max())


def test_bf16_compute_potential_matches_jax():
    """compute_dtype=bfloat16 against JAX's bf16 path; the frameworks round
    bf16 at different places, hence 5e-2."""
    jm, params, state, tm = _pair(8, torch.float32)
    x, y = _batch(dtype=np.float32)
    jpot, _, jg = _jax_potential_and_grad(jm, params, state, x, y,
                                          compute_dtype=jnp.bfloat16)
    tpot, tg = _port_potential_and_grad(tm, x, y,
                                        compute_dtype=torch.bfloat16)
    f32pot, _ = _port_potential_and_grad(tm, x, y)
    np.testing.assert_allclose(tpot, jpot, rtol=5e-2)
    assert tpot != f32pot  # the network really ran in bf16
    assert np.all(np.isfinite(tg))
    for k, v in tm.named_buffers():
        assert v.dtype == (torch.int64 if "num_batches" in k
                           else torch.float32)


def test_get_model_googleresnet_matches_jax_layout():
    data = JaxFakeCIFAR10(n_train=16, n_test=4)
    jm = jax_exp.get_model(data.norm.train_X, data.norm.train_y,
                           "googleresnet", 0, 20, "gaussian", 0.0, 2 ** 0.5,
                           "gaussian", 0.0, 1.0, True, {}, {})
    params, state = jm.init(jax.random.key(0), dtype=jnp.float32)
    tm = exp_utils.get_model("googleresnet", weight_prior="gaussian",
                             weight_scale=2 ** 0.5, device="cpu")
    pk, jpk = Packer(tm.params()), JaxPacker(params)
    assert pk.names == jpk.names and pk.shapes == jpk.shapes
    assert (pk.n_leaves, pk.total, pk.total_padded) == (65, 272474, 273408)
    assert sorted(dict(tm.named_buffers())) == sorted(state)
    assert next(tm.parameters()).device.type == "cpu"
    # the priors' scales: std_w / sqrt(in_channels) for convs and the dense
    # layer, std_b for its bias
    for name, prior in tm.named_priors():
        jprior = dict(jm.named_priors())[name]
        assert prior.hypers == {k: float(v) for k, v in
                                jprior.hypers.items()}


def test_he_initialize_statistics():
    tm = exp_utils.get_model("googleresnet", device="cpu")
    exp_utils.he_initialize(tm, torch.Generator().manual_seed(0))
    for name, p in tm.state_dict().items():
        if "weight_prior.p" in name and p.numel() > 5000:
            fan_in = p[0].numel()
            assert abs(float(p.std()) * fan_in ** 0.5 / 2 ** 0.5 - 1) < 0.05
        elif "bias_prior.p" in name:
            assert float(p.abs().max()) <= 1 / p.shape[0] ** 0.5


def test_fake_cifar10_matches_jax_exactly():
    jd = JaxFakeCIFAR10(n_train=64, n_test=16)
    td = FakeCIFAR10(n_train=64, n_test=16, device="cpu")
    for (tx, ty), (jx, jy) in ((td.norm.train, jd.norm.train),
                               (td.norm.test, jd.norm.test),
                               (td.unnorm.train, jd.unnorm.train)):
        assert tx.dtype == torch.float32 and ty.dtype == torch.int64
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    data = exp_utils.get_data("fake_cifar10", n_train=64, n_test=16,
                              device="cpu")
    np.testing.assert_array_equal(data.norm.train_X.numpy(),
                                  np.asarray(jd.norm.train_X))
    with pytest.raises(NotImplementedError):
        exp_utils.get_data("cifar10", device="cpu")


def test_entry_points_default_to_the_card():
    "no CUDA here: the default device raises instead of running on the CPU"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        exp_utils.get_model("googleresnet")
    with pytest.raises(RuntimeError, match="CUDA"):
        exp_utils.get_data("fake_cifar10", n_train=8, n_test=2)
