"""The split, f16-result and float64 matmul precisions of the port
(`bnn_priors_tpu_torch/precision.py`, `models/layers.py`,
`ops/split_operand.py`) against emulations of their arithmetic and
against JAX's CPU backend.

The emulation (numpy and JAX at float64) takes the same operands and
cuts them into the same parts (ml_dtypes' round to nearest even, float32
residuals), sums the mode's pairs of part products in float64, and
rounds where the mode rounds (an f16 result, a float32 result from
float64). The port's products accumulate in float32, so the tolerance is
float32's accumulation-order noise, 1e-6 of the product of the operands'
magnitudes, plus one rounding of the result where the mode has one.
JAX's CPU backend computes `BF16_BF16_F32_X3` and `_X6` as float32
products: the port's are held to it within each algorithm's truncation,
3·2^-16 (X3) and 3·2^-24 (X6) of the magnitudes.
"""
import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bnn_priors_tpu_torch import precision
from bnn_priors_tpu_torch.ops import split_operand as so

from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_precision import _case, _port

U_F32 = 2.0 ** -24
U_PART = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
NP_PART = {torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16}
ACC = 1e-6  # float32 accumulation-order noise, of the magnitudes
# the dropped pairs' share of the magnitudes: X3 drops lo·lo, hi·lo₂ and
# lo₂·hi (each ≤ 2^-16), X6 lo·lo₂, lo₂·lo and lo₂·lo₂ (each ≤ 2^-24)
TRUNCATION = {"BF16_BF16_F32_X3": 3 * 2.0 ** -16,
              "BF16_BF16_F32_X6": 3 * 2.0 ** -24}
NEW_VALUES = ("BF16_BF16_F32", "F16_F16_F32", "BF16_BF16_F32_X3",
              "BF16_BF16_F32_X6", "F16_F16_F16", "F64_F64_F64")


def np_parts(a, n, part_dtype):
    "the n parts of float32 `a`, each round to nearest of the residual"
    parts, res = [], a.astype(np.float32)
    for _ in range(n):
        p = res.astype(NP_PART[part_dtype]).astype(np.float32)
        parts.append(p)
        res = res - p
    return parts


# ------------------------------------------------------------ the split --
@pytest.mark.parametrize("part_dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_parts_are_exact_and_sum_to_x(n, part_dtype):
    """every part holds values of its type; n parts sum to x within
    u^n·|x| (u = 2^-8 in bf16, 2^-11 in f16, above its subnormals); the
    layout's blocks are the selected parts of each row; the CPU wrapper is
    the plain version and launches nothing"""
    rng = np.random.RandomState(n)
    x = (rng.randn(6, 40) * np.exp(rng.randn(6, 40) * 2)).astype(np.float32)
    xt = torch.tensor(x)
    before = so.launches
    parts = so.split_operand(xt, n, part_dtype)
    assert so.launches == before
    assert parts.shape == (1, n, x.size) and parts.dtype == torch.float32
    assert torch.equal(parts, so.split_operand_reference(xt, n, part_dtype))
    for k, p in enumerate(parts[0]):
        assert torch.equal(p, p.to(part_dtype).float()), k
        assert np.array_equal(p.numpy(), np_parts(x, n, part_dtype)[k]
                              .reshape(-1))
    err = np.abs(parts[0].double().sum(0).numpy() - x.reshape(-1))
    # f16's subnormals are spaced 2^-24 apart: a residual there rounds to
    # within 2^-25, whatever its size
    floor = 2.0 ** -25 * 1.001 if part_dtype == torch.float16 else 0.0
    assert np.all(err <= U_PART[part_dtype] ** n * np.abs(x.reshape(-1))
                  + floor)
    # rows and a selection: row r, block p = part select[p] of row r
    select = [min(n - 1, 1), 0, n - 1]
    lay = so.split_operand(xt, n, part_dtype, select, rows=3)
    assert lay.shape == (3, 3, 80)
    full = parts[0].reshape(n, 3, 80)
    for p, s in enumerate(select):
        assert torch.equal(lay[:, p], full[s])


def test_split_refuses_what_the_kernel_does_not_take():
    x = torch.ones(4, 6)
    with pytest.raises(TypeError, match="float32"):
        so.split_operand(x.double(), 2, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        so.split_operand(x, 2, torch.float32)
    with pytest.raises(ValueError, match="n = 4"):
        so.split_operand(x, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="select"):
        so.split_operand(x, 2, torch.bfloat16, [0, 2])
    with pytest.raises(ValueError, match="select"):
        so.split_operand(x, 2, torch.bfloat16, [0] * 7)
    with pytest.raises(ValueError, match="in 5 rows"):
        so.split_operand(x, 2, torch.bfloat16, rows=5)
    before = so.launches
    with pytest.raises(ValueError, match="no kernel"):
        so.split_operand(x.to("meta"), 2, torch.bfloat16)
    assert so.launches == before
    # an empty batch: no rows
    assert so.split_operand(torch.ones(0, 6), 2, torch.bfloat16, [0, 1, 0],
                            rows=0).shape == (0, 3, 0)


# ------------------------------------------------------------ the layers --
def _np_fn(kind, K):
    "the layer's product at float64 in JAX (HIGHEST), as numpy"
    from test_torch_precision import _conv, _linear
    if kind == "conv":
        f = lambda x, w: _conv(x, w, K, 2, 1, 2)
    else:
        f = lambda x, w: _linear(x, w, K)
    return f


def _emulate(kind, K, x, w, v, mode):
    """(out without bias, dgrad, wgrad) of the mode's arithmetic at
    float64, and the magnitudes (the same products of |x|, |w|, |v|)"""
    f = _np_fn(kind, K)
    j64 = lambda a: jnp.asarray(np.asarray(a, np.float64))
    prod = lambda a, b: np.asarray(f(j64(a), j64(b)))
    dgrad = lambda g, b: np.asarray(jax.vjp(lambda a: f(a, j64(b)),
                                            j64(x))[1](j64(g))[0])
    wgrad = lambda g, a: np.asarray(jax.vjp(lambda b: f(j64(a), b),
                                            j64(w))[1](j64(g))[0])
    mags = [prod(np.abs(x), np.abs(w)), dgrad(np.abs(v), np.abs(w)),
            wgrad(np.abs(v), np.abs(x))]
    if mode.parts:
        xp, wp, vp = (np_parts(a, mode.parts, mode.operand)
                      for a in (x, w, v))
        return [sum(prod(xp[i], wp[j]) for i, j in mode.pairs),
                sum(dgrad(vp[i], wp[j]) for i, j in mode.pairs),
                sum(wgrad(vp[i], xp[j]) for i, j in mode.pairs)], mags
    if mode.operand == torch.float16:
        h = lambda a: a.astype(np.float16).astype(np.float64)
        return [h(prod(h(x), h(w))), h(dgrad(h(v), h(w))),
                h(wgrad(h(v), h(x)))], mags
    return [prod(x, w), dgrad(v, w), wgrad(v, x)], mags


def _result_rounding(mode, e):
    "how far the port's float32 result may sit from the emulation `e`"
    if mode.operand == torch.float16 and not mode.parts:
        # the f16 result may round the other way where the two sums differ
        return np.spacing(np.abs(e).astype(np.float16)).astype(np.float64)
    return U_F32 * np.abs(e)


@pytest.mark.parametrize("K", [0, 3], ids=["one-chain", "K-chains"])
@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("value", NEW_VALUES)
def test_layers_match_the_emulation_of_their_mode(value, kind, K):
    """out, dgrad and wgrad of Conv2d (groups, stride, padding) and Linear,
    one chain and K=3, float32, within float32's accumulation noise (and
    the result's own rounding) of the mode's arithmetic at float64"""
    mode = precision.mode_of(value)
    layer, x, w, b, fn, bias = _case(kind, K, np.random.RandomState(4))
    v = np.random.RandomState(5).randn(
        *fn(jnp.asarray(x), jnp.asarray(w)).shape).astype(np.float32)
    ours = _port(layer, x, w, b, v, value)
    emu, mags = _emulate(kind, K, x, w, v, mode)
    emu[0] = emu[0] + np.asarray(bias(b), np.float64)
    for name, o, e, m in zip(("out", "dgrad", "wgrad"), ours, emu, mags):
        bound = _result_rounding(mode, e) + U_F32 * np.abs(e) + ACC * m
        err = np.abs(o - e)
        assert np.all(err <= bound), (name, float(err.max()),
                                      float((err / bound).max()))
    np.testing.assert_allclose(ours[3], _port(layer, x, w, b, v, None)[3],
                               rtol=1e-6, atol=1e-6 * np.abs(v).sum())


def _jax_layer(kind, K, value, x, w, v):
    "JAX's CPU (out, dgrad, wgrad) under the preset `value`"
    if kind == "conv":
        f = lambda a, b: jax.lax.conv_general_dilated(
            a, b.reshape(-1, *b.shape[2:]) if K else b, (2, 2),
            [(1, 1)] * 2, dimension_numbers=("NCHW", "OIHW", "NCHW"),
            feature_group_count=2 * max(K, 1))
    elif K:
        f = lambda a, b: jnp.einsum(
            "bkf,kof->bko", a.reshape(a.shape[0], K, -1),
            b).reshape(a.shape[0], -1)
    else:
        f = lambda a, b: a @ b.T
    with jax.default_matmul_precision(value):
        out, vjp = jax.vjp(jax.jit(f), jnp.asarray(x), jnp.asarray(w))
        grads = vjp(jnp.asarray(v))
    assert out.dtype == jnp.float32
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("K", [0, 3], ids=["one-chain", "K-chains"])
@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("value", sorted(TRUNCATION))
def test_split_bf16_against_jax_on_the_cpu(value, kind, K):
    """X3 and X6 against JAX's CPU backend under the same preset (float32
    products there), out, dgrad and wgrad: within the algorithm's
    truncation plus both sides' accumulation noise"""
    layer, x, w, b, fn, bias = _case(kind, K, np.random.RandomState(6))
    v = np.random.RandomState(7).randn(
        *fn(jnp.asarray(x), jnp.asarray(w)).shape).astype(np.float32)
    ours = _port(layer, x, w, b, v, value)
    ours[0] = ours[0] - bias(b)
    theirs = _jax_layer(kind, K, value, x, w, v)
    _, mags = _emulate(kind, K, x, w, v, precision.mode_of(value))
    for name, o, t, m in zip(("out", "dgrad", "wgrad"), ours, theirs, mags):
        bound = (TRUNCATION[value] + 2 * ACC) * m + U_F32 * np.abs(t)
        err = np.abs(o - t)
        assert np.all(err <= bound), (name, float(err.max()))


def _dense_pair(value, seed):
    "the port's Linear (no bias) and JAX's jitted dot under `value`"
    from bnn_priors_tpu_torch import priors
    from bnn_priors_tpu_torch.models import layers
    rng = np.random.RandomState(seed)
    x = rng.randn(16, 96).astype(np.float32)
    w = rng.randn(24, 96).astype(np.float32)
    with precision.matmul_precision(value):
        ours = torch.func.functional_call(
            layers.Linear(priors.Normal((24, 96), 0., 1.)),
            {"weight_prior.p": torch.tensor(w)},
            (torch.tensor(x),)).numpy()
    with jax.default_matmul_precision(value):
        theirs = np.asarray(jax.jit(lambda a, b: a @ b.T)(x, w))
    assert ours.dtype == theirs.dtype == np.float32
    return ours, theirs, x.astype(np.float64) @ w.T.astype(np.float64)


def test_float64_dense_product_against_jax_to_one_ulp():
    ours, theirs, exact = _dense_pair("F64_F64_F64", 8)
    assert np.all(np.abs(ours - theirs) <= np.spacing(np.abs(theirs)))
    # both are the float64 product rounded to float32
    assert np.all(np.abs(ours - exact) <= U_F32 * np.abs(exact) * 1.0001)


def test_float16_result_dense_product_against_jax_to_one_f16_ulp():
    ours, theirs, _ = _dense_pair("F16_F16_F16", 9)
    assert np.array_equal(ours, ours.astype(np.float16).astype(np.float32))
    ulp = np.spacing(np.abs(theirs).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(ours - theirs) <= ulp)
