"""`matmul_precision` on the port (`bnn_priors_tpu_torch/precision.py`):
the JAX key's values and their modes, the two multiplying layers under a
mode against JAX on the same numpy inputs, the single-chain runners'
dispatches, and the CLI on the CPU against the JAX CLI.

The layer checks enter the mode explicitly on the CPU. JAX's reference
for the bfloat16 mode is the float32 op at `Precision.HIGHEST` on
operands rounded to bf16, and `jax.vjp` through it for dgrad and wgrad,
with a cotangent that bf16 holds exactly. The port's products return
float32, not rounded to bf16: the tolerance is float32 accumulation-order
noise, 1e-6 of the product of the operands' magnitudes. The other modes'
layers are held against emulations of their arithmetic in
`test_torch_precision_split.py`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bnn_priors_tpu_torch import exp_utils, precision, priors
from bnn_priors_tpu_torch.experiments import train_bnn
from bnn_priors_tpu_torch.inference import (SGLDRunner,
                                            VerletSGLDRunnerReject)
from bnn_priors_tpu_torch.models import layers

from test_torch_cli_mnist import (UCI, _assert_dirs_match,  # noqa: F401
                                  _assert_results_match, banks, env, runs)
from test_torch_models import torch_threads_per_worker  # noqa: F401

# the table of precision.py's docstring: JAX value -> the card's mode
TABLE = {"float32": "float32", "highest": "float32", "F32_F32_F32": "float32",
         "tensorfloat32": "tensorfloat32", "high": "tensorfloat32",
         "TF32_TF32_F32": "tensorfloat32", "bfloat16": "bfloat16",
         "default": "bfloat16", "BF16_BF16_F32": "bfloat16",
         "F16_F16_F32": "float16", "BF16_BF16_F32_X3": "bf16x3",
         "BF16_BF16_F32_X6": "bf16x6", "F16_F16_F16": "float16_out",
         "F64_F64_F64": "float64"}
LEGACY = ("default", "high", "highest", "bfloat16", "tensorfloat32",
          "float32")
# every value JAX's key takes: the legacy names and the dot presets
JAX_VALUES = LEGACY + tuple(p.name for p in jax.lax.DotAlgorithmPreset
                            if p.name != "DEFAULT")
REFUSED = tuple(v for v in JAX_VALUES if v not in TABLE)
U_F32 = 2.0 ** -24  # float32's unit roundoff


# ---------------------------------------------------------------- mapping --
@pytest.mark.parametrize("value", sorted(TABLE))
def test_values_map_to_their_modes(value):
    mode = precision.mode_of(value)
    assert mode is precision.MODES[TABLE[value]]
    assert mode.operand == {"bfloat16": torch.bfloat16,
                            "float16": torch.float16,
                            "bf16x3": torch.bfloat16,
                            "bf16x6": torch.bfloat16,
                            "float16_out": torch.float16,
                            "float64": torch.float64}.get(mode.name)
    assert mode.parts == {"bfloat16": 1, "float16": 1, "bf16x3": 2,
                          "bf16x6": 3}.get(mode.name, 0)
    assert len(mode.pairs) == {"bfloat16": 1, "float16": 1, "bf16x3": 3,
                               "bf16x6": 6}.get(mode.name, 0)
    with jax.default_matmul_precision(value):  # a value JAX takes
        pass


def test_other_jax_values_raise():
    """the F8 presets, BF16_BF16_F32_X9, TF32_TF32_F32_X3 and
    BF16_BF16_BF16, which JAX's CPU backend refuses too, and a value JAX
    refuses everywhere; None is no mode"""
    assert set(REFUSED) == {
        "ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM",
        "ANY_F8_ANY_F8_ANY", "ANY_F8_ANY_F8_ANY_FAST_ACCUM",
        "BF16_BF16_BF16", "BF16_BF16_F32_X9", "TF32_TF32_F32_X3"}
    x = jnp.ones((2, 2), jnp.float32)
    for value in REFUSED:
        with pytest.raises(ValueError, match="not supported by dot_general "
                           "on CPU"), jax.default_matmul_precision(value):
            jax.jit(lambda a: a @ a)(x)
    for value in REFUSED + ("float64",):
        with pytest.raises(ValueError, match=f"{value!r} is not run: JAX's "
                           "CPU backend.*refuses it too.*float32: "
                           "float32, highest, F32_F32_F32"):
            precision.mode_of(value)
    assert precision.mode_of(None) is None
    with precision.matmul_precision(None) as mode:
        assert mode is None and precision.operand_dtype() is None


@pytest.mark.parametrize("value", REFUSED)
def test_cli_refuses_before_any_run_dir(tmp_path, value):
    cfg = dict(train_bnn.DEFAULTS, **UCI)
    cfg.update(matmul_precision=value, log_dir=str(tmp_path))
    with pytest.raises(ValueError, match="JAX's CPU backend"):
        train_bnn.main(cfg)
    assert not any(tmp_path.iterdir())


# ----------------------------------------------------------------- layers --
def _round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _conv(x, w, K, stride, padding, groups):
    """the port Conv2d's function in JAX at HIGHEST; with K, (B, K·C, H, W)
    and (K, O, I, kh, kw) weights as K channel groups"""
    if K:
        w = w.reshape(-1, *w.shape[2:])
        groups *= K
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), [(padding, padding)] * 2,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups, precision=jax.lax.Precision.HIGHEST)


def _linear(x, w, K):
    hi = jax.lax.Precision.HIGHEST
    if not K:
        return jnp.dot(x, w.T, precision=hi)
    xk = x.reshape(x.shape[0], K, -1)
    return jnp.einsum("bkf,kof->bko", xk, w,
                      precision=hi).reshape(x.shape[0], -1)


def _case(kind, K, rng):
    """(port layer, numpy x, w, b, the JAX function of (x, w)); K=0 is the
    one-chain form"""
    if kind == "conv":
        O, I, groups, stride, padding = 6, 4, 2, 2, 1
        layer = layers.Conv2d(priors.Normal((O, I // groups, 3, 3), 0., 1.),
                              priors.Normal((O,), 0., 1.), stride=stride,
                              padding=padding, groups=groups)
        x = rng.randn(3, I * max(K, 1), 9, 9)
        wshape, bshape = (O, I // groups, 3, 3), (O,)
        fn = lambda x, w: _conv(x, w, K, stride, padding, groups)
        bias = lambda b: (b.reshape(-1) if K else b)[None, :, None, None]
    else:
        O, F = 5, 7
        layer = layers.Linear(priors.Normal((O, F), 0., 1.),
                              priors.Normal((O,), 0., 1.))
        x = rng.randn(4, F * max(K, 1))
        wshape, bshape = (O, F), (O,)
        fn = lambda x, w: _linear(x, w, K)
        bias = lambda b: (b.reshape(-1) if K else b)[None, :]
    lead = (K,) if K else ()
    w = rng.randn(*lead, *wshape)
    b = rng.randn(*lead, *bshape)
    f32 = lambda a: a.astype(np.float32)
    return layer, f32(x), f32(w), f32(b), fn, bias


def _port(layer, x, w, b, v, mode):
    """(out, dgrad, wgrad, bias grad) of the port layer at (x, w, b) with
    the cotangent v, under the mode `mode`"""
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    with precision.matmul_precision(mode):
        out = torch.func.functional_call(
            layer, {"weight_prior.p": wt, "bias_prior.p": bt}, (xt,))
        out.backward(torch.tensor(v))
    for t in (out, xt.grad, wt.grad, bt.grad):
        assert t.dtype == torch.float32
    return [t.detach().numpy() for t in (out, xt.grad, wt.grad, bt.grad)]


@pytest.mark.parametrize("K", [0, 3], ids=["one-chain", "K-chains"])
@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_layers_in_bf16_match_jax_on_rounded_operands(kind, K):
    layer, x, w, b, fn, bias = _case(kind, K, np.random.RandomState(0))
    v = _round(np.random.RandomState(1).randn(
        *fn(jnp.asarray(x), jnp.asarray(w)).shape).astype(np.float32))
    ours = _port(layer, x, w, b, v, "bfloat16")

    xr, wr = _round(x), _round(w)
    f = lambda x, w, b: fn(x, w) + bias(b)
    ref, vjp = jax.vjp(f, jnp.asarray(xr), jnp.asarray(wr), jnp.asarray(b))
    refs = [np.asarray(ref)] + [np.asarray(g) for g in vjp(jnp.asarray(v))]
    # the magnitudes that bound float32's accumulation noise, by product
    _, vjp_abs = jax.vjp(fn, jnp.abs(xr), jnp.abs(wr))
    mags = [np.asarray(fn(jnp.abs(xr), jnp.abs(wr)))] + \
        [np.asarray(g) for g in vjp_abs(jnp.abs(jnp.asarray(v)))]
    # float32 results: the bias's float32 add, and accumulation noise
    for name, o, r, m in zip(("out", "dgrad", "wgrad"), ours, refs, mags):
        err = np.abs(o - r)
        assert np.all(err <= U_F32 * np.abs(r) + 1e-6 * m), (
            name, float(err.max()))
    # the bias is added after the product, in float32, and its gradient
    # is float32's sum of the cotangent
    np.testing.assert_allclose(ours[3], np.asarray(refs[3]), rtol=1e-5,
                               atol=1e-6 * np.abs(v).sum())
    # dgrad and wgrad are each one product, not rounded to bf16
    for g in ours[1:3]:
        assert not np.array_equal(g, _round(g))
    plain = _port(layer, x, w, b, v, None)
    assert not np.array_equal(ours[1], plain[1])


@pytest.mark.parametrize("mode", ["float32", "tensorfloat32"])
@pytest.mark.parametrize("K", [0, 3], ids=["one-chain", "K-chains"])
@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_float32_modes_are_the_plain_path_on_the_cpu(kind, K, mode):
    """float32 is the plain path bit for bit; so is TF32 on the CPU, which
    has no TF32 products. A float64 product ignores every mode, as JAX's
    key applies to 32-bit inputs only."""
    layer, x, w, b, fn, _ = _case(kind, K, np.random.RandomState(2))
    v = np.ones(fn(jnp.asarray(x), jnp.asarray(w)).shape, np.float32)
    for a, c in zip(_port(layer, x, w, b, v, mode),
                    _port(layer, x, w, b, v, None)):
        assert np.array_equal(a, c)
    args = [torch.tensor(a, dtype=torch.float64) for a in (x, w, b)]
    call = lambda: torch.func.functional_call(
        layer, {"weight_prior.p": args[1], "bias_prior.p": args[2]},
        (args[0],))
    with precision.matmul_precision("bfloat16"):
        out = call()
    assert out.dtype == torch.float64 and torch.equal(out, call())


# ---------------------------------------------------------------- runners --
_MATMUL = torch.backends.cuda.matmul
FLAGS = ((_MATMUL, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
         (_MATMUL, "allow_bf16_reduced_precision_reduction"))
DISPATCHES = ("_plain_step", "_value_grad_of_batch", "_boundary",
              "_eval_current", "_exact_vg", "_boundary_final",
              "_boundary_initial", "_initial_exact_step")


class Spy:
    """`layers.F` as the layers see it: records the operands of each
    forward product (their type, or "bf16 parts" for float32 operands that
    bf16 holds exactly), the backend flags and the runner dispatches it
    runs under"""

    def __init__(self, mp, raise_at=None):
        import torch.nn.functional as F
        from bnn_priors_tpu_torch.inference.runner import VerletSGLDRunner
        self.F, self.stack, self.seen, self.raise_at = F, [], [], raise_at
        mp.setattr(layers, "F", self)
        for cls in (SGLDRunner, VerletSGLDRunner, VerletSGLDRunnerReject):
            for name in DISPATCHES:
                if name in vars(cls):
                    mp.setattr(cls, name, self.dispatch(name,
                                                        vars(cls)[name]))

    def __getattr__(self, name):
        return getattr(self.F, name)

    def record(self, what, x, w):
        assert w.dtype == x.dtype
        if len(self.seen) + 1 == self.raise_at:
            raise RuntimeError("spy: a failing product")
        exact = all(torch.equal(t, t.bfloat16().float()) for t in (x, w))
        kind = "bf16 parts" if x.dtype == torch.float32 and exact \
            else x.dtype
        self.seen.append((frozenset(self.stack), what, kind,
                          tuple(getattr(o, a) for o, a in FLAGS)))

    def conv2d(self, x, w, *args):
        self.record("conv2d", x, w)
        return self.F.conv2d(x, w, *args)

    def linear(self, x, w, *args):
        self.record("linear", x, w)
        return self.F.linear(x, w, *args)

    def dispatch(self, name, method):
        def run(runner, *args, **kwargs):
            self.stack.append(name)
            try:
                return method(runner, *args, **kwargs)
            finally:
                self.stack.pop()
        return run


def _small_run(cls, matmul_precision, **kw):
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.rand(40, 64), dtype=torch.float32)
    y = torch.tensor(rng.randint(0, 10, 40))
    model = exp_utils.get_model("classificationconvnet", x_train=x,
                                y_train=y, width=4, depth=3, device="cpu")
    exp_utils.he_initialize(model, torch.Generator().manual_seed(1))
    return cls(model, (x[:32], y[:32]), (x[32:], y[32:]), batch_size=12,
               epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
               learning_rate=1e-3, momentum=0.9, temperature=1.0,
               matmul_precision=matmul_precision, device="cpu", **kw)


def _set_flags(values):
    for (o, a), v in zip(FLAGS, values):
        setattr(o, a, v)


@pytest.mark.parametrize("cls,dispatches", [
    (VerletSGLDRunnerReject, {"_initial_exact_step", "_exact_vg",
                              "_plain_step", "_value_grad_of_batch",
                              "_boundary_final", "_eval_current"}),
    (SGLDRunner, {"_boundary", "_plain_step", "_value_grad_of_batch",
                  "_eval_current"})], ids=["reject", "sgld"])
def test_runners_run_every_dispatch_in_the_mode(cls, dispatches):
    """with matmul_precision='bfloat16' every product of every dispatch
    (the step, the exact passes, both boundaries, the evaluation) runs on
    float32 operands rounded to bf16, with TF32 on; the flags and the mode
    are as before after run()"""
    mp = pytest.MonkeyPatch()
    before = (True, False, True)
    _set_flags(before)
    try:
        spy = Spy(mp)
        runner = _small_run(cls, "bfloat16",
                            reject_samples=cls is VerletSGLDRunnerReject)
        runner.run()
        assert frozenset().union(*(s[0] for s in spy.seen)) == dispatches
        assert all(s[0] for s in spy.seen)  # no product outside them
        assert {(s[1], s[2]) for s in spy.seen} == {
            ("conv2d", "bf16 parts"), ("linear", "bf16 parts")}
        # inside the mode: TF32 on (exact on the parts), cuBLAS's bf16
        # split-K reduction off
        assert {s[3] for s in spy.seen} == {(True, True, False)}
        assert tuple(getattr(o, a) for o, a in FLAGS) == before
        assert precision.operand_dtype() is None
        # the boundary halves without a product enter the mode too
        if cls is VerletSGLDRunnerReject:
            seen = []
            mp.setattr(runner.kernel, "initial_step",
                       lambda *a, _f=runner.kernel.initial_step, **k: (
                           seen.append(precision.operand_dtype()),
                           _f(*a, **k))[1])
            runner._boundary_initial(0, 1.0)
            assert seen == [torch.bfloat16]
    finally:
        mp.undo()
        _set_flags((False, True, True))


def test_tf32_flags_are_restored_after_a_raise():
    mp = pytest.MonkeyPatch()
    before = (False, True, True)
    _set_flags(before)
    try:
        spy = Spy(mp, raise_at=7)
        runner = _small_run(VerletSGLDRunnerReject, "tensorfloat32")
        with pytest.raises(RuntimeError, match="a failing product"):
            runner.run()
        assert len(spy.seen) == 6
        assert {s[2] for s in spy.seen} == {torch.float32}
        assert {s[3] for s in spy.seen} == {(True, True, True)}
        assert tuple(getattr(o, a) for o, a in FLAGS) == before
        assert precision.operand_dtype() is None
    finally:
        mp.undo()
    with pytest.raises(ValueError, match="'BF16_BF16_F32_X9'"):
        _small_run(SGLDRunner, "BF16_BF16_F32_X9")


# -------------------------------------------------------------------- CLI --
@pytest.mark.parametrize("value", sorted(TABLE))
def test_cli_on_the_cpu_ignores_the_key(runs, value):
    """every value runs on the CPU, bit for bit the float32 run (JAX's CPU
    backend ignores the key, and the CLI passes none to the runner
    there)"""
    (res, d), (res32, d32) = (runs("port", "uci", matmul_precision=value),
                              runs("port", "uci",
                                   matmul_precision="float32"))
    assert res == res32
    from bnn_priors_tpu_torch.io import load_samples
    a, b = load_samples(str(d / "samples.pt")), load_samples(
        str(d32 / "samples.pt"))
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_cli_matches_the_jax_cli_at_one_value(runs):
    (jres, jdir) = runs("jax", "uci", matmul_precision="highest")
    (tres, tdir) = runs("port", "uci", matmul_precision="highest")
    _assert_dirs_match(jdir, tdir, 277)
    _assert_results_match(tres, jres)
