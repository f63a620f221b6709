"""The split kernel's table form and the weights split ahead
(`bnn_priors_tpu_torch/ops/split_operand.py::split_table`,
`models/layers.py::split_weights`, and the runners that enter it).

On the CPU the wrappers run their plain versions, so these tests hold the
table form to one `split_operand_reference` an operand, and the layers
that take their weights' parts split ahead to the layers that split them
themselves: both bit for bit, as the parts are the same values and the
products the same calls. The wrapper's call count (`split_operand.calls`)
shows the launches a minibatch step and an exact pass ask for. The slice
as a whole is held to JAX: ResNet-20's minibatch gradient at
`BF16_BF16_F32_X6`, whose products JAX's CPU backend runs in float32,
within the algorithm's truncation as the network carries it (relative L2
1e-4).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from bnn_priors_tpu_torch import exp_utils, precision, priors
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.inference import reject as reject_mod
from bnn_priors_tpu_torch.inference import runner as runner_mod
from bnn_priors_tpu_torch.mcmc.packing import Packer
from bnn_priors_tpu_torch.models import ClassificationModel, layers
from bnn_priors_tpu_torch.ops import split_operand as so

from test_torch_models import (N_EFF, _jax_potential_and_grad, _pair,
                               torch_threads_per_worker)  # noqa: F401

PART_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
# every layout the layers ask of the kernel, and the plain n = 1..3 ones
LAYOUTS = {"one part": (1, (0,)), "n=2": (2, (0, 1)), "n=3": (3, (0, 1, 2)),
           "X3 left": (2, (0, 0, 1)), "X3 right": (2, (0, 1, 0)),
           "X6 left": (3, (0, 0, 1, 1, 0, 2)),
           "X6 right": (3, (0, 1, 0, 1, 2, 0))}
SPLIT_VALUES = ("BF16_BF16_F32", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6")
# the slice against JAX at X6 (float32 products there): relative L2 of the
# minibatch gradient (6.2e-6 measured: X6 drops 3·2^-24 of a product, and
# both sides accumulate in float32 through 20 layers)
X6_GRAD_RTOL = 1e-4


def resnet20():
    "full-width ResNet-20, He-initialised from a seed, on the CPU"
    model = exp_utils.get_model("googleresnet", device="cpu")
    return exp_utils.he_initialize(model, torch.Generator().manual_seed(0))


def weight_operands(model, pk, P):
    """(offset, rows, M) of every multiplying layer's weight in `pk`'s flat
    layout: the forward's rows, and at P > 1 the dgrad's"""
    out = []
    for path, layer in model.named_modules():
        if isinstance(layer, (layers.Conv2d, layers.Linear)):
            i = pk.names.index(f"{path}.weight_prior.p")
            shape, size = pk.shapes[i], pk.sizes[i]
            for rows in ((shape[0], 1) if P > 1 else (1,)):
                out.append((int(pk.offsets[i]), rows, size // rows))
    return out


@pytest.mark.parametrize("part", sorted(PART_DTYPES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_table_equals_one_plain_split_an_operand(layout, part):
    """the plain table form on ResNet-20's weight table, and on operands at
    odd offsets with an odd M, is one `split_operand_reference` an
    operand, bit for bit"""
    n, select = LAYOUTS[layout]
    model = resnet20()
    pk = Packer(model.params())
    src = pk.pack({k: v.detach() for k, v in model.params().items()})
    src = src * torch.exp(torch.randn(src.shape,
                                      generator=torch.Generator().manual_seed(1)))
    ops = weight_operands(model, pk, len(select)) + [
        (1, 3, 27), (7, 1, 5), (13, 5, 12), (pk.total - 9, 1, 9)]
    assert any(o % 4 for o, _, _ in ops) and any(m % 4 for _, _, m in ops)
    table = so.SplitTable(ops, n, PART_DTYPES[part], select)
    before = (so.calls, so.launches)
    out = so.split_table(src, table)
    assert (so.calls, so.launches) == (before[0] + 1, before[1])
    assert torch.equal(out, so.split_table_reference(src, table))
    for i, (o, r, m) in enumerate(ops):
        got = table.view(out, i)
        assert got.shape == (r, len(select), m)
        assert got.data_ptr() % 256 == out.data_ptr() % 256
        assert torch.equal(got, so.split_operand_reference(
            src[o:o + r * m], n, PART_DTYPES[part], select, r))


def test_table_refuses_what_the_kernel_does_not_take():
    src = torch.randn(100)
    with pytest.raises(ValueError):
        so.SplitTable([(0, 1, 10)], 4, torch.bfloat16)
    with pytest.raises(ValueError):
        so.SplitTable([(0, 1, 10)], 2, torch.float32)
    with pytest.raises(ValueError):
        so.SplitTable([(-1, 1, 10)], 2, torch.bfloat16)
    with pytest.raises(ValueError):
        so.SplitTable([(0, 0, 10)], 2, torch.bfloat16)
    with pytest.raises(ValueError):
        so.SplitTable([(0, 1, 10)], 2, torch.bfloat16, (0, 2))
    table = so.SplitTable([(95, 1, 10)], 2, torch.bfloat16)
    assert (table.size, table.extent, table.dst) == (20, 105, (0,))
    with pytest.raises(ValueError):
        so.split_table(src, table)  # reads past the source
    ok = so.SplitTable([(90, 1, 10)], 2, torch.bfloat16)
    with pytest.raises(TypeError):
        so.split_table(src.double(), ok)
    with pytest.raises(ValueError):
        so.split_table(src.view(10, 10), ok)
    with pytest.raises(ValueError):
        so.split_table(src, ok, out=torch.empty(21))
    with pytest.raises(ValueError):
        so.split_operand(src, 2, torch.bfloat16, out=torch.empty(1, 2, 99))
    before = so.launches
    with pytest.raises(ValueError):
        so.split_table(src.to("meta"), ok)  # no kernel, no plain version
    assert so.launches == before
    # into the caller's output, filled with NaN: every element written
    out = torch.full((20,), float("nan"))
    assert so.split_table(src, ok, out=out) is out
    assert torch.equal(out, so.split_operand_reference(src[90:], 2,
                                                       torch.bfloat16)[0]
                       .reshape(-1))
    out = torch.full((4, 3, 25), float("nan"))
    assert so.split_operand(src, 2, torch.bfloat16, (0, 0, 1), 4,
                            out=out) is out
    assert torch.equal(out, so.split_operand_reference(src, 2, torch.bfloat16,
                                                       (0, 0, 1), 4))


def _runner(model, value, n_train=24, batch=8):
    data = exp_utils.get_data("fake_cifar10", n_train=n_train, n_test=8,
                              device="cpu")
    return VerletSGLDRunnerReject(
        model, data.norm.train, data.norm.test, 2, 1, 1, batch_size=batch,
        reject_samples=True, matmul_precision=value, device="cpu")


@contextlib.contextmanager
def _not_ahead(*a, **k):
    "split_weights as a plain block: every layer splits its own weight"
    yield None


def _not_ahead_everywhere(monkeypatch):
    monkeypatch.setattr(runner_mod, "split_weights", _not_ahead)
    monkeypatch.setattr(reject_mod, "split_weights", _not_ahead)


@pytest.mark.parametrize("value", SPLIT_VALUES)
def test_weights_split_ahead_equal_the_layers_own_split(value, monkeypatch):
    """ResNet-20's minibatch potential and gradient, its exact pass and
    its test pass with the weights split ahead equal those of the layers'
    own split, bit for bit"""
    runner = _runner(resnet20(), value)
    bn = {k: v.clone() for k, v in runner.model.named_buffers()}
    pos = runner.chain.position
    xb, yb = runner.train_x[:8], runner.train_y[:8]

    def evaluations():
        for k, v in runner.model.named_buffers():
            v.copy_(bn[k])
        pot, aux, g = runner._value_grad_of_batch(pos, xb, yb)
        exact = runner._exact_vg()
        return [pot, g, *aux.values(), *exact, *runner._eval_current()]

    ahead = evaluations()
    _not_ahead_everywhere(monkeypatch)
    own = evaluations()
    for a, b in zip(ahead, own):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)


@pytest.mark.parametrize("prior", ["LogNormal", "PositiveImproper"])
def test_a_transformed_leaf_is_split_by_its_layer(prior):
    """a prior whose forward transforms its leaf hands the layer a fresh
    tensor: the table leaves it out, and the layer splits the effective
    weight (the rounding of exp(p) or softplus(p)) itself; a plain prior
    beside it is split ahead"""
    gen = torch.Generator().manual_seed(2)
    cls = getattr(priors, prior)
    kw = {"LogNormal": dict(loc=-1.0, scale=0.3),
          "PositiveImproper": dict(loc=0.0, scale=1.0)}[prior]
    net = layers.Sequential(
        layers.Linear(cls((12, 20), **kw)),
        layers.Linear(priors.Normal((5, 12), 0.0, 1.0)))
    model = ClassificationModel(net).init(gen)
    pk = Packer(model.params())
    pos = pk.pack({k: v.detach() for k, v in model.params().items()})
    x = torch.randn(7, 20, generator=gen)
    r = lambda t: so.split_operand_reference(t, 1, torch.bfloat16).view_as(t)
    with precision.matmul_precision("BF16_BF16_F32"):
        with layers.split_weights(model, pk, pos) as split:
            _, params = pk.differentiable(pos)
            out = torch.func.functional_call(model, params, (x,))
            found = {k: split.weight(v, v.shape[0]) is not None
                     for k, v in params.items()}
        # the layers' own split, nothing ahead
        _, params = pk.differentiable(pos)
        own = torch.func.functional_call(model, params, (x,))
    plan, = layers._PLANS[model][pk].values()
    assert len(plan.table) == 1  # the plain Normal's weight only
    assert found == {"net.0.weight_prior.p": False,
                     "net.1.weight_prior.p": True}
    leaves = pk.unpack(pos)
    first = model.net[0].weight_prior.forward(leaves, "net.0.weight_prior")
    assert not torch.equal(first, leaves["net.0.weight_prior.p"])
    h = torch.nn.functional.linear(r(x), r(first))
    w2 = leaves["net.1.weight_prior.p"]
    assert torch.equal(out, torch.nn.functional.linear(r(h), r(w2)))
    assert torch.equal(out, own)


def test_parts_split_ahead_are_not_read_once_the_position_changes():
    "an in-place change of the position turns the lookup off"
    model = resnet20()
    pk = Packer(model.params())
    pos = pk.pack({k: v.detach() for k, v in model.params().items()})
    with precision.matmul_precision("BF16_BF16_F32"):
        with layers.split_weights(model, pk, pos) as split:
            w = pk.unpack(pos)["net.0.weight_prior.p"]
            assert torch.equal(split.weight(w, 16).view_as(w),
                               w.bfloat16().float())
            assert split.weight(w.clone(), 16) is None
            assert split.weight(w.reshape(16, 27), 16) is None
            pos.mul_(2.0)
            assert split.weight(w, 16) is None
        assert layers._SPLIT.get() is None
    with layers.split_weights(model, pk, pos) as split:  # no mode
        assert split is None


@pytest.mark.parametrize("value,step,most", [("BF16_BF16_F32", 43, 45),
                                             ("BF16_BF16_F32_X3", 86, 88),
                                             ("BF16_BF16_F32_X6", 86, 88)])
def test_split_calls_a_step_and_an_exact_pass(value, step, most,
                                              monkeypatch):
    """one ResNet-20 minibatch step asks for 43 splits at one part (66
    before the weights were split ahead) and 86 at X3 and X6 (130): one
    table launch for the 22 weights, 20 forward inputs (the two
    projection shortcuts take their block's), and the incoming gradients
    (one a layer at one part; at P > 1 two, and the input's wgrad layout,
    but the first layer's dgrad). An exact pass splits the weights once
    and each batch asks for the rest; a test pass, the weights once and
    the forward inputs"""
    runner = _runner(resnet20(), value)
    tables = []
    real = layers.split_table
    monkeypatch.setattr(layers, "split_table",
                        lambda *a: tables.append(a[1]) or real(*a))
    pos = runner.chain.position
    xb, yb = runner.train_x[:8], runner.train_y[:8]
    before, launches = so.calls, so.launches
    runner._value_grad_of_batch(pos, xb, yb)
    assert so.calls - before == step <= most
    assert len(tables) == 1 and len(tables[0]) == (22 if step == 43 else 44)
    before = so.calls
    runner._exact_vg()  # 3 batches of 8
    assert len(tables) == 2
    assert so.calls - before == 1 + 3 * (step - 1)
    before = so.calls
    runner._eval_current()  # one batch of 8: no backward, no dgrad layout
    assert len(tables) == 3 and so.calls - before == 1 + 20
    assert len(tables[2]) == 22
    assert so.launches == launches  # the CPU runs the plain versions
    _not_ahead_everywhere(monkeypatch)
    before = so.calls
    runner._value_grad_of_batch(pos, xb, yb)
    assert so.calls - before == {43: 66, 86: 130}[step]


def test_no_weight_table_under_a_compute_dtype(monkeypatch):
    """a minibatch step whose network runs in bfloat16 takes no float32
    product, so it splits nothing: no weight table either"""
    runner = _runner(resnet20(), "BF16_BF16_F32_X3")
    runner.compute_dtype = torch.bfloat16
    tables = []
    real = layers.split_table
    monkeypatch.setattr(layers, "split_table",
                        lambda *a: tables.append(a[1]) or real(*a))
    before = so.calls
    pot, _, g = runner._value_grad_of_batch(
        runner.chain.position, runner.train_x[:8], runner.train_y[:8])
    assert so.calls == before and not tables
    assert bool(torch.isfinite(pot)) and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("value,fwd,bwd", [("BF16_BF16_F32", 20, 22),
                                           ("BF16_BF16_F32_X3", 20, 65)])
def test_split_calls_of_a_run(value, fwd, bwd):
    """a whole reject run's split calls: its minibatch steps, its exact
    passes (the start's and the boundary's) and its two test passes, each
    with one weight table"""
    runner = _runner(resnet20(), value)
    steps, exact, tests = 2 * 3, 2, 2
    before = so.calls
    runner.run()
    assert so.calls - before == (steps * (1 + fwd + bwd) + exact * (
        1 + 3 * (fwd + bwd)) + tests * (1 + fwd))


def test_x6_gradient_against_jax_on_the_cpu():
    """the slice as a whole: ResNet-20's minibatch potential and gradient
    at BF16_BF16_F32_X6, the port's weights split ahead, against JAX's
    CPU backend under the same preset (float32 products), relative L2
    within X6_GRAD_RTOL"""
    jm, params, state, tm = _pair(20, torch.float32)
    rng = np.random.RandomState(4)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 8)
    with jax.default_matmul_precision("BF16_BF16_F32_X6"):
        jpot, _, jg = _jax_potential_and_grad(jm, params, state, x, y)
    pk = Packer(tm.params())
    pos = pk.pack({k: v.detach() for k, v in tm.params().items()})
    tables = []
    real = layers.split_table
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "split_table",
                   lambda *a: tables.append(a[1]) or real(*a))
        with precision.matmul_precision("BF16_BF16_F32_X6"):
            with layers.split_weights(tm, pk, pos):
                theta, p = pk.differentiable(pos)
                pot = tm.potential_avg(p, torch.as_tensor(x),
                                       torch.as_tensor(y), N_EFF, train=True)
                g, = torch.autograd.grad(pot, theta)
    assert len(tables) == 1
    g, pot = g.numpy(), float(pot.detach())
    assert abs(pot - jpot) <= 1e-5 * abs(jpot)
    rel = np.linalg.norm(g - jg) / np.linalg.norm(jg)
    assert rel <= X6_GRAD_RTOL, rel
