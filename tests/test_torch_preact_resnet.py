"""The port's PreAct ResNets against the JAX package's: `PreActResNet` with
`PreActBlock`s at in_planes 4 on 8x8 images, batch 4, in f64 at rtol 1e-9:
the forward pass in train and eval mode, the batchnorm running statistics
after a train step, the log prior, and the potential with its gradient, for
[2, 2, 2, 2] (ResNet-18's stages) and [3, 4, 6, 3] (ResNet-34's) blocks and
without batchnorm; the K-chain fold against K single forwards; the registry's
full-width models (`resnet18`, `thin_resnet18`, `resnet34`) by name and
count; and the dense layer's prior rule.

Parameters are the port's prior draws carried to JAX by name. JAX's
batchnorm takes its batch statistics in f32 even for f64 input, so its
reference is built with `F64StatsBatchNorm` (test_torch_models.py). Each
configuration's JAX values come from one jitted function, once a module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import priors as jax_priors
from bnn_priors_tpu.models import conv_nets as jax_cn
from bnn_priors_tpu.models.base import ClassificationModel as JaxCM
from bnn_priors_tpu_torch import exp_utils, models, priors
from bnn_priors_tpu_torch.mcmc.packing import Packer

from bnn_priors_tpu.mcmc.packing import Packer as JaxPacker
from test_torch_models import F64StatsBatchNorm, torch_threads_per_worker  # noqa

RTOL, ATOL = 1e-9, 1e-12
N_EFF = 100.0
CONFIGS = {"r18": ([2, 2, 2, 2], True), "r34": ([3, 4, 6, 3], True),
           "nobn": ([1, 1, 1, 1], False)}


def jax_preact(blocks, bn=True, in_planes=4, **kw):
    "the JAX network with f64 batch statistics"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cn, "BatchNorm2d", F64StatsBatchNorm)
        return JaxCM(jax_cn.PreActResNet(jax_cn.PreActBlock, blocks, bn=bn,
                                         in_planes=in_planes, **kw))


def port_preact(blocks, bn=True, in_planes=4, seed=0, **kw):
    tm = models.ClassificationModel(models.PreActResNet(
        models.PreActBlock, blocks, bn=bn, in_planes=in_planes, **kw))
    return tm.double().init(torch.Generator().manual_seed(seed))


def _batch(n=4, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3, 8, 8), rng.randint(0, 10, n)


def _random_stats(tm, seed=3):
    "running statistics that differ from their initial values, as numpy"
    rng = np.random.RandomState(seed)
    return {k: (v.numpy().copy() if "num_batches" in k else
                np.abs(rng.randn(*v.shape)) + 0.5)
            for k, v in tm.named_buffers()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """(port model, params, stats, x, y, JAX values) of one configuration;
    the JAX values from one jitted function"""
    blocks, bn = CONFIGS[request.param]
    tm = port_preact(blocks, bn)
    params = {k: v.detach().numpy().copy() for k, v in tm.params().items()}
    stats = _random_stats(tm)
    state0 = {k: v.numpy().copy() for k, v in tm.named_buffers()}
    x, y = _batch()
    jm = jax_preact(blocks, bn)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    j0 = {k: jnp.asarray(v) for k, v in state0.items()}
    js = {k: jnp.asarray(v) for k, v in stats.items()}

    @jax.jit
    def values(p):
        (pot, new_state), g = jax.value_and_grad(
            lambda q: jm.potential_avg(q, j0, jx, jy, N_EFF, train=True),
            has_aux=True)(p)
        f_train, _ = jm.net_apply(p, j0, jx, train=True)
        f_eval, _ = jm.net_apply(p, js, jx, train=False)
        return dict(pot=pot, state=new_state, grad=g, f_train=f_train,
                    f_eval=f_eval, log_prior=jm.log_prior(p))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jv = jax.tree_util.tree_map(np.asarray, values(jp))
    jv["grad"] = np.asarray(JaxPacker(jp).pack(jv["grad"]))
    return dict(name=request.param, tm=tm, params=params, state0=state0,
                stats=stats, x=torch.as_tensor(x), y=torch.as_tensor(y),
                jax=jv)


def _own(case, stats="state0"):
    """the case's port model with its parameters and the given running
    statistics loaded; and its parameters as tensors"""
    tm, tp = case["tm"], {k: torch.as_tensor(v)
                          for k, v in case["params"].items()}
    tm.load_state_dict({**tp, **{k: torch.as_tensor(v)
                                 for k, v in case[stats].items()}})
    return tm, tp


def _close(ours, theirs, what):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def test_forward_train_and_eval_match_jax(case):
    jv = case["jax"]
    tm, _ = _own(case)
    with torch.no_grad():
        f_train = tm.net_apply(None, case["x"], train=True)
        tm, _ = _own(case, "stats")
        f_eval = tm.net_apply(None, case["x"], train=False)
    _close(f_train.numpy(), jv["f_train"], "train-mode logits")
    _close(f_eval.numpy(), jv["f_eval"], "eval-mode logits")


def test_potential_gradient_and_bn_state_match_jax(case):
    """the potential's value and gradient (packed), and the running
    statistics that the train-mode pass leaves"""
    jv = case["jax"]
    tm, tp = _own(case)
    pk = Packer(tp)
    theta = pk.pack(tp).requires_grad_()
    pot = tm.potential_avg(pk.unpack(theta), case["x"], case["y"], N_EFF,
                           train=True)
    g, = torch.autograd.grad(pot, theta)
    _close(float(pot.detach()), float(jv["pot"]), "potential")
    np.testing.assert_allclose(g.numpy(), jv["grad"], rtol=RTOL,
                               atol=1e-9 * np.abs(jv["grad"]).max())
    buffers = dict(tm.named_buffers())
    assert set(buffers) == set(jv["state"])
    assert (len(buffers) > 0) == (case["name"] != "nobn")
    for k, v in buffers.items():
        _close(v.numpy(), jv["state"][k], k)
        if "num_batches" in k:
            assert int(v) == 1


def test_log_prior_matches_jax(case):
    tm, tp = _own(case)
    _close(float(tm.log_prior(tp)), float(case["jax"]["log_prior"]),
           "log prior")


@pytest.mark.parametrize("blocks", [[2, 2, 2, 2], [3, 4, 6, 3]])
def test_names_and_shapes_are_jax(blocks):
    "every leaf and buffer of the JAX init (traced, not run), by name"
    tm = port_preact(blocks)
    shapes = jax.eval_shape(
        lambda k: jax_preact(blocks).init(k, dtype=jnp.float64),
        jax.random.key(0))
    theirs = {k: tuple(v.shape) for d in shapes for k, v in d.items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == theirs
    assert "net.layer2.0.shortcut.0.weight_prior.p" in theirs
    assert "net.layer1.0.shortcut.0.weight_prior.p" not in theirs


@pytest.mark.parametrize("name,count,leaves,buffers", [
    ("resnet18", 11171146, 54, 48), ("thin_resnet18", 700762, 54, 48),
    ("resnet34", 21279306, 102, 96)])
def test_full_width_names_and_counts(name, count, leaves, buffers):
    """the registry's models at their published widths, built by the port
    alone: parameters, leaves and batchnorm buffers, and the flat state's
    padded length"""
    tm = exp_utils.get_model(name, device="cpu")
    params = dict(tm.named_parameters())
    assert sum(v.numel() for v in params.values()) == count
    assert (len(params), len(dict(tm.named_buffers()))) == (leaves, buffers)
    assert Packer(tm.params()).total_padded == -(-count // 1024) * 1024
    width = 16 if name == "thin_resnet18" else 64
    assert params["net.conv1.weight_prior.p"].shape == (width, 3, 3, 3)
    assert params["net.linear.weight_prior.p"].shape == (10, 8 * width)
    if name == "resnet18":
        assert Packer(tm.params()).total_padded == 11171840


def test_vwidth_resnet18_reads_width():
    tm = exp_utils.get_model("vwidth_resnet18", width=4, device="cpu")
    assert tm.params()["net.linear.weight_prior.p"].shape == (10, 32)


@pytest.mark.parametrize("weight_prior,dense", [
    ("convcorrnormal", "Normal"), ("fixedcov_normal", "Normal"),
    ("fixedcov_gennorm", "GenNorm"), ("laplace", "Laplace")])
def test_dense_prior_rule(weight_prior, dense):
    """the kernel-shaped priors give the dense layer their elementwise kin,
    as in the JAX package"""
    wpp = {"beta": 2.0} if weight_prior == "fixedcov_gennorm" else {}
    kw = dict(in_planes=4, weight_prior_params=wpp)
    tm = models.PreActResNet(models.PreActBlock, [1, 1, 1, 1],
                             prior_w=priors.get_prior(weight_prior), **kw)
    jn = jax_cn.PreActResNet(jax_cn.PreActBlock, [1, 1, 1, 1],
                             prior_w=jax_priors.get_prior(weight_prior), **kw)
    assert type(tm.linear.weight_prior).__name__ == dense
    assert type(jn.linear.weight_prior).__name__ == dense
    assert type(tm.conv1.weight_prior).__name__ == \
        type(jn.conv1.weight_prior).__name__
    assert tm.layer1[0].conv1.bias_prior is None


def test_chain_fold_equals_single_forwards():
    """K=3 chains in one folded pass (the residual adds, the shortcut
    convolutions and the spatial mean on (B, 3·C, H, W)) equal three
    single-chain passes, logits and running statistics"""
    K = 3
    tm = port_preact([1, 1, 1, 1])
    per_chain, x = [], torch.as_tensor(_batch(n=4 * K, seed=5)[0])
    for c in range(K):
        tm.init(torch.Generator().manual_seed(c))
        per_chain.append({k: v.detach().clone()
                          for k, v in tm.params().items()})
    bank = {k: torch.stack([p[k] for p in per_chain]) for k in per_chain[0]}
    bufs = {k: torch.stack([v.clone()] * K) for k, v in tm.named_buffers()}
    xk = x.reshape(K, 4, 3, 8, 8)
    with torch.no_grad():
        f = tm.net_apply_chains(bank, bufs, xk, train=True)
        for c in range(K):
            tm.init()  # fresh running statistics a chain
            fc = tm.net_apply(per_chain[c], xk[c], train=True)
            _close(f[c].numpy(), fc.numpy(), f"chain {c} logits")
            for k, v in tm.named_buffers():
                _close(bufs[k][c].numpy(), v.numpy(), f"chain {c} {k}")
