"""The port's segmented and hybrid packers (`bnn_priors_tpu_torch/mcmc/
segmented.py`) and tree helpers (`mcmc/tree_util.py`) against the JAX
package's, on the same numpy arrays, in f64:

* pack/unpack round trips, one chain and K=3, and the flat order's
  permutation (`from_flat`/`to_flat`);
* `native_idx`, `small_idx`, `small_offsets`, `n_segments`, and
  `segment_sum`, `leaf_means`, `leaf_firsts`, `expand` against JAX's
  `SegPacker`/`HybridPacker` (rtol 1e-12), on ResNet-20's real leaf shapes
  (65 leaves: 22 hybrid segments, 65 segmented) and a Gaussian model;
* `vsum`, `vdot`, `vclip`, `vwhere` on flat and segmented vectors;
* the nine `tree_util` helpers against JAX's (rtol 1e-12; the generator-
  drawn noise by shape, dtype and moments).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.mcmc import segmented as jseg
from bnn_priors_tpu.mcmc import tree_util as jtu
from bnn_priors_tpu_torch.exp_utils import get_model
from bnn_priors_tpu_torch.mcmc import tree_util as ttu
from bnn_priors_tpu_torch.mcmc.packing import Packer
from bnn_priors_tpu_torch.mcmc.segmented import (HybridPacker, SegPacker,
                                                 SegVec, make_packer, vclip,
                                                 vdot, vsum, vwhere)

from test_torch_models import torch_threads_per_worker  # noqa: F401

RTOL = 1e-12


def _resnet20_shapes():
    "ResNet-20's parameter names and shapes, from the port's model"
    model = get_model("googleresnet", device="cpu")
    return {k: tuple(v.shape) for k, v in model.params().items()}


SHAPES = {"resnet20": _resnet20_shapes(),
          "gaussian": {"0.p": (7,), "1.p": (3, 2), "2.p": (5,)}}


def _trees(shapes, lead=(), seed=0):
    "the same random f64 leaves as a torch dict and a JAX dict"
    rng = np.random.RandomState(seed)
    arrays = {k: rng.randn(*lead, *s) for k, s in sorted(shapes.items())}
    return ({k: torch.as_tensor(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("model", sorted(SHAPES))
def test_hybrid_layout_matches_jax(model):
    tree, jtree = _trees(SHAPES[model])
    hp, jhp = HybridPacker(tree), jseg.HybridPacker(jtree)
    assert hp.native_idx == jhp.native_idx
    assert hp.small_idx == jhp.small_idx
    np.testing.assert_array_equal(hp.small_offsets, jhp.small_offsets)
    assert hp.n_segments == jhp.n_segments
    sp = SegPacker(tree)
    assert sp.n_segments == sp.n_leaves == jseg.SegPacker(jtree).n_leaves
    if model == "resnet20":
        assert (hp.n_segments, sp.n_segments) == (22, 65)
        assert sum(hp.sizes[i] for i in hp.native_idx) == 270256
        assert int(hp.small_offsets[-1]) == 2218
        assert (hp.total, hp.flat_padded) == (272474, 273408)


@pytest.mark.parametrize("model", sorted(SHAPES))
@pytest.mark.parametrize("packing", ["segmented", "hybrid"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_unpack_and_the_flat_order(model, packing, lead):
    tree, _ = _trees(SHAPES[model], lead)
    pk = make_packer(packing, {k: v[(0,) * len(lead)]
                               for k, v in tree.items()})
    vec = pk.pack(tree)
    assert isinstance(vec, SegVec) and vec.lead == lead
    assert len(vec.leaves) == pk.n_segments
    out = pk.unpack(vec)
    assert list(out) == pk.names
    for k in tree:
        assert torch.equal(out[k], tree[k])
        assert out[k]._base is vec.base  # a view of the one buffer
    flat = Packer(tree if not lead else {k: v[0] for k, v in tree.items()}
                  ).pack(tree)
    assert torch.equal(pk.to_flat(vec), flat)
    back = pk.from_flat(flat)
    assert torch.equal(back.base, vec.base) and back.arena is vec.arena
    assert torch.equal(pk.arena(lead).pack(vec.leaves).base, vec.base)


@pytest.mark.parametrize("model", sorted(SHAPES))
@pytest.mark.parametrize("packing", ["segmented", "hybrid"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_leaf_reductions_match_jax(model, packing, lead):
    """segment_sum, leaf_means, leaf_firsts and expand of the port's packer
    against JAX's on the same arrays (JAX's K-chain forms by vmap)"""
    tree, jtree = _trees(SHAPES[model], lead, seed=1)
    one = {k: v[(0,) * len(lead)] for k, v in tree.items()}
    pk = make_packer(packing, one)
    jcls = {"segmented": jseg.SegPacker, "hybrid": jseg.HybridPacker}[packing]
    jpk = jcls({k: jnp.asarray(v.numpy()) for k, v in one.items()})
    vec = pk.pack(tree)
    scalars = np.random.RandomState(2).rand(*lead, pk.n_leaves) + 0.5
    per = (lambda f: jax.vmap(f)) if lead else (lambda f: f)
    jvec = per(jpk.pack)(jtree)
    for name in ("segment_sum", "leaf_means", "leaf_firsts"):
        np.testing.assert_allclose(
            getattr(pk, name)(vec).numpy(),
            np.asarray(per(getattr(jpk, name))(jvec)), rtol=RTOL,
            err_msg=name)
    mine = pk.expand(torch.as_tensor(scalars))
    theirs = per(jpk.expand)(jnp.asarray(scalars))
    assert len(mine.leaves) == len(theirs.leaves)
    for a, b in zip(mine.leaves, theirs.leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    np.testing.assert_allclose(pk.leaf_firsts(mine).numpy(), scalars,
                               rtol=0)
    # the preconditioner times a state vector, leaf-wise, as in JAX
    prod = mine * vec
    jprod = per(lambda m, v: m * v)(theirs, jvec)
    for a, b in zip(prod.leaves, jprod.leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)


@pytest.mark.parametrize("packing", ["flat", "segmented", "hybrid"])
def test_vector_helpers_one_chain_and_k_chains(packing):
    tree, _ = _trees(SHAPES["resnet20"], (3,), seed=3)
    pk = make_packer(packing, {k: v[0] for k, v in tree.items()})
    fp = Packer({k: v[0] for k, v in tree.items()})
    a, b = pk.pack(tree), pk.pack({k: v * 0.5 - 1 for k, v in tree.items()})
    fa, fb = fp.pack(tree), fp.pack({k: v * 0.5 - 1 for k, v in tree.items()})
    np.testing.assert_allclose(vsum(a).numpy(), fa.sum(-1).numpy(), rtol=RTOL)
    np.testing.assert_allclose(vdot(a, b).numpy(), (fa * fb).sum(-1).numpy(),
                               rtol=RTOL)
    assert torch.equal(pk.to_flat(vclip(a, -0.3, 0.7)),
                       fp.mask_pad(torch.clamp(fa, -0.3, 0.7)))
    cond = torch.tensor([True, False, True])
    assert torch.equal(pk.to_flat(vwhere(cond, a, b)),
                       torch.where(cond[:, None], fa, fb))
    one = pk.pack({k: v[1] for k, v in tree.items()})
    np.testing.assert_allclose(float(vsum(one * one)),
                               float((fa[1] * fa[1]).sum()), rtol=RTOL)
    # SegVec algebra of one arena is one op on the buffers
    if packing != "flat":
        s = (a - b) * 2.0 + a / 3.0
        assert s.arena is a.arena and s.base is not None
        assert torch.equal(pk.to_flat(s), fp.mask_pad((fa - fb) * 2.0
                                                      + fa / 3.0))


@pytest.mark.parametrize("packing", ["segmented", "hybrid"])
def test_gradient_through_the_buffer(packing):
    "a gradient taken with respect to the buffer comes back as a SegVec"
    tree, _ = _trees(SHAPES["gaussian"], seed=4)
    pk = make_packer(packing, tree)
    vec = pk.pack(tree)
    theta, params = pk.differentiable(vec)
    loss = sum((p ** 3).sum() for p in params.values())
    g, = torch.autograd.grad(loss, theta)
    gv = pk.wrap_grad(g, vec)
    expect = {k: 3 * v ** 2 for k, v in tree.items()}
    assert torch.equal(pk.to_flat(gv), Packer(tree).pack(expect))


def test_normal_like_places_the_flat_draw():
    "one generator state: the flat packing's normals, in every packing"
    tree, _ = _trees(SHAPES["resnet20"], seed=5)
    fp = Packer(tree)
    flat = fp.normal_like(torch.Generator().manual_seed(9),
                          fp.pack(tree))
    for packing in ("segmented", "hybrid"):
        pk = make_packer(packing, tree)
        seg = pk.normal_like(torch.Generator().manual_seed(9), pk.pack(tree))
        assert torch.equal(pk.to_flat(seg), flat)


# -- tree_util ---------------------------------------------------------------
def _tree_pair(seed):
    return _trees(SHAPES["gaussian"], seed=seed)


def test_tree_reductions_match_jax():
    (ta, ja), (tb, jb) = _tree_pair(6), _tree_pair(7)
    np.testing.assert_allclose(float(ttu.tree_dot(ta, tb)),
                               float(jtu.tree_dot(ja, jb)), rtol=RTOL)
    mine, theirs = ttu.tree_leaf_dot(ta, tb), jtu.tree_leaf_dot(ja, jb)
    assert list(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_allclose(float(mine[k]), float(theirs[k]),
                                   rtol=RTOL)
    assert ttu.tree_numel(ta) == jtu.tree_numel(ja) == 18


def test_tree_maps_match_jax():
    (ta, ja), (tb, jb) = _tree_pair(8), _tree_pair(9)
    alpha = {k: 0.1 * (i + 1) for i, k in enumerate(sorted(ta))}
    pairs = [
        (ttu.tree_scale_add(ta, tb, 0.3), jtu.tree_scale_add(ja, jb, 0.3)),
        (ttu.tree_scale_add(ta, tb, alpha),
         jtu.tree_scale_add(ja, jb, {k: jnp.asarray(v)
                                     for k, v in alpha.items()})),
        (ttu.tree_zeros_like(ta), jtu.tree_zeros_like(ja)),
        (ttu.tree_ones_scalar_like(ta), jtu.tree_ones_scalar_like(ja)),
        (ttu.tree_select(True, ta, tb), jtu.tree_select(True, ja, jb)),
        (ttu.tree_select(False, ta, tb), jtu.tree_select(False, ja, jb)),
        (ttu.tree_clip(ta, 0.5), jtu.tree_clip(ja, 0.5)),
    ]
    for mine, theirs in pairs:
        assert list(mine) == sorted(theirs)
        for k in theirs:
            assert mine[k].dtype == torch.float64
            assert tuple(mine[k].shape) == tuple(theirs[k].shape)
            np.testing.assert_allclose(mine[k].numpy(),
                                       np.asarray(theirs[k]), rtol=RTOL)


def test_tree_randn_like():
    "shapes and dtypes as JAX's; the generator's draws, standard normal"
    big = {"a": torch.zeros(200, 50, dtype=torch.float64),
           "b": torch.zeros(30000, dtype=torch.float32)}
    jbig = {k: jnp.zeros(v.shape, {torch.float64: jnp.float64,
                                   torch.float32: jnp.float32}[v.dtype])
            for k, v in big.items()}
    mine = ttu.tree_randn_like(torch.Generator().manual_seed(0), big)
    theirs = jtu.tree_randn_like(jax.random.key(0), jbig)
    for k in big:
        assert mine[k].shape == big[k].shape
        assert mine[k].dtype == big[k].dtype
        assert np.dtype(str(mine[k].dtype).split(".")[1]) == theirs[k].dtype
        # 10,000+ draws: mean within 5 standard errors, std within 3%
        x = mine[k].double()
        assert abs(float(x.mean())) < 5 / x.numel() ** 0.5
        assert abs(float(x.std()) - 1.0) < 0.03
    again = ttu.tree_randn_like(torch.Generator().manual_seed(0), big)
    assert all(torch.equal(mine[k], again[k]) for k in big)
