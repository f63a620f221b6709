"""The port's flat Packer against the JAX package's, on a dict tree whose
sorted key order differs from its insertion order (`net.10.*` sorts before
`net.2.*`) and whose total is ragged. Everything must match exactly in f64.
"""
import jax.numpy as jnp
import numpy as np
import torch

from bnn_priors_tpu.mcmc.packing import PACK_ALIGN as JAX_PACK_ALIGN
from bnn_priors_tpu.mcmc.packing import Packer as JaxPacker
from bnn_priors_tpu_torch.interop import packed_from_jax
from bnn_priors_tpu_torch.mcmc.packing import PACK_ALIGN, Packer
from bnn_priors_tpu_torch.mcmc.segmented import vclip, vsum

from test_torch_models import torch_threads_per_worker  # noqa: F401


def _tree():
    rng = np.random.RandomState(0)
    # insertion order is model order; the packers must use sorted order
    shapes = {"net.2.weight": (7, 3, 3, 3), "net.2.bias": (7,),
              "net.10.weight_prior.p": (11, 13), "net.0.weight_prior.p": (5,),
              "net.10.bias_prior.p": (11,), "net.1.running_scalar": ()}
    return {k: np.asarray(rng.randn(*s)) for k, s in shapes.items()}


def _both(tree):
    jp = JaxPacker({k: jnp.asarray(v) for k, v in tree.items()})
    tp = Packer({k: torch.as_tensor(v) for k, v in tree.items()})
    return jp, tp


def test_layout_matches_jax():
    jp, tp = _both(_tree())
    assert PACK_ALIGN == JAX_PACK_ALIGN == 1024
    assert tp.names == jp.names
    assert tp.names[:2] == ["net.0.weight_prior.p", "net.1.running_scalar"]
    assert tp.names.index("net.10.bias_prior.p") < tp.names.index("net.2.bias")
    assert tp.names.index("net.2.bias") < tp.names.index("net.2.weight")
    assert tp.shapes == jp.shapes and tp.sizes == jp.sizes
    assert (tp.total, tp.total_padded, tp.n_pad) == (jp.total,
                                                     jp.total_padded, jp.n_pad)
    assert tp.total % PACK_ALIGN != 0 and tp.total_padded % PACK_ALIGN == 0
    np.testing.assert_array_equal(tp.offsets, jp.offsets)
    np.testing.assert_array_equal(tp.segment_ids.numpy(),
                                  np.asarray(jp.segment_ids))


def test_pack_unpack_and_zero_tail_match_jax():
    tree = _tree()
    jp, tp = _both(tree)
    vj = np.asarray(jp.pack({k: jnp.asarray(v) for k, v in tree.items()}))
    vt = tp.pack({k: torch.as_tensor(v) for k, v in tree.items()})
    assert vt.dtype == torch.float64
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(vt[tp.total:].numpy(), 0.0)
    out = tp.unpack(vt)
    assert list(out) == tp.names
    for k, v in tree.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
        assert out[k].data_ptr() >= vt.data_ptr()  # a view, not a copy
    # the JAX vector is the port's vector (shared leaf order)
    np.testing.assert_array_equal(packed_from_jax(tp, vj).numpy(), vj)
    np.testing.assert_array_equal(tp.mask_pad(vt + 1.0)[tp.total:].numpy(),
                                  0.0)


def test_unpack_views_carry_gradient_back_packed():
    tree = _tree()
    _, tp = _both(tree)
    theta = tp.pack({k: torch.as_tensor(v) for k, v in tree.items()})
    theta.requires_grad_()
    views = tp.unpack(theta)
    loss = sum((i + 1.0) * (v ** 2).sum() for i, v in enumerate(views.values()))
    g, = torch.autograd.grad(loss, theta)
    expect = tp.expand(torch.arange(1.0, tp.n_leaves + 1,
                                    dtype=torch.float64)) * 2 * theta.detach()
    np.testing.assert_array_equal(g.numpy(), expect.numpy())


def test_segment_ops_match_jax():
    tree = _tree()
    jp, tp = _both(tree)
    rng = np.random.RandomState(1)
    vec = rng.randn(tp.total_padded)
    vec[tp.total:] = 1e6  # reductions must not see the padding tail
    jv, tv = jnp.asarray(vec), torch.as_tensor(vec)
    np.testing.assert_array_equal(tp.segment_sum(tv).numpy(),
                                  np.asarray(jp.segment_sum(jv)))
    np.testing.assert_array_equal(tp.leaf_means(tv).numpy(),
                                  np.asarray(jp.leaf_means(jv)))
    np.testing.assert_array_equal(tp.leaf_firsts(tv).numpy(),
                                  np.asarray(jp.leaf_firsts(jv)))
    scal = rng.rand(tp.n_leaves) + 0.5
    ex = tp.expand(torch.as_tensor(scal))
    np.testing.assert_array_equal(ex.numpy(),
                                  np.asarray(jp.expand(jnp.asarray(scal))))
    np.testing.assert_array_equal(ex[tp.total:].numpy(), 1.0)
    np.testing.assert_array_equal(tp.leaf_firsts(ex).numpy(), scal)
    # per-leaf scalar dicts round-trip in the shared order
    d = tp.unpack_leaf_scalars(torch.as_tensor(scal))
    assert list(d) == list(jp.unpack_leaf_scalars(jnp.asarray(scal)))
    np.testing.assert_array_equal(tp.pack_leaf_scalars(d).numpy(), scal)


def test_flat_vector_helpers():
    v = torch.as_tensor([-3.0, 0.5, 2.0, 7.0], dtype=torch.float64)
    assert float(vsum(v)) == 6.5
    np.testing.assert_array_equal(vclip(v, -1.0, 2.0).numpy(),
                                  [-1.0, 0.5, 2.0, 2.0])
