"""The update over segments (`ops.fused_update.fused_langevin_update_
segments` and its K-chain form) through its plain version, on the CPU:

* the port's `VerletSGLD`/`SGLD` phases on a hybrid and a segmented state
  against the JAX package's XLA segmented branch at σ = 0, f64, on
  ResNet-8's leaves (rtol 1e-12 on θ, m, v and the energy accumulators);
* against the port's flat plain update with the noise on: θ', m', v' and
  the partials equal, bit for bit, after the flat order's permutation (the
  segments draw each element's ξ by its flat index);
* K=3: row k of a chain launch equals a one-chain call with chain k's
  seed and σ, bit for bit (the partials to rtol 1e-13: torch's CPU sums);
* the wrappers: a CPU tensor takes the plain version and counts no launch;
  what the kernel does not take raises; the table's layout is the CUDA
  source's;
* the table of pieces, on ResNet-20's hybrid and segmented packers and on
  leaves whose sizes are not multiples of 4, one chain and K=3: each
  (chain, element) once, no piece across a leaf or a chunk, the positions
  the packer's own flat map gives.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import mcmc as jmcmc
from bnn_priors_tpu_torch import mcmc, models
from bnn_priors_tpu_torch.mcmc.packing import Packer
from bnn_priors_tpu_torch.mcmc.segmented import SegmentTable, make_packer
from bnn_priors_tpu_torch.ops import fused_update as fu

from test_torch_models import torch_threads_per_worker  # noqa: F401

RTOL = 1e-12
N, LR, A = 1000.0, 1e-3, 0.9
# ResNet-8's parameter names and shapes (the JAX package's store names)
SHAPES = {k: tuple(v.shape) for k, v in models.ResNet(depth=8).params().items()}


def _leaves(seed, scale=1.0):
    "random f64 leaves of ResNet-8's shapes"
    rng = np.random.RandomState(seed)
    return {k: scale * rng.randn(*s) for k, s in sorted(SHAPES.items())}


@pytest.fixture(scope="module")
def state_arrays():
    "θ, m, v (> 0), g and per-leaf M, as numpy dicts"
    params = _leaves(0)
    v = {k: np.abs(x) + 0.1 for k, x in _leaves(2).items()}
    scalars = np.random.RandomState(4).rand(len(params)) + 0.5
    return params, _leaves(1), v, _leaves(3, 0.05), scalars


def _jax_state(packing, arrays, kernel):
    params, m, v, g, scalars = arrays
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    state = kernel.init(jp, jax.random.key(0), save_state=True)
    pk = kernel.packer
    state = state._replace(
        momentum=pk.pack({k: jnp.asarray(x) for k, x in m.items()}),
        square_avg=pk.pack({k: jnp.asarray(x) for k, x in v.items()}),
        precond=pk.expand(jnp.asarray(scalars)))
    return state, pk.pack({k: jnp.asarray(x) for k, x in g.items()})


def _port_state(packing, arrays, kernel):
    params, m, v, g, scalars = arrays
    t = lambda d: {k: torch.as_tensor(x) for k, x in d.items()}
    state = kernel.init(t(params), seed=0, **(
        {"save_state": True} if isinstance(kernel, mcmc.VerletSGLD) else {}))
    pk = kernel.packer
    state.momentum, state.square_avg = pk.pack(t(m)), pk.pack(t(v))
    state.precond = pk.expand(torch.as_tensor(scalars))
    return state, pk.pack(t(g))


def _close(mine, theirs, name):
    for a, b in zip(mine.leaves, theirs.leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-15, err_msg=name)


@pytest.mark.parametrize("packing", ["hybrid", "segmented"])
def test_ggmc_phases_match_jax_segmented_branch(packing, state_arrays):
    """initial, mid and final GGMC phases at T=0 (σ = 0), then a
    preconditioner update and another mid phase"""
    jk = jmcmc.VerletSGLD(num_data=N, momentum=A, packing=packing)
    tk = mcmc.VerletSGLD(num_data=N, momentum=A, packing=packing)
    js, jg = _jax_state(packing, state_arrays, jk)
    ts, tg = _port_state(packing, state_arrays, tk)
    for kind in ("initial_step", "step", "update", "step", "final_step"):
        if kind == "update":
            js, ts = jk.update_preconditioner(js), tk.update_preconditioner(ts)
            _close(ts.precond, js.precond, "precond")
            continue
        kw = {"save_state": True} if kind == "initial_step" else {}
        js, _ = getattr(jk, kind)(js, jg, LR, 0.0, **kw)
        ts, _ = getattr(tk, kind)(ts, tg, LR, 0.0, **kw)
        for name in ("position", "momentum", "square_avg"):
            _close(getattr(ts, name), getattr(js, name), f"{kind} {name}")
        for name in ("delta_energy_acc", "prev_nmd"):
            np.testing.assert_allclose(float(getattr(ts, name)),
                                       float(getattr(js, name)), rtol=RTOL,
                                       err_msg=f"{kind} {name}")
    np.testing.assert_allclose(
        float(tk.delta_energy(ts, tg, LR, 0.5, 0.25)),
        float(jk.delta_energy(js, jg, LR, 0.5, 0.25)), rtol=RTOL)


@pytest.mark.parametrize("packing", ["hybrid", "segmented"])
def test_sgld_step_matches_jax_segmented_branch(packing, state_arrays):
    jk = jmcmc.SGLD(num_data=N, momentum=A, packing=packing)
    tk = mcmc.SGLD(num_data=N, momentum=A, packing=packing)
    params = {k: jnp.asarray(x) for k, x in state_arrays[0].items()}
    js = jk.init(params, jax.random.key(0))
    pk = jk.packer
    js = js._replace(
        momentum=pk.pack({k: jnp.asarray(x)
                          for k, x in state_arrays[1].items()}),
        square_avg=pk.pack({k: jnp.asarray(x)
                            for k, x in state_arrays[2].items()}),
        precond=pk.expand(jnp.asarray(state_arrays[4])))
    jg = pk.pack({k: jnp.asarray(x) for k, x in state_arrays[3].items()})
    ts, tg = _port_state(packing, state_arrays, tk)
    for _ in range(2):
        js, jm = jk.step(js, jg, LR, 0.0)
        ts, tm = tk.step(ts, tg, LR, 0.0)
    for name in ("position", "momentum", "square_avg"):
        _close(getattr(ts, name), getattr(js, name), name)
    for k in ("est_temperature", "est_config_temp"):
        for leaf, v in jm[k].items():
            np.testing.assert_allclose(float(tm[k][leaf]), float(v),
                                       rtol=RTOL, atol=1e-300)


def _segment_inputs(packing, lead, seed=0):
    "random (θ, m, v, g) SegVecs and a per-leaf M, with their flat forms"
    rng = np.random.RandomState(seed)
    shapes = {k: v.shape for k, v in _leaves(0).items()}
    pk = make_packer(packing, {k: torch.zeros(s) for k, s in shapes.items()})
    mk = lambda f: {k: torch.as_tensor(f(rng.randn(*lead, *s)))
                    for k, s in shapes.items()}
    trees = [mk(lambda x: x), mk(lambda x: x), mk(lambda x: np.abs(x) + .1),
             mk(lambda x: 0.05 * x)]
    scalars = torch.as_tensor(rng.rand(*lead, pk.n_leaves) + 0.5)
    fp = Packer({k: torch.zeros(s) for k, s in shapes.items()})
    segs = [pk.pack(t) for t in trees] + [pk.expand(scalars)]
    flats = [fp.pack(t) for t in trees] + [fp.expand(scalars)]
    return pk, segs, flats


COEFFS = {"sgld_mid": (A, -(LR * N) ** 0.5, 0.7, (LR / N) ** 0.5, 0.99),
          "ggmc_final": (A ** 0.5, -0.5 * A ** 0.5 * (LR * N) ** 0.5, 0.7,
                         0.0, 1.0)}


@pytest.mark.parametrize("packing", ["hybrid", "segmented"])
@pytest.mark.parametrize("coeffs", sorted(COEFFS))
def test_segments_equal_the_flat_update_with_noise(packing, coeffs):
    "σ = 0.7: every element draws the flat update's ξ for its flat index"
    pk, segs, flats = _segment_inputs(packing, ())
    c = COEFFS[coeffs]
    table = pk.kernel_table((), "cpu", fu.SEGMENT_CHUNK)
    *_, ps = fu.fused_langevin_update_segments_reference(
        *(s.base for s in segs), 77, c, table=table)
    *_, pf = fu.fused_langevin_update_reference(*flats, 77, c,
                                                total=pk.total)
    for s, f in zip(segs[:3], flats[:3]):
        assert torch.equal(pk.to_flat(s), f)
    assert torch.equal(ps, pf)


@pytest.mark.parametrize("packing", ["hybrid", "segmented"])
def test_chain_rows_equal_one_chain_calls(packing):
    """K=3 at per-chain σ: row k is the one-chain call with seed
    seeds[k] + offset and σ_k, and equals the flat (K, T) update's row"""
    K = 3
    pk, segs, flats = _segment_inputs(packing, (K,), seed=1)
    seeds = torch.tensor([5, 2 ** 40 + 3, 99], dtype=torch.int64)
    sigma = torch.tensor([0.0, 0.5, 1.5], dtype=torch.float64)
    c4 = (A, -0.3, 0.01, 0.99)
    one = [pk.pack({k: v[i].clone() for k, v in pk.unpack(s).items()})
           for i in range(K) for s in segs[:4]]
    table = pk.kernel_table((K,), "cpu", fu.SEGMENT_CHUNK)
    *_, parts = fu.fused_langevin_update_segments_chains_reference(
        *(s.base for s in segs), seeds, sigma, c4, table=table,
        seed_offset=11)
    *_, fparts = fu.fused_langevin_update_chains_reference(
        *flats, seeds, sigma, c4, total=pk.total, seed_offset=11)
    for s, f in zip(segs[:3], flats[:3]):
        assert torch.equal(pk.to_flat(s), f)
    assert torch.equal(parts, fparts)
    t1 = pk.kernel_table((), "cpu", fu.SEGMENT_CHUNK)
    for i in range(K):
        th, m, v, g = one[4 * i:4 * i + 4]
        M = pk.expand(pk.leaf_firsts(segs[4])[i])
        *_, p1 = fu.fused_langevin_update_segments_reference(
            th.base, m.base, v.base, g.base, M.base, int(seeds[i]) + 11,
            (c4[0], c4[1], float(sigma[i]), c4[2], c4[3]), table=t1)
        for mine, bank in ((th, segs[0]), (m, segs[1]), (v, segs[2])):
            assert torch.equal(pk.to_flat(mine), pk.to_flat(bank)[i])
        # torch's CPU sum of one row and of a (K, T) bank's row may add in
        # another order: the plain version's partials agree to rounding
        # (the kernel's are held bitwise on the card, chip_smoke phase 16)
        np.testing.assert_allclose(p1.numpy(), parts[i].numpy(), rtol=1e-13)


def test_wrappers_route_cpu_to_plain_and_refuse_the_rest():
    pk, segs, _ = _segment_inputs("hybrid", ())
    f32 = [s.base.float() for s in segs]
    table = pk.kernel_table((), "cpu", fu.SEGMENT_CHUNK)
    before = (fu.segments_launches, fu.segments_chain_launches,
              fu.launches, fu.chain_launches)
    c = COEFFS["sgld_mid"]
    ref = [t.clone() for t in f32]
    *_, p = fu.fused_langevin_update_segments(*f32, 3, c, table=table)
    *_, pr = fu.fused_langevin_update_segments_reference(*ref, 3, c,
                                                         table=table)
    assert all(torch.equal(a, b) for a, b in zip(f32, ref))
    assert torch.equal(p, pr) and p.dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        fu.fused_langevin_update_segments(*(s.base for s in segs), 3, c,
                                          table=table)
    with pytest.raises(ValueError, match="contiguous"):
        fu.fused_langevin_update_segments(f32[0][:-1], *f32[1:], 3, c,
                                          table=table)
    with pytest.raises(ValueError, match="use fused_langevin_update_segm"):
        fu.fused_langevin_update_segments(
            *f32, 3, c, table=pk.kernel_table((2,), "cpu", fu.SEGMENT_CHUNK))
    meta = pk.kernel_table((), "meta", fu.SEGMENT_CHUNK)
    with pytest.raises(ValueError, match="no kernel"):
        fu.fused_langevin_update_segments(*(t.to("meta") for t in f32), 3,
                                          c, table=meta)
    K = 2
    pk2, segs2, _ = _segment_inputs("segmented", (K,))
    t2 = pk2.kernel_table((K,), "cpu", fu.SEGMENT_CHUNK)
    with pytest.raises(ValueError, match="int64"):
        fu.fused_langevin_update_segments_chains(
            *(s.base.float() for s in segs2), torch.zeros(3, dtype=torch.int64),
            torch.zeros(K), c[:2] + c[3:], table=t2)
    assert (fu.segments_launches, fu.segments_chain_launches,
            fu.launches, fu.chain_launches) == before


def test_the_table_is_the_cuda_sources_layout():
    """the Python table's columns, their count and the chunk are those the
    kernel reads (`csrc/fused_update_segments.cu`, `csrc/langevin.cuh`)"""
    csrc = os.path.join(os.path.dirname(fu.__file__), "..", "csrc")
    src = open(os.path.join(csrc, "fused_update_segments.cu")).read()
    head = open(os.path.join(csrc, "langevin.cuh")).read()
    cols = re.search(r"enum PieceCol \{([^}]*)\}", src).group(1)
    camel = lambda name: "k" + "".join(w.capitalize() if w != "x" else "X"
                                       for w in name.split("_"))
    assert [c.strip() for c in cols.split(",")] == [
        camel(c) for c in SegmentTable.COLUMNS]
    n_cols = int(re.search(r"constexpr int kPieceCols = (\d+);", src).group(1))
    assert n_cols == len(SegmentTable.COLUMNS) == fu.SEGMENT_PIECE_COLS
    threads = int(re.search(r"constexpr int kThreads = (\d+);", head).group(1))
    assert re.search(r"constexpr int64_t kChunk = static_cast<int64_t>"
                     r"\(kThreads\) \* 4;", src)
    assert threads * 4 == fu.SEGMENT_CHUNK
    slots = int(re.search(r"constexpr int kSlots = (\d+);", src).group(1))
    assert slots == fu.SEGMENT_SLOTS
    pk, segs, _ = _segment_inputs("hybrid", (2,))
    t = pk.kernel_table((2,), "cpu", fu.SEGMENT_CHUNK)
    assert tuple(t.pieces.shape) == (t.n_pieces, n_cols)
    assert t.pieces.dtype == torch.int64


# leaves whose sizes are not multiples of 4, two of them longer than a chunk
# and cut across chunks, with 3-d and 4-d ones (native in a hybrid state)
ODD_SHAPES = {"a.weight": (3, 5), "b.bias": (7,), "c.weight": (2, 3, 3, 3),
              "d.weight": (3, 1, 347), "e.bias": (1,), "f.weight": (2, 1031),
              "g.weight": (5, 7, 1, 61), "h.scale": (10,)}


def _shapes(which):
    if which == "odd":
        return ODD_SHAPES
    return {k: tuple(v.shape) for k, v in
            models.ResNet(depth=20).params().items()}


@pytest.mark.parametrize("which,packing,n_segments", [
    ("resnet20", "hybrid", 22), ("resnet20", "segmented", 65),
    ("odd", "hybrid", 4), ("odd", "segmented", 8)])
@pytest.mark.parametrize("K", [1, 3])
def test_table_pieces_cover_each_element_once(which, packing, n_segments, K):
    """every (chain, flat element) in exactly one piece; no piece crosses a
    run (a leaf) or a chunk; each piece's flat start and buffer positions
    those of the packer's own flat map, and its M the leaf's for its chain
    (the preconditioner filled with one value a chain and leaf)"""
    shapes = _shapes(which)
    pk = make_packer(packing, {k: torch.zeros(s) for k, s in shapes.items()})
    assert pk.n_segments == n_segments
    lead = (K,) if K > 1 else ()
    t = pk.kernel_table(lead, "cpu", fu.SEGMENT_CHUNK)
    rows = t.pieces.numpy()
    flat, count, x, xs, p, ps, pe, leaf = rows.T
    assert (count >= 1).all() and (np.diff(flat) > 0).all()  # flat order
    assert (flat[1:] == flat[:-1] + count[:-1]).all()
    assert flat[0] == 0 and flat[-1] + count[-1] == pk.total
    assert (flat >= pk.offsets[leaf]).all()
    assert (flat + count <= pk.offsets[leaf + 1]).all()
    chunk = fu.SEGMENT_CHUNK
    assert (flat // chunk == (flat + count - 1) // chunk).all()
    # the packer's map from the base to the flat (K, flat_padded) bank
    idx, real = pk._flat_map(lead, "cpu")
    expect = np.full(K * pk.flat_padded, -1, np.int64)
    expect[idx[real].numpy()] = np.flatnonzero(real.numpy())
    expect = expect.reshape(K, pk.flat_padded)[:, :pk.total]
    got = np.zeros((K, pk.total), np.int64)
    for f, n, x0, s in zip(flat, count, x, xs):
        got[:, f:f + n] = x0 + np.arange(K)[:, None] * s + np.arange(n)
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(t.x_index.numpy(), expect)
    # M: chain k of leaf l holds 1000·k + l
    scalars = torch.as_tensor(1000.0 * np.arange(K)[:, None]
                              + np.arange(pk.n_leaves)).reshape(
        *lead, pk.n_leaves)
    M = pk.expand(scalars).base.numpy()
    assert len(M) == t.pre_length
    leaf_of = np.repeat(np.arange(pk.n_leaves), pk.sizes)
    pos = np.zeros((K, pk.total), np.int64)
    for f, n, p0, s, e in zip(flat, count, p, ps, pe):
        pos[:, f:f + n] = p0 + np.arange(K)[:, None] * s + e * np.arange(n)
    np.testing.assert_array_equal(
        M[pos], 1000.0 * np.arange(K)[:, None] + leaf_of)
    np.testing.assert_array_equal(t.p_index.numpy(), pos)
    vector = pe[np.searchsorted(flat, np.arange(pk.total), "right") - 1] == 1
    assert len(np.unique(pos[:, vector])) == K * vector.sum()


@pytest.mark.parametrize("packing", ["hybrid", "segmented"])
@pytest.mark.parametrize("sms", [132, 8])
def test_segment_grid_keeps_the_groups_at_every_k(packing, sms, monkeypatch):
    """the launch's groups (the partials' order) depend on the table and
    the card, not on K; every group has a block, no block more than
    SEGMENT_SLOTS groups, and the blocks over all chains stay near the
    flat kernel's WAVES a multiprocessor"""
    dev = torch.device("cuda", 7)  # a device index only: no card is asked
    monkeypatch.setitem(fu._sm_count, dev.index, sms)
    pk = make_packer(packing, {k: torch.zeros(s) for k, s in
                               _shapes("resnet20").items()})
    t = pk.kernel_table((), "cpu", fu.SEGMENT_CHUNK)
    groups = {}
    for K in (1, 3, 8, 100, fu.MAX_CHAINS):
        n_groups, nb = fu.segment_grid(t, dev, K)
        groups[K] = n_groups
        assert n_groups == min(t.n_pieces, fu.WAVES * sms)
        assert 1 <= nb <= n_groups and nb * fu.SEGMENT_SLOTS >= n_groups
        assert nb * K <= max(fu.WAVES * sms + K,
                             K * -(-n_groups // fu.SEGMENT_SLOTS))
    assert len(set(groups.values())) == 1
    assert fu.segment_grid(t, dev, 1)[1] == groups[1]  # a block a group
