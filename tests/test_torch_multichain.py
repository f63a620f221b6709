"""The chain axis as a whole: the port's `MultiChainRunnerReject` (K GGMC
chains with exact M-H boundaries in one (K, T) bank) against the JAX
package's `MultiChainRunnerReject(packing="flat")`, against the port's own
single-chain runner, and on its own (per-chain M-H, NaN quarantine,
distribution preservation, bf16 compute).

The JAX reference runs once per module (`jax_run`), on K=3 chains of a
depth-8 ResNet with the f64-statistics batchnorm of test_torch_models.py,
and the tests that read it share that run, as they share the port's run
from its start (`port_run`).
"""
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxMultiReject
from bnn_priors_tpu_torch import models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.interop import load_jax_chains, load_jax_state
from bnn_priors_tpu_torch.ops import fused_update
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_models import (_jax_resnet,  # noqa: F401
                              answer_init, torch_threads_per_worker)

# 4 full batches, no tail. The JAX reference's time here is mostly running
# the vmapped f64 ResNet on XLA's CPU backend, so its data is kept small.
K, N_TRAIN, N_TEST, BATCH = 3, 64, 16, 16
RUN = dict(learning_rate=1e-3, momentum=0.9, batch_size=BATCH, cycles=1,
           epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
           precond_update=1)


def _chain_inits(dtype):
    """K He inits as numpy (params, state) in `dtype`, one generator a
    chain. The port makes them (the names are the JAX package's): a JAX
    init costs seconds of eager dispatch, and what these tests carry across
    is the JAX runner's chain state (`load_jax_chains`)."""
    model = models.ResNet(depth=8).to(torch.float64)
    cast = lambda v: v.numpy().astype(dtype) if v.is_floating_point() \
        else v.numpy()
    out = []
    for c in range(K):
        he_initialize(model, torch.Generator().manual_seed(c))
        out.append(({k: cast(v.detach()) for k, v in model.params().items()},
                    {k: cast(v) for k, v in model.named_buffers()}))
    return out


def _orders(seed=7):
    "(K, n_full, B): one fixed minibatch order a chain"
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(N_TRAIN).reshape(-1, BATCH)
                     for _ in range(K)])


def _port_runner(temperatures=0.0, seed=0, dtype=torch.float64, **kw):
    data = FakeCIFAR10(dtype="float64" if dtype == torch.float64
                       else "float32", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    model = models.ResNet(depth=8).to(dtype)
    args = dict(RUN, **kw)
    return MultiChainRunnerReject(model, data.norm.train, K,
                                  temperatures=temperatures,
                                  test_data=data.norm.test, seed=seed,
                                  device="cpu", **args)


@pytest.fixture(scope="module")
def jax_run():
    """the JAX K-chain runner at T=0 from three He-initialised chains, run
    once: its initial state, its per-epoch entries and the runner"""
    inits = _chain_inits(np.float64)
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    mp = pytest.MonkeyPatch()
    try:
        jm = _jax_resnet(8, mp)
    finally:
        mp.undo()
    # the runner asks the model's init only for its template batchnorm
    # state: answered with the port's (JAX's init compiles a sampler a
    # leaf shape)
    answer_init(jm, *inits[0])
    jr = JaxMultiReject(
        jm, jdata.norm.train, n_chains=K, temperatures=0.0,
        key=jax.random.key(0), dtype=jnp.float64, packing="flat",
        init_params_fn=lambda i, key: {k: jnp.asarray(v)
                                       for k, v in inits[i][0].items()},
        test_data=jdata.norm.test, **RUN)
    orders = jnp.asarray(_orders())
    jr._epoch_idxs = lambda cycle=0, epoch=0: orders
    start = (np.asarray(jr.states.position).copy(),
             {k: np.asarray(v).copy() for k, v in jr.model_states.items()})
    history = jr.run()
    return start, history, jr


def _port_from(start, **kw):
    "the port's runner started from the JAX runner's initial chains"
    tr = _port_runner(**kw)
    load_jax_chains(tr, *start)
    orders = torch.as_tensor(_orders())
    tr._epoch_idxs = lambda cycle=0, epoch=0: orders
    return tr


@pytest.fixture(scope="module")
def port_run(jax_run):
    """the port's runner from the JAX run's start, run once a module: the
    runner, its per-epoch entries and the `(K, T)` launches it made"""
    tr = _port_from(jax_run[0])
    before = fused_update.chain_launches
    thist = tr.run()
    return tr, thist, fused_update.chain_launches - before


def test_multichain_matches_jax_step_for_step(jax_run, port_run):
    """T=0, f64: per-chain epoch entries (potential, acc, tempering
    diagnostics, test metrics), boundary ΔE/decisions/exact metrics, final
    parameters and batchnorm state, and the sample bank, at rtol 1e-8"""
    _, jhist, jr = jax_run
    tr, thist, launches = port_run
    assert tr.kernel.packer.names == jr.kernel.packer.names
    assert launches == 0  # the CPU runs plain code
    close = lambda ours, theirs, what: np.testing.assert_allclose(
        ours, np.asarray(theirs), rtol=1e-8, atol=1e-12, err_msg=what)
    assert len(thist) == len(jhist) == 2
    for e, (t, j) in enumerate(zip(thist, jhist)):
        assert set(t) == set(j) >= {"potential", "test/acc", "test/loss"}
        for k in j:
            close(t[k], j[k], f"epoch {e} {k}")
    assert len(tr.delta_energies) == len(jr.delta_energies) == 1
    for b in range(1):
        close(tr.delta_energies[b], jr.delta_energies[b], "delta_energy")
        np.testing.assert_array_equal(tr.rejections[b], jr.rejections[b])
        for k, v in jr.boundary_metrics[b].items():
            close(tr.boundary_metrics[b][k], v, "exact " + k)
    close(tr.chains.position.numpy(), jr.states.position, "position")
    for k, v in jr.model_states.items():
        close(tr.buffers[k].numpy(), v, k)
    ts, js = tr.get_samples(), jr.get_samples()
    assert set(ts) == set(js)
    for k in js:
        assert ts[k].shape[:2] == (1, K)
        close(ts[k], js[k], "sample " + k)


def test_each_chain_is_a_single_chain_run(jax_run, port_run):
    """chain k of the K-chain run is the single-chain runner from chain k's
    init and order (T=0, N a multiple of the batch: no tail in either)"""
    tr = port_run[0]
    pos0, bufs0 = jax_run[0]
    for k in range(K):
        data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                           device="cpu")
        model = models.ResNet(depth=8).to(torch.float64)
        params = tr.kernel.packer.unpack(torch.as_tensor(pos0[k]))
        load_jax_state(model, {n: v.numpy() for n, v in params.items()},
                       {n: v[k] for n, v in bufs0.items()})
        sr = VerletSGLDRunnerReject(model, data.norm.train, data.norm.test,
                                    temperature=0.0, reject_samples=True,
                                    device="cpu", **RUN)
        order = _orders()[k].reshape(-1)
        sr._epoch_perm = lambda cycle, epoch: order
        sr.run()
        np.testing.assert_allclose(
            np.concatenate(tr.potentials)[:, k], sr.potentials, rtol=1e-9)
        np.testing.assert_allclose(
            [d[k] for d in tr.delta_energies],
            [b["delta_energy"] for b in sr.boundaries], rtol=1e-9)
        np.testing.assert_allclose(tr.chains.position[k].numpy(),
                                   sr.chain.position.numpy(), rtol=1e-9,
                                   atol=1e-12)
        for n, v in sr.model.named_buffers():
            np.testing.assert_allclose(tr.buffers[n][k].numpy(), v.numpy(),
                                       rtol=1e-9, atol=1e-12)


def test_per_chain_metropolis_hastings_and_nan_quarantine():
    """one run with a T=0 chain and T=1 chains at a step size that makes
    M-H reject; a NaN chain is quarantined with a warning and dropped from
    the bank while the others go on"""
    tr = _port_runner(temperatures=[0.0, 1.0, 1.0], seed=1,
                      learning_rate=0.05, epochs_per_cycle=2,
                      warmup_epochs=0, sample_epochs=2)
    with torch.no_grad():
        tr.chains.position[2, :100] = float("nan")
    with pytest.warns(UserWarning, match="chain 2"):
        hist = tr.run()
    assert tr.nan_chains == {2}
    rej = np.stack(tr.rejections)
    assert rej.shape == (2, K) and not rej[:, 0].any()  # T=0 never rejects
    assert rej[:, 1].any()  # the step size is far too large for T=1
    assert np.all(np.isfinite(np.stack(tr.delta_energies)[:, :2]))
    for e in hist:
        assert np.all(np.isfinite(e["potential"][:2]))
        assert np.isnan(e["potential"][2])
        assert np.all((0 <= e["test/acc"][:2]) & (e["test/acc"][:2] <= 1))
    with pytest.warns(UserWarning, match="dropping diverged chains"):
        bank = tr.get_samples()
    assert bank["net.0.weight_prior.p"].shape[:2] == (2, 2)
    assert all(np.all(np.isfinite(v)) for v in bank.values())
    assert tr.get_samples(drop_nan_chains=False)[
        "net.0.weight_prior.p"].shape[:2] == (2, K)
    with pytest.raises(ValueError, match="diverged"):
        tr.chain_samples(2)
    np.testing.assert_allclose(tr.acceptance_rates(),
                               1.0 - rej.mean(axis=0))


def test_rejection_restores_only_its_own_chain():
    """at each boundary a rejected chain's position is its position at the
    segment's start, and an accepting chain's is not"""
    tr = _port_runner(temperatures=[1.0, 0.0, 1.0], seed=2,
                      learning_rate=0.05, epochs_per_cycle=2,
                      warmup_epochs=0, sample_epochs=2)
    starts, real = [], tr.kernel.initial_step

    def spy(state, *args, **kw):
        starts.append(state.position.clone())
        return real(state, *args, **kw)
    tr.kernel.initial_step = spy
    tr.run()
    bank = tr.get_samples(drop_nan_chains=False)
    pos = np.stack([s[0] for s in tr._samples])  # (n_samples, K, T)
    assert len(starts) == 3 and bank["net.0.weight_prior.p"].shape[0] == 2
    seen = set()
    for b, rejected in enumerate(tr.rejections):
        for k in range(K):
            same = np.array_equal(pos[b, k], starts[b][k].numpy())
            assert same == bool(rejected[k]), (b, k)
            seen.add(bool(rejected[k]))
    assert seen == {True, False}


def test_fixed_minibatch_order_per_cycle():
    "every epoch of a cycle visits the data in the chain's same order"
    tr = _port_runner(cycles=2)
    i00 = tr._epoch_idxs(cycle=0, epoch=0).clone()
    i01 = tr._epoch_idxs(cycle=0, epoch=1)
    i10 = tr._epoch_idxs(cycle=1, epoch=0)
    assert i00.shape == (K, N_TRAIN // BATCH, BATCH)
    assert torch.equal(i00, i01) and not torch.equal(i00, i10)
    assert not torch.equal(i00[0], i00[1])
    assert sorted(i00[0].reshape(-1).tolist()) == list(range(N_TRAIN))


@pytest.mark.parametrize("seed", [0, 3])
def test_multichain_is_reproducible(seed):
    "same seed, same run at T=1: no hidden global random state"
    runs = []
    for _ in range(2):
        tr = _port_runner(temperatures=1.0, seed=seed, epochs_per_cycle=1,
                          warmup_epochs=0)
        hist = tr.run()
        runs.append((hist[-1]["potential"], tr.delta_energies[0],
                     tr.chains.position.clone()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    assert not torch.equal(runs[0][2][0], runs[0][2][1])


def test_distribution_preservation_with_rejection(seed=4):
    """tests/test_multichain_reject.py:56-82 on the port: 6 chains of GGMC
    with exact M-H started at the exact Gaussian posterior stay there (KS
    on the last snapshot pooled over chains), with a healthy acceptance
    rate. The port draws other random numbers than JAX, so its seed is its
    own. Calibration (`python tests/test_torch_multichain.py 40` from the
    repo root, with it and tests/ on PYTHONPATH, CPU f64, seeds 0-39):
    acceptance>0.6 40/40, 0<rejections<0.4 40/40, ks_p>0.01 40/40."""
    checks = _distribution_checks(seed)
    for name, ok in checks.items():
        assert ok, f"{name} failed (seed={seed})"


def _distribution_checks(seed):
    model = models.GaussianModel(N=8, D=40, mean=1.0, std=2.0).to(
        torch.float64)
    x = torch.zeros((1, 1), dtype=torch.float64)
    y = torch.zeros((1,), dtype=torch.int64)
    runner = MultiChainRunnerReject(
        model, (x, y), n_chains=6, temperatures=1.0, learning_rate=0.5,
        momentum=0.9, sampling_decay="flat", batch_size=1, cycles=30,
        epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1, seed=seed,
        device="cpu")
    runner.run()
    acc = runner.acceptance_rates()
    rej = np.stack(runner.rejections).mean()
    bank = runner.get_samples()  # leaves "0.p".."7.p": (n_samples, K, D)
    last = np.concatenate([v[-1].ravel() for v in bank.values()])
    cdf = lambda v: scipy.stats.norm.cdf(v, loc=1.0, scale=2.0)
    return {"acceptance>0.6": acc.shape == (6,) and acc.mean() > 0.6,
            "0<rejections<0.4": 0.0 < rej < 0.4,
            "ks_p>0.01": scipy.stats.ks_1samp(last, cdf).pvalue > 0.01}


def test_bf16_chain_potentials_match_jax():
    """compute_dtype=bfloat16 on the chain axis: each chain's minibatch
    potential against `jax.vmap` of the JAX model's bf16 path (rtol 5e-2,
    as the single-chain bf16 test); the network really ran in bf16"""
    inits = _chain_inits(np.float32)
    jm = _jax_resnet(8)
    rng = np.random.RandomState(1)
    x = rng.randn(K, 8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (K, 8))
    stack = lambda i: {k: np.stack([inits[c][i][k] for c in range(K)])
                       for k in inits[0][i]}
    params, state = stack(0), stack(1)
    jpot = jax.jit(jax.vmap(lambda p, s, xb, yb: jm.potential_avg(
        p, s, xb, yb, 1000.0, train=True, compute_dtype=jnp.bfloat16)[0]))(
        *(jax.tree_util.tree_map(jnp.asarray, a) for a in (params, state)),
        jnp.asarray(x), jnp.asarray(y))
    tm = models.ResNet(depth=8)
    ours = {}
    for cd in (torch.bfloat16, None):
        bufs = {k: torch.as_tensor(v.copy()) for k, v in state.items()}
        with torch.no_grad():
            pot, _ = tm.potential_avg_fn(
                torch.as_tensor(x), torch.as_tensor(y), 1000.0, train=True,
                compute_dtype=cd, buffers=bufs)(
                {k: torch.as_tensor(v) for k, v in params.items()})
        ours[cd] = pot.numpy()
    assert ours[torch.bfloat16].shape == (K,)
    np.testing.assert_allclose(ours[torch.bfloat16], np.asarray(jpot),
                               rtol=5e-2)
    assert np.all(ours[torch.bfloat16] != ours[None])


def test_chain_axis_entry_points():
    """the chain axis imports no JAX; its runner runs on the card unless
    asked for the CPU, and takes dispatch groups that divide its chains"""
    code = ("import sys, bnn_priors_tpu_torch.parallel, "
            "bnn_priors_tpu_torch.inference, bnn_priors_tpu_torch.interop; "
            "assert 'jax' not in sys.modules and "
            "'bnn_priors_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    data = FakeCIFAR10(n_train=8, n_test=2, device="cpu")
    model = models.ResNet(depth=8)
    grouped = MultiChainRunnerReject(model, data.norm.train, 4,
                                     batch_size=4, chain_group_size=2,
                                     device="cpu")
    assert grouped._groups() == [(0, 2), (2, 4)]
    with pytest.raises(ValueError, match="chain_group_size"):
        MultiChainRunnerReject(model, data.norm.train, 2, batch_size=4,
                               chain_group_size=3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiChainRunnerReject(model, data.norm.train, 2, batch_size=4)


if __name__ == "__main__":
    # seed calibration of test_distribution_preservation_with_rejection
    from collections import defaultdict
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    wins, passing = defaultdict(int), []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in range(n):
            checks = _distribution_checks(s)
            for name, ok in checks.items():
                wins[name] += int(ok)
            if all(checks.values()):
                passing.append(s)
    for name, w in wins.items():
        print(f"{name:18s} {w}/{n}")
    print("seeds passing all:", passing)
