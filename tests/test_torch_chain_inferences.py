"""Every inference on the chain axis: the port's `MultiChainRunner` (the
plain loop with the SGLD, VerletSGLD and HMC kernels: `inference=SGLD`,
`VerletSGLD`, `OurHMC`) and `MultiChainRunnerReject` with the SGLD and HMC
kernels (`SGLDReject`, `HMCReject` and, at the batch size N with the M-H
test on, classical `HMC`) against the JAX package's runners of the same
kernel, step for step in f64 (rtol 1e-8), on K=3 chains of a depth-8
ResNet with the f64-statistics batchnorm of test_torch_models.py.

Both sides start from the same chains (`load_jax_chains`), visit the data
in the same order (a fresh one a chain each epoch, injected into both),
and log through recording metrics savers. The SGLD-family cases run at
T=0, where no noise enters; HMC's only noise is the momentum refresh, so
both sides' `sample_momentum` return the same numpy draws in the order the
runners ask for them (the JAX reject runner draws inside a jitted vmap,
through a host callback). The JAX runs are made once a module
(`jax_runs`), and so are the port's chain runs from their starts
(`port_runs`), which the step-for-step and the single-chain comparisons
share. The cases differ in `eval_skip` (0, 1 and 2), so the test
rows of each cadence are held to JAX's, and all run the preconditioner
every second epoch, which tells the plain loop's `epoch % 2 == 0` from the
reject loop's `(epoch + 1) % 2 == 0`.

Further: each chain of the bank equals the port's single-chain runner of
its kernel (or, for the plain VerletSGLD and HMC loops, whose single-chain
runners take boundary steps the chain loop does not take, in the JAX
package as here, a one-chain bank); dispatch groups give the ungrouped run
bit for bit; and a checkpoint resumes every chain form bit for bit.

The cases are spread over files so that no one file holds a test worker
for long (each inference's JAX and port runs are made once in the file
that holds its cases): this file holds classical HMC (with the orders
and eval_skip), test_torch_chain_inferences_hmc.py OurHMC and HMCReject,
test_torch_chain_inferences_sgld.py SGLD and SGLDReject (with the hybrid
bank), test_torch_chain_inferences_verlet.py VerletSGLD (with the bitwise
resume of every chain form) and test_torch_chain_groups.py the dispatch
groups. The other files import this one's helpers and fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.parallel import MultiChainRunner as JaxPlain
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxReject
from bnn_priors_tpu_torch import mcmc, models
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.inference import (HMCRunnerReject, SGLDRunner,
                                            SGLDRunnerReject)
from bnn_priors_tpu_torch.interop import (load_jax_chains,
                                          load_jax_checkpoint, load_jax_state)
from bnn_priors_tpu_torch.ops import fused_update
from bnn_priors_tpu_torch.parallel import (MultiChainRunner,
                                           MultiChainRunnerReject)

from test_torch_models import (_jax_resnet,  # noqa: F401
                              answer_init, torch_threads_per_worker)
from test_torch_multichain import _chain_inits

K, N_TRAIN, N_TEST, BATCH = 3, 64, 16, 16
EPOCHS = 3
RUN = dict(cycles=1, epochs_per_cycle=EPOCHS, warmup_epochs=1,
           sample_epochs=2, precond_update=2, sampling_decay="cosine")
# inference -> (reject runner?, kernel, temperature, run arguments)
CASES = {
    "SGLD": (False, "SGLD", 0.0, dict(learning_rate=1e-3, momentum=0.0,
                                      eval_skip=2)),
    "VerletSGLD": (False, "VerletSGLD", 0.0,
                   dict(learning_rate=1e-3, momentum=0.9, eval_skip=0)),
    "OurHMC": (False, "HMC", 1.0, dict(learning_rate=1e-5, eval_skip=1)),
    "SGLDReject": (True, "SGLD", 0.0, dict(learning_rate=1e-3, momentum=0.9,
                                           eval_skip=2)),
    "HMCReject": (True, "HMC", 1.0, dict(learning_rate=1e-5, eval_skip=0,
                                         reject_samples=False)),
    "HMC": (True, "HMC", 1.0, dict(learning_rate=1e-5, eval_skip=1,
                                   batch_size=N_TRAIN, reject_samples=True)),
}
CLOSE = dict(rtol=1e-8, atol=1e-12)
# HMC's ΔE cancels the kinetic energies ½‖m‖² (~4e4 here): it is held to
# 1e-12 of them, ~16x the rounding of a sum over the bank's 78k elements
# (as test_torch_hmc.py holds it to its rtol of ½‖m₀‖²)
ENERGY_ROWS = ("delta_energy", "total_energy")


class ChainRecorder:
    """a metrics saver that keeps every value, keyed by (name, step); the
    chain runners write their step series in blocks (`add_rows`)"""

    def __init__(self):
        self.rows = {}

    def add_scalar(self, name, value, step):
        assert (name, step) not in self.rows, (name, step)
        self.rows[(name, int(step))] = float(value)

    def add_rows(self, columns, steps):
        for name, values in columns.items():
            for v, s in zip(np.asarray(values), steps):
                self.add_scalar(name, v, s)

    def flush(self, **kw):
        pass

    def logged(self):
        "the rows, without the wall-clock timings"
        return {k: v for k, v in self.rows.items()
                if not k[0].startswith("timings/")}


def _orders(batch):
    "(EPOCHS, K, n_full, B): a fresh minibatch order a chain each epoch"
    rng = np.random.RandomState(7)
    n_full = N_TRAIN // batch
    return np.stack([np.stack([rng.permutation(N_TRAIN)[:n_full * batch]
                               .reshape(n_full, batch) for _ in range(K)])
                     for _ in range(EPOCHS)])


def _draws(T, total, n=6):
    "(n, K, T) momentum draws, padding tail zero"
    out = np.random.RandomState(11).standard_normal((n, K, T))
    out[..., total:] = 0.0
    return out


def _run_args(name):
    reject, kernel, temp, kw = CASES[name]
    args = {**RUN, "batch_size": BATCH, **kw}
    if not reject:
        args.pop("reject_samples", None)
    return reject, kernel, temp, args


def _patch_jax_momentum(mp, jr, draws):
    """the JAX runner's momentum refreshes return the next (K, T) draws:
    `_sample_momentum_all` directly, the HMC kernel's `sample_momentum`
    (vmapped inside the reject runner's jit) through a host callback"""
    it = iter(draws)

    def take(shape):
        return np.asarray(next(it)).reshape(shape)

    jr._sample_momentum_all = lambda: jr.states._replace(
        momentum=jnp.sqrt(jr.temperatures)[:, None]
        * jnp.asarray(take((K, -1))))

    def sample(self, state, temperature, keep=0.0):
        m = jax.pure_callback(
            lambda mm: take(mm.shape),
            jax.ShapeDtypeStruct(state.momentum.shape, state.momentum.dtype),
            state.momentum, vmap_method="broadcast_all")
        return state._replace(momentum=jnp.sqrt(temperature) * m)
    mp.setattr(jax_mcmc.HMC, "sample_momentum", sample)


def _patch_port_momentum(mp, draws, row=None):
    """the port's momentum refreshes return the next draws: all K rows for
    the chain forms, row `row` for a single chain"""
    it = iter(draws)

    def chains(self, state, temperature):
        m = torch.as_tensor(next(it), dtype=state.momentum.dtype)
        state.momentum = torch.sqrt(temperature)[:, None] * m
        return state

    def single(self, state, temperature, keep=0.0):
        m = torch.as_tensor(next(it)[row], dtype=state.momentum.dtype)
        state.momentum = temperature ** 0.5 * m
        return state
    mp.setattr(mcmc.HMCChains, "sample_momentum", chains)
    mp.setattr(mcmc.HMC, "sample_momentum", single)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """jax_runs(name): the JAX chain runner of that inference, run once a
    module: its initial chains, per-epoch entries, recorded rows, the
    runner and its final checkpoint"""
    inits = _chain_inits(np.float64)
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    runs = {}

    def run(name):
        if name in runs:
            return runs[name]
        reject, kernel, temp, args = _run_args(name)
        mp = pytest.MonkeyPatch()
        try:
            jm = _jax_resnet(8, mp)
            answer_init(jm, *inits[0])
            rec = [ChainRecorder() for _ in range(K)]
            cls = JaxReject if reject else JaxPlain
            jr = cls(jm, jdata.norm.train, n_chains=K, temperatures=temp,
                     kernel=kernel, key=jax.random.key(0), dtype=jnp.float64,
                     packing="flat", pipeline=False,
                     init_params_fn=lambda i, key: {
                         k: jnp.asarray(v) for k, v in inits[i][0].items()},
                     test_data=jdata.norm.test, metrics_savers=rec, **args)
            orders = jnp.asarray(_orders(args["batch_size"]))
            jr._epoch_idxs = lambda cycle=0, epoch=0: orders[
                cycle * EPOCHS + epoch]
            pk = jr.kernel.packer
            if kernel == "HMC":
                _patch_jax_momentum(mp, jr, _draws(pk.total_padded,
                                                   pk.total))
            start = (np.asarray(jr.states.position).copy(),
                     {k: np.asarray(v).copy()
                      for k, v in jr.model_states.items()})
            history = jr.run()
            ckpt = tmp_path_factory.mktemp("jax_ckpt") / "chains.ckpt.npz"
            jr.save_checkpoint(str(ckpt), EPOCHS, EPOCHS * (N_TRAIN // args[
                "batch_size"]))
        finally:
            mp.undo()
        runs[name] = (start, history, rec, jr, ckpt)
        return runs[name]
    return run


def _port_runner(name, cls=None, n_chains=K, **kw):
    "the port's runner of the inference `name`, on the CPU in f64"
    reject, kernel, temp, args = _run_args(name)
    temp = kw.pop("temperatures", temp)
    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    model = models.ResNet(depth=8).to(torch.float64)
    cls = cls or (MultiChainRunnerReject if reject else MultiChainRunner)
    return cls(model, data.norm.train, n_chains, temperatures=temp,
               kernel=kernel, test_data=data.norm.test, device="cpu",
               **dict(args, **kw))


def _port_from(name, start, mp, **kw):
    """the port's runner started from the JAX runner's initial chains, with
    the same orders (and momentum draws)"""
    tr = _port_runner(name, **kw)
    load_jax_chains(tr, *start)
    orders = torch.as_tensor(_orders(tr.batch_size))
    tr._epoch_idxs = lambda cycle=0, epoch=0: orders[cycle * EPOCHS + epoch]
    if tr.kernel_name == "HMC":
        pk = tr.kernel.packer
        _patch_port_momentum(mp, _draws(pk.total_padded, pk.total))
    return tr


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """port_runs(name): the port's runner of that inference from the JAX
    run's start, run once a module: the runner, its per-epoch entries, its
    recorders and the `(K, T)` launches the run made"""
    runs = {}

    def run(name):
        if name not in runs:
            start = jax_runs(name)[0]
            trec = [ChainRecorder() for _ in range(K)]
            with pytest.MonkeyPatch.context() as mp:
                tr = _port_from(name, start, mp, metrics_savers=trec)
                before = fused_update.chain_launches
                thist = tr.run()
            runs[name] = (tr, thist, trec,
                          fused_update.chain_launches - before)
        return runs[name]
    return run


def _close(ours, theirs, what):
    np.testing.assert_allclose(ours, np.asarray(theirs), err_msg=what,
                               **CLOSE)


# this file's inferences (the others: see the module docstring)
NAMES = ("HMC",)


@pytest.mark.parametrize("name", NAMES)
def test_chain_runner_matches_jax_step_for_step(jax_runs, port_runs, name):
    check_step_for_step(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_each_chain_is_a_single_chain_run(jax_runs, port_runs, name):
    check_single_chains(jax_runs, port_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_jax_chain_checkpoint_loads(jax_runs, name):
    check_jax_checkpoint(jax_runs, name)


def check_step_for_step(jax_runs, port_runs, name):
    """per-chain epoch entries, every recorded row (step series, test rows
    at the case's eval_skip, M-H boundary rows), the final bank, momenta,
    batchnorm state and the sample bank, at rtol 1e-8"""
    _, jhist, jrec, jr, _ = jax_runs(name)
    tr, thist, trec, launches = port_runs(name)
    close_e = CLOSE
    if tr.kernel_name == "HMC":
        pk = tr.kernel.packer
        kinetic = 0.5 * (_draws(pk.total_padded, pk.total) ** 2).sum(-1)
        close_e = dict(CLOSE, atol=1e-12 * kinetic.max())
    assert tr.kernel.packer.names == jr.kernel.packer.names
    assert launches == 0  # the CPU runs plain code
    assert len(thist) == len(jhist) == EPOCHS
    for e, (t, j) in enumerate(zip(thist, jhist)):
        # the JAX granular entry also carries loss, log_prior and lr, which
        # both sides log as rows
        assert set(t) <= set(j) and "potential" in t, (set(t), set(j))
        for k in t:
            _close(t[k], j[k], f"epoch {e} {k}")
    eval_skip = _run_args(name)[3]["eval_skip"]
    test_rows = {s for (n, s) in jrec[0].rows if n == "test/acc"}
    n_full = N_TRAIN // tr.batch_size
    assert test_rows == {n_full * (e + 1) - 1 for e in range(EPOCHS)
                         if eval_skip and ((e + 1) % eval_skip == 0
                                           or e == EPOCHS - 1)}
    for c in range(K):
        ours, theirs = trec[c].logged(), jrec[c].logged()
        assert set(ours) == set(theirs), set(ours) ^ set(theirs)
        bad = {k: (ours[k], theirs[k]) for k in sorted(theirs)
               if not np.isclose(ours[k], theirs[k], equal_nan=True,
                                 **(close_e if k[0] in ENERGY_ROWS
                                    else CLOSE))}
        assert not bad, (c, list(bad.items())[:5])
    if isinstance(tr, MultiChainRunnerReject):
        assert len(tr.delta_energies) == len(jr.delta_energies) == 2
        for b in range(2):
            np.testing.assert_allclose(tr.delta_energies[b],
                                       jr.delta_energies[b], err_msg="ΔE",
                                       **close_e)
            np.testing.assert_array_equal(tr.rejections[b],
                                          jr.rejections[b])
            assert not np.any(tr.rejections[b])  # sure outcomes only
            for k, v in jr.boundary_metrics[b].items():
                _close(tr.boundary_metrics[b][k], v, "exact " + k)
    _close(tr.chains.position.numpy(), jr.states.position, "position")
    _close(tr.chains.momentum.numpy(), jr.states.momentum, "momentum")
    for k, v in jr.model_states.items():
        _close(tr.buffers[k].numpy(), v, k)
    ts, js = tr.get_samples(), jr.get_samples()
    assert set(ts) == set(js)
    for k in js:
        assert ts[k].shape[:2] == (2, K)
        _close(ts[k], js[k], "sample " + k)


def _single_chain(name, k, start, mp):
    """the port's single-chain runner of `name`'s kernel from chain k's
    start, order and momentum draws"""
    reject, kernel, temp, args = _run_args(name)
    args = {a: v for a, v in args.items() if a != "eval_skip"}
    if kernel == "HMC":
        args["momentum"] = 1.0
    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    model = models.ResNet(depth=8).to(torch.float64)
    pos, bufs = start
    pk = mcmc.Packer(model.params())
    params = pk.unpack(torch.as_tensor(pos[k]))
    load_jax_state(model, {n: v.numpy() for n, v in params.items()},
                   {n: v[k] for n, v in bufs.items()})
    cls = {"SGLD": SGLDRunner, "SGLDReject": SGLDRunnerReject,
           "HMCReject": HMCRunnerReject, "HMC": HMCRunnerReject}[name]
    rec = ChainRecorder()
    sr = cls(model, data.norm.train, data.norm.test, temperature=temp,
             metrics_saver=rec, device="cpu", **args)
    orders = _orders(args["batch_size"])[:, k].reshape(EPOCHS, -1)
    # SGLDRunner ends with one more step, on the order of the next cycle
    sr._epoch_perm = lambda cycle, epoch: orders[
        (cycle * EPOCHS + epoch) % EPOCHS]
    if kernel == "HMC":
        # the chain loop draws twice before its first initial step (the
        # JAX runner's start and its boundary's refresh), the single-chain
        # runner once: it takes the second
        _patch_port_momentum(mp, _draws(pk.total_padded, pk.total)[1:],
                             row=k)
    return sr, rec


def check_single_chains(jax_runs, port_runs, name):
    """chain k of the bank against the single-chain runner of its kernel
    from chain k's start and order (SGLD: the logged minibatch potentials
    and the samples; the reject runners: potentials, ΔE and the final
    state), or, for the plain VerletSGLD and HMC loops, against a bank of
    chain k alone"""
    start = jax_runs(name)[0]
    tr, _, trec, _ = port_runs(name)
    bank = tr.get_samples()
    for k in range(K):
        with pytest.MonkeyPatch.context() as mp:
            if name in ("VerletSGLD", "OurHMC"):
                one = (start[0][k:k + 1], {n: v[k:k + 1]
                                           for n, v in start[1].items()})
                sr = _port_runner(name, n_chains=1)
                load_jax_chains(sr, *one)
                orders = torch.as_tensor(_orders(sr.batch_size))[:, k:k + 1]
                sr._epoch_idxs = lambda cycle=0, epoch=0: orders[
                    cycle * EPOCHS + epoch]
                if sr.kernel_name == "HMC":
                    pk = sr.kernel.packer
                    draws = _draws(pk.total_padded, pk.total)[:, k:k + 1]
                    _patch_port_momentum(mp, draws)
                sr.run()
                np.testing.assert_allclose(
                    np.concatenate(tr.potentials)[:, k],
                    np.concatenate(sr.potentials)[:, 0], rtol=1e-9)
                np.testing.assert_allclose(
                    tr.chains.position[k].numpy(),
                    sr.chains.position[0].numpy(), rtol=1e-9, atol=1e-12)
                continue
            sr, rec = _single_chain(name, k, start, mp)
            sr.run()
        if name == "SGLD":
            # the single chain's run ends with one more logged step
            ours = {s: v for (n, s), v in trec[k].rows.items()
                    if n == "potential"}
            theirs = {s: v for (n, s), v in rec.rows.items()
                      if n == "potential" and s in ours}
            assert set(theirs) == set(ours) and len(ours) == EPOCHS * 4
            np.testing.assert_allclose([ours[s] for s in sorted(ours)],
                                       [theirs[s] for s in sorted(ours)],
                                       rtol=1e-9)
            single = sr.get_samples()
            for n, v in single.items():
                np.testing.assert_allclose(bank[n][:, k], v, rtol=1e-9,
                                           atol=1e-12, err_msg=n)
            continue
        np.testing.assert_allclose(
            np.concatenate(tr.potentials)[:, k], sr.potentials, rtol=1e-9)
        # ΔE: HMC's cancels ½‖m‖² (see ENERGY_ROWS)
        np.testing.assert_allclose(
            [d[k] for d in tr.delta_energies],
            [b["delta_energy"] for b in sr.boundaries], rtol=1e-9,
            atol=1e-12 * 0.5 * float(sr.kernel.packer.total))
        np.testing.assert_allclose(tr.chains.position[k].numpy(),
                                   sr.chain.position.numpy(), rtol=1e-9,
                                   atol=1e-12)
        for n, v in sr.model.named_buffers():
            np.testing.assert_allclose(tr.buffers[n][k].numpy(), v.numpy(),
                                       rtol=1e-9, atol=1e-12)


def check_jax_checkpoint(jax_runs, name):
    """`load_jax_checkpoint` reads the JAX chain state of every kernel,
    with rollback slots (classical HMC) and without, into the port's chain
    form: the vectors, energy accumulators and batchnorm state"""
    _, _, _, jr, ckpt = jax_runs(name)
    tr = _port_runner(name)
    assert load_jax_checkpoint(str(ckpt), tr) == (
        EPOCHS, EPOCHS * (N_TRAIN // tr.batch_size))
    for field in ("position", "momentum", "square_avg", "precond"):
        _close(getattr(tr.chains, field).numpy(),
               getattr(jr.states, field), field)
    has_energy = name not in ("SGLD", "SGLDReject")
    assert hasattr(tr.chains, "delta_energy_acc") == has_energy
    if has_energy:
        _close(tr.chains.delta_energy_acc.numpy(),
               jr.states.delta_energy_acc, "delta_energy_acc")
    assert (getattr(tr.chains, "saved", None) is not None) == (name == "HMC")
    for k, v in jr.model_states.items():
        _close(tr.buffers[k].numpy(), v, k)


def test_plain_orders_are_fresh_each_epoch():
    """the plain loop draws a new permutation a chain each epoch from the
    runner's generator (multichain.py:409-422); the reject loop keeps each
    chain's order through a cycle"""
    tr = _port_runner("SGLD")
    a, b = tr._epoch_idxs(0, 0), tr._epoch_idxs(0, 1)
    assert a.shape == (K, N_TRAIN // BATCH, BATCH)
    assert not torch.equal(a, b) and not torch.equal(a[0], a[1])
    for o in (a, b):
        assert all(sorted(o[c].reshape(-1).tolist()) == list(range(N_TRAIN))
                   for c in range(K))
    again = _port_runner("SGLD")
    assert torch.equal(again._epoch_idxs(0, 0), a)  # from the seed
    rr = _port_runner("SGLDReject")
    assert torch.equal(rr._epoch_idxs(0, 0), rr._epoch_idxs(0, 1))


@pytest.mark.parametrize("eval_skip,due", [(0, []), (1, [0, 1, 2]),
                                           (2, [1, 2]), (None, [])])
def test_eval_skip(eval_skip, due):
    """the test pass every eval_skip epochs and after the last; 0 and None
    turn it off (multichain.py:638-642): the entries and each chain's test
    rows"""
    rec = [ChainRecorder() for _ in range(K)]
    tr = _port_runner("SGLD", eval_skip=eval_skip, metrics_savers=rec)
    hist = tr.run()
    assert [e for e, h in enumerate(hist) if "test/acc" in h] == due
    n_full = N_TRAIN // BATCH
    for r in rec:
        assert sorted(s for (n, s) in r.rows if n == "test/loss") == [
            n_full * (e + 1) - 1 for e in due]
