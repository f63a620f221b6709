"""The port's single-chain runners with `packing="segmented"` and
`"hybrid"` against the JAX package's runners of the same packing, step for
step in f64 at temperature 0 (rtol 1e-8 on every logged number, the final
state and the samples): `VerletSGLDRunnerReject`, `SGLDRunner` and
`HMCRunnerReject` (whose only noise, the momentum refresh, is replaced on
both sides by the same function of the position). The chain axis and the
checkpoints are in test_torch_segmented_chains.py, which shares this
file's model, JAX runs and fixtures.

The model is a prior-only Gaussian model on 32 points whose leaves have
both kinds of segment: two 4-d leaves (native in the hybrid state) and
three small ones (its flat segment). One JAX run per (runner, packing),
cached in a module fixture.

Then the port alone, at temperature 1 with the same seeds: a hybrid and a
segmented run draw the flat run's noise, so ResNet-8's positions agree
with the flat run's to 1e-12; every runner's default is flat.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu import priors as JP
from bnn_priors_tpu.inference.reject import \
    HMCRunnerReject as JaxHMCReject
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxReject
from bnn_priors_tpu.inference.runner import SGLDRunner as JaxSGLD
from bnn_priors_tpu.mcmc.segmented import SegVec as JaxSegVec
from bnn_priors_tpu.models.prior_only import PriorOnlyModel as JaxPriorOnly
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxChains
from bnn_priors_tpu_torch import mcmc, models
from bnn_priors_tpu_torch import priors as TP
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.inference import (HMCRunnerReject, SGLDRunner,
                                            VerletSGLDRunnerReject)
from bnn_priors_tpu_torch.mcmc.segmented import vapply
from bnn_priors_tpu_torch.ops import fused_update
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_models import (answer_init,  # noqa: F401
                               torch_threads_per_worker)
from test_torch_reject_runner import Recorder

RTOL, ATOL = 1e-8, 1e-12
SHAPES = [(4, 3, 3, 3), (6,), (2, 5), (3, 2, 2, 2), (1,)]
N_POINTS, BATCH, K = 32, 16, 3
XY = np.zeros((N_POINTS, 3)), np.zeros(N_POINTS, np.int64)
PERM = np.random.RandomState(7).permutation(N_POINTS)
RUNS = {
    "reject": dict(epochs_per_cycle=3, warmup_epochs=1, sample_epochs=2,
                   cycles=1, learning_rate=1e-2, momentum=0.9,
                   precond_update=1, reject_samples=True, batch_size=BATCH,
                   temperature=0.0),
    "sgld": dict(epochs_per_cycle=3, warmup_epochs=1, sample_epochs=2,
                 cycles=1, learning_rate=1e-2, momentum=0.9,
                 precond_update=1, batch_size=BATCH, temperature=0.0),
    "hmc": dict(epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
                cycles=1, learning_rate=1e-3, momentum=1.0, precond_update=1,
                reject_samples=False, batch_size=BATCH, temperature=1.0),
}
CHAINS = dict(n_chains=K, temperatures=0.0, learning_rate=1e-2, momentum=0.9,
              batch_size=BATCH, cycles=2, epochs_per_cycle=2,
              warmup_epochs=1, sample_epochs=1, precond_update=1)


def _init(seed):
    rng = np.random.RandomState(seed)
    return {f"{i}.p": rng.randn(*s) * 1.5 + 0.5 for i, s in enumerate(SHAPES)}


def jax_model():
    return JaxPriorOnly([JP.Normal(s, 0.0, 1.0) for s in SHAPES])


def port_model():
    return models.PriorOnlyModel(
        [TP.Normal(s, 0.0, 1.0) for s in SHAPES]).to(torch.float64)


def _refresh_by_position(monkeypatch):
    """HMC's momentum refresh, on both sides: m = sqrt(T)·cos(3θ + 1), a
    deterministic function of the position instead of a draw"""
    def jax_sample(self, state, temperature, keep=0.0):
        pos = state.position
        f = lambda x: jnp.sqrt(temperature) * jnp.cos(3.0 * x + 1.0)
        m = JaxSegVec(f(x) for x in pos.leaves) if isinstance(
            pos, JaxSegVec) else f(pos)
        return state._replace(momentum=m)

    def port_sample(self, state, temperature, keep=0.0):
        state.momentum = vapply(
            lambda x: temperature ** 0.5 * torch.cos(3.0 * x + 1.0),
            state.position)
        return state
    monkeypatch.setattr(jax_mcmc.HMC, "sample_momentum", jax_sample)
    monkeypatch.setattr(mcmc.HMC, "sample_momentum", port_sample)


_JAX = {}


@pytest.fixture(scope="module")
def jax_runs():
    """one JAX run a (runner, packing), made at first use: its runner and
    its metric rows"""
    def run(kind, packing):
        if (kind, packing) not in _JAX:
            _JAX[kind, packing] = _jax_run(kind, packing)
        return _JAX[kind, packing]
    yield run
    _JAX.clear()


def _jax_run(kind, packing):
    x, y = XY
    data = (jnp.asarray(x), jnp.asarray(y, jnp.int32))
    if kind == "chains":
        jm = jax_model()
        answer_init(jm, _init(0), {})  # the runner's template state only
        jr = JaxChains(jm, data, key=jax.random.key(7),
                       dtype=jnp.float64, packing=packing,
                       init_params_fn=lambda c, key: {
                           k: jnp.asarray(v) for k, v in _init(c).items()},
                       **CHAINS)
        jr.run()
        return jr, None
    cls = {"reject": JaxReject, "sgld": JaxSGLD, "hmc": JaxHMCReject}[kind]
    rec = Recorder()
    mp = pytest.MonkeyPatch()
    try:
        if kind == "hmc":
            _refresh_by_position(mp)
        jr = cls(jax_model(), data, None, init_params={
            k: jnp.asarray(v) for k, v in _init(0).items()},
            init_model_state={}, key=jax.random.key(0), packing=packing,
            metrics_saver=rec, **RUNS[kind])
        jr._epoch_perm = lambda cycle, epoch: PERM
        jr.run()
    finally:
        mp.undo()
    return jr, rec


def _port_runner(kind, packing):
    x, y = XY
    data = (torch.as_tensor(x), torch.as_tensor(y))
    cls = {"reject": VerletSGLDRunnerReject, "sgld": SGLDRunner,
           "hmc": HMCRunnerReject}[kind]
    model = port_model()
    with torch.no_grad():
        for k, v in _init(0).items():
            model.get_parameter(k).copy_(torch.as_tensor(v))
    tr = cls(model, data, None, metrics_saver=Recorder(), device="cpu",
             packing=packing, **RUNS[kind])
    tr._epoch_perm = lambda cycle, epoch: PERM
    return tr


@pytest.mark.parametrize("packing", ["segmented", "hybrid"])
@pytest.mark.parametrize("kind", ["reject", "sgld", "hmc"])
def test_single_chain_runner_matches_jax_packing(kind, packing, jax_runs,
                                                 monkeypatch):
    jr, jrec = jax_runs(kind, packing)
    if kind == "hmc":
        _refresh_by_position(monkeypatch)
    tr = _port_runner(kind, packing)
    pk = tr.kernel.packer
    assert pk.names == jr.kernel.packer.names
    assert pk.n_segments == {"segmented": 5, "hybrid": 3}[packing]
    assert isinstance(tr.chain.position, mcmc.SegVec)
    before = (fused_update.segments_launches, fused_update.launches)
    tr.run()
    # the CPU takes the plain versions: no launch of either kernel
    assert (fused_update.segments_launches, fused_update.launches) == before

    trec = tr.metrics_saver
    keys = {k for k in jrec.rows if not k[0].startswith("timings/")}
    assert keys == {k for k in trec.rows if not k[0].startswith("timings/")}
    assert {"potential", "est_temperature/all",
            "preconditioner/0.p"} <= {k[0] for k in keys}
    bad = {k: (trec.rows[k], jrec.rows[k]) for k in sorted(keys)
           if not np.isclose(trec.rows[k], jrec.rows[k], rtol=RTOL,
                             atol=ATOL)}
    assert not bad, list(bad.items())[:10]
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    ts, js = tr.get_samples(keep_steps=True), jr.get_samples(keep_steps=True)
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for a, b in zip(tr.chain.momentum.leaves, jr.chain.momentum.leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_every_runner_defaults_to_flat():
    x, y = XY
    data = (torch.as_tensor(x), torch.as_tensor(y))
    for cls in (VerletSGLDRunnerReject, SGLDRunner, HMCRunnerReject):
        kind = {SGLDRunner: "sgld", HMCRunnerReject: "hmc"}.get(cls,
                                                                "reject")
        r = cls(port_model(), data, None, device="cpu", **RUNS[kind])
        assert r.kernel.packing == "flat"
        assert type(r.kernel.packer) is mcmc.Packer
    r = MultiChainRunnerReject(port_model(), data, device="cpu", **CHAINS)
    assert r.kernel.packing == "flat" and torch.is_tensor(r.chains.position)
    with pytest.raises(AssertionError):
        VerletSGLDRunnerReject(port_model(), data, None, device="cpu",
                               packing="tree", **RUNS["reject"])


# -- the port alone: packing is a choice of layout ----------------------------
RESNET_RUN = dict(epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
                  cycles=1, learning_rate=1e-3, momentum=0.9,
                  precond_update=1, reject_samples=True, batch_size=32,
                  temperature=1.0)


@pytest.fixture(scope="module")
def resnet8():
    data = FakeCIFAR10(dtype="float64", n_train=64, n_test=16, device="cpu")
    model = models.ResNet(depth=8).to(torch.float64)
    he_initialize(model, torch.Generator().manual_seed(0))
    return data, model


def test_hybrid_and_segmented_runs_are_the_flat_run(resnet8):
    """T=1, one chain: the same seed gives the flat run's noise, M-H
    decision and positions (to 1e-12) in every packing"""
    data, model = resnet8
    out = {}
    for packing in ("flat", "hybrid", "segmented"):
        r = VerletSGLDRunnerReject(copy.deepcopy(model), data.norm.train,
                                   None, seed=3, device="cpu",
                                   packing=packing, **RESNET_RUN)
        r.run()
        out[packing] = (r.kernel.params_of(r.chain), r.boundaries,
                        r.kernel.packer.to_flat(r.chain.momentum))
    flat = out["flat"]
    for packing in ("hybrid", "segmented"):
        params, boundaries, momentum = out[packing]
        assert [b["rejected"] for b in boundaries] == \
            [b["rejected"] for b in flat[1]]
        np.testing.assert_allclose(
            [b["delta_energy"] for b in boundaries],
            [b["delta_energy"] for b in flat[1]], rtol=1e-10)
        for k, v in flat[0].items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(momentum.numpy(), flat[2].numpy(), rtol=0,
                                   atol=1e-12)
