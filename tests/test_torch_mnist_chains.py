"""The chain axis on the new models: the port's `MultiChainRunnerReject`
at K=3 against the JAX package's `MultiChainRunnerReject(packing="flat")`,
step for step in f64 at temperature 0 with one fixed minibatch order a
chain, on the small CNN (8x8 images, width 4; the image input and the
flatten folded over the chains) and on `densenet` (`noise_std.p` a (K,)
leaf against (K, B, 1) targets); and the plain `MultiChainRunner` on both
in bf16 at temperature 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxMultiReject
from bnn_priors_tpu_torch.exp_utils import he_initialize
from bnn_priors_tpu_torch.interop import load_jax_chains
from bnn_priors_tpu_torch.ops import fused_update
from bnn_priors_tpu_torch.parallel import (MultiChainRunner,
                                           MultiChainRunnerReject)

from test_torch_mnist_models import _data, _pair
from test_torch_models import answer_init, torch_threads_per_worker  # noqa

K, N_TRAIN, N_TEST, BATCH = 3, 64, 16, 16
RUN = dict(learning_rate=1e-3, momentum=0.9, batch_size=BATCH, cycles=1,
           epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
           precond_update=1)
MODELS = ("classificationconvnet", "densenet")


def _setup(name):
    """(JAX model, port model, K He-initialised chains' params as numpy
    (each chain its own prior draw, so `noise_std.p` differs), data)"""
    x, y = _data(name, n=N_TRAIN + N_TEST, seed=4)
    jm, tm, _ = _pair(name, x[:N_TRAIN], y[:N_TRAIN])
    inits = []
    for c in range(K):
        g = torch.Generator().manual_seed(c)
        he_initialize(tm.init(g), g)
        inits.append({k: v.detach().numpy().copy()
                      for k, v in tm.params().items()})
    return jm, tm, inits, ((x[:N_TRAIN], y[:N_TRAIN]),
                           (x[N_TRAIN:], y[N_TRAIN:]))


def _orders(seed=7):
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(N_TRAIN).reshape(-1, BATCH)
                     for _ in range(K)])


@pytest.fixture(scope="module")
def jax_runs():
    "the JAX K-chain runner on each model at T=0, once a module"
    out = {}
    for name in MODELS:
        jm, _, inits, (train, test) = _setup(name)
        answer_init(jm, inits[0], {})
        jr = JaxMultiReject(
            jm, tuple(map(jnp.asarray, train)), n_chains=K, temperatures=0.0,
            key=jax.random.key(0), dtype=jnp.float64, packing="flat",
            init_params_fn=lambda i, key, inits=inits: {
                k: jnp.asarray(v) for k, v in inits[i].items()},
            test_data=tuple(map(jnp.asarray, test)), **RUN)
        orders = jnp.asarray(_orders())
        jr._epoch_idxs = lambda cycle=0, epoch=0, o=orders: o
        start = np.asarray(jr.states.position).copy()
        out[name] = (start, jr.run(), jr)
    return out


@pytest.mark.parametrize("name", MODELS)
def test_chain_runner_matches_jax_step_for_step(jax_runs, name):
    """per-chain epoch entries, boundary ΔE, decisions and exact metrics,
    the final bank and the sample bank at rtol 1e-8"""
    start, jhist, jr = jax_runs[name]
    _, tm, _, (train, test) = _setup(name)
    tr = MultiChainRunnerReject(tm, tuple(map(torch.as_tensor, train)), K,
                                temperatures=0.0,
                                test_data=tuple(map(torch.as_tensor, test)),
                                device="cpu", **RUN)
    load_jax_chains(tr, start, {})
    orders = torch.as_tensor(_orders())
    tr._epoch_idxs = lambda cycle=0, epoch=0: orders
    assert tr.kernel.packer.names == jr.kernel.packer.names
    before = fused_update.chain_launches
    thist = tr.run()
    assert fused_update.chain_launches == before  # the CPU runs plain code
    close = lambda ours, theirs, what: np.testing.assert_allclose(
        ours, np.asarray(theirs), rtol=1e-8, atol=1e-12, err_msg=what)
    assert len(thist) == len(jhist) == 2
    for e, (t, j) in enumerate(zip(thist, jhist)):
        assert set(t) == set(j) >= {"potential", "test/acc", "test/loss"}
        for k in j:
            close(t[k], j[k], f"epoch {e} {k}")
    close(tr.delta_energies[0], jr.delta_energies[0], "delta_energy")
    np.testing.assert_array_equal(tr.rejections[0], jr.rejections[0])
    for k, v in jr.boundary_metrics[0].items():
        close(tr.boundary_metrics[0][k], v, "exact " + k)
    close(tr.chains.position.numpy(), jr.states.position, "position")
    ts, js = tr.get_samples(), jr.get_samples()
    assert set(ts) == set(js)
    for k in js:
        assert ts[k].shape[:2] == (1, K)
        close(ts[k], js[k], "sample " + k)
    if name == "densenet":
        noise = ts["noise_std.p"][0]
        assert noise.shape == (K,) and len(set(noise.tolist())) == K


@pytest.mark.parametrize("name", MODELS)
def test_plain_chain_loop_in_bf16(name):
    """the plain loop (SGLD kernel) at T=1 in bf16: finite potentials and
    test metrics every epoch, one sample a chain"""
    _, tm, inits, (train, test) = _setup(name)
    tm = tm.float()
    tr = MultiChainRunner(tm, tuple(torch.as_tensor(a).float()
                                    if a.dtype == np.float64 else
                                    torch.as_tensor(a) for a in train), K,
                          kernel="SGLD", temperatures=1.0,
                          compute_dtype=torch.bfloat16,
                          test_data=tuple(torch.as_tensor(a).float()
                                          if a.dtype == np.float64 else
                                          torch.as_tensor(a) for a in test),
                          init_params_fn=lambda c, g: {
                              k: torch.as_tensor(v).float()
                              for k, v in inits[c].items()},
                          device="cpu", seed=2, **RUN)
    hist = tr.run()
    for e in hist:
        assert np.all(np.isfinite(e["potential"]))
        assert np.all(np.isfinite(e["test/loss"]))
    bank = tr.get_samples()
    assert all(v.shape[:2] == (1, K) for v in bank.values())
