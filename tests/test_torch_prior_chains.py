"""Priors on the chain axis: the port's `MultiChainRunnerReject` against
the JAX package's (`packing="flat"`), K=3 chains of a depth-8 ResNet whose
dense layer carries `laplace` or `gaussian_gamma`, step for step in f64 at
temperature 0. With `gaussian_gamma` every chain has its own scale leaf,
a `(K,)` row of the bank that the priors broadcast against the chains'
weights. The JAX model's `init` answers with the port's initial values
(`answer_init`: the JAX runner calls it only for its template state), and
32 points in batches of 16 keep the two steps an epoch and the boundary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxMultiReject
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.interop import load_jax_chains
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_models import torch_threads_per_worker  # noqa: F401
from test_torch_multichain import K, N_TEST, RUN
from test_torch_models import answer_init
from test_torch_prior_runners import jax_model, port_init, port_model

N_TRAIN, BATCH = 32, 16
RUN = dict(RUN, batch_size=BATCH)


def _orders(seed=7):
    "(K, n_full, B): one fixed minibatch order a chain"
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(N_TRAIN).reshape(-1, BATCH)
                     for _ in range(K)])


def _chain_inits(name):
    """K inits in f64: each chain's own prior draw (the hyper leaves at
    their pins) and He weights, one generator a chain"""
    model = port_model(name)
    return [port_init(model, c) for c in range(K)]


@pytest.mark.parametrize("name", ["laplace", "gaussian_gamma"])
def test_prior_chains_match_jax_step_for_step(name, monkeypatch):
    inits = _chain_inits(name)
    jdata = JaxFakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST)
    jm = jax_model(name, monkeypatch)
    answer_init(jm, *inits[0])
    jr = JaxMultiReject(
        jm, jdata.norm.train, n_chains=K,
        temperatures=0.0, key=jax.random.key(0), dtype=jnp.float64,
        packing="flat",
        init_params_fn=lambda i, key: {k: jnp.asarray(v)
                                       for k, v in inits[i][0].items()},
        test_data=jdata.norm.test, **RUN)
    orders = _orders()
    jr._epoch_idxs = lambda cycle=0, epoch=0: jnp.asarray(orders)
    start = (np.asarray(jr.states.position).copy(),
             {k: np.asarray(v).copy() for k, v in jr.model_states.items()})
    jhist = jr.run()

    data = FakeCIFAR10(dtype="float64", n_train=N_TRAIN, n_test=N_TEST,
                       device="cpu")
    tr = MultiChainRunnerReject(port_model(name), data.norm.train, K,
                                temperatures=0.0, test_data=data.norm.test,
                                device="cpu", **RUN)
    load_jax_chains(tr, *start)
    tr._epoch_idxs = lambda cycle=0, epoch=0: torch.as_tensor(orders)
    pk = tr.kernel.packer
    assert pk.names == jr.kernel.packer.names
    if name == "gaussian_gamma":
        assert "net.8.weight_prior.scale.p" in pk.names
        # every chain starts at the pin inv_softplus(scale)
        scale = pk.unpack(tr.chains.position)["net.8.weight_prior.scale.p"]
        assert scale.shape == (K,) and torch.unique(scale).numel() == 1
    thist = tr.run()

    close = lambda ours, theirs, what: np.testing.assert_allclose(
        ours, np.asarray(theirs), rtol=1e-8, atol=1e-12, err_msg=what)
    assert len(thist) == len(jhist) == 2
    for e, (t, j) in enumerate(zip(thist, jhist)):
        assert set(t) == set(j)
        for k in j:
            close(t[k], j[k], f"epoch {e} {k}")
    close(tr.delta_energies[0], jr.delta_energies[0], "delta_energy")
    for k, v in jr.boundary_metrics[0].items():
        close(tr.boundary_metrics[0][k], v, "exact " + k)
    close(tr.chains.position.numpy(), jr.states.position, "position")
    ts, js = tr.get_samples(), jr.get_samples()
    assert set(ts) == set(js)
    for k in js:
        close(ts[k], js[k], "sample " + k)
    assert BATCH * orders.shape[1] == N_TRAIN
