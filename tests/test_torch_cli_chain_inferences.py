"""The port's `train_bnn` with `n_chains=2` for the six inferences besides
VerletSGLDReject (test_torch_cli_chains.py): SGLD, VerletSGLD and OurHMC
through `MultiChainRunner`, SGLDReject, HMCReject and classical HMC
through `MultiChainRunnerReject`, each against the JAX CLI's run of the
same command (`experiments/train_bnn.py`) in float32 at rtol 1e-4: every
chain's metric series, test rows (`eval_skip=2`), samples and result, and
the pooled result. Data, model, warm start and orders are
test_torch_cli_chains.py's (one batch of all points for classical HMC).

The SGLD-family runs are at T=0. The HMC runs are at T=1 with the
momentum draws injected into both packages (test_torch_chain_inferences.py
does it for the runners); for that the JAX chain runners are built with a
flat state, as the port's CLI runs, so a draw is one array on both sides.
Classical HMC's memory guard for batch N raises in both CLIs alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import mcmc as jax_mcmc
from bnn_priors_tpu.io import load_samples as jax_load_samples
from bnn_priors_tpu.parallel import MultiChainRunner as JaxPlain
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxReject
from bnn_priors_tpu_torch import mcmc
from bnn_priors_tpu_torch.experiments import train_bnn
from bnn_priors_tpu_torch.io import load_metrics, load_samples
from bnn_priors_tpu_torch.parallel import (MultiChainRunner,
                                           MultiChainRunnerReject)

from test_torch_cli import (CFG, N_TRAIN, RTOL, assert_close,  # noqa: F401
                            assert_metrics_close, bank, load_jax_cli,
                            metric_names, patched)
from test_torch_models import torch_threads_per_worker  # noqa: F401

K = 2
CHAINS = dict(CFG, n_chains=K, eval_skip=2)
HMC = dict(temperature=1.0, momentum=1.0, burnin=0, lr=1e-5)
CASES = {"SGLD": dict(reject_samples=False),
         "VerletSGLD": dict(reject_samples=False, chain_group_size=1),
         "OurHMC": dict(HMC, reject_samples=False),
         "SGLDReject": dict(reject_samples=True),
         "HMCReject": dict(HMC, reject_samples=False),
         "HMC": dict(HMC, reject_samples=True)}
# ResNet-8's flat state: 78,848 padded, 78,042 parameters
T_PAD, T_REAL = 78848, 78042


def _orders(n_full, batch):
    """(K, n_full, B): test_torch_cli_chains.py's orders (a fixed one a
    chain), cut to the run's batches (one of all N points for classical
    HMC)"""
    return np.stack([np.random.RandomState(8 + c).permutation(N_TRAIN)[
        :n_full * batch].reshape(n_full, batch) for c in range(K)])


def _draws(n=6):
    "(n, K, T) float32 momentum draws, padding tail zero"
    out = np.random.RandomState(11).standard_normal((n, K, T_PAD))
    out[..., T_REAL:] = 0.0
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def same_orders_and_draws(patched):
    """both packages' chain runners visit the data in `_orders`, the JAX
    ones with a flat state, and their momentum refreshes return the next
    draws, each package from its own iterator"""
    mp = pytest.MonkeyPatch()
    idxs = lambda self, cycle=0, epoch=0: jnp.asarray(
        _orders(self.n_full, self.batch_size), dtype=jnp.int32)
    for cls in (JaxPlain, JaxReject):
        mp.setattr(cls, "_epoch_idxs", idxs)
    for cls in (MultiChainRunner, MultiChainRunnerReject):
        mp.setattr(cls, "_epoch_idxs", lambda self, cycle=0, epoch=0:
                   torch.as_tensor(_orders(self.n_full, self.batch_size))
                   .to(self.device))
    init = JaxPlain.__init__

    def flat_init(self, *args, **kwargs):
        kwargs.setdefault("packing", "flat")
        init(self, *args, **kwargs)
    mp.setattr(JaxPlain, "__init__", flat_init)
    state = {}

    def restart():
        "fresh iterators, one a package, for the next pair of runs"
        state["jax"], state["port"] = iter(_draws()), iter(_draws())

    def jax_all(self):
        m = jnp.asarray(next(state["jax"]))
        return self.states._replace(
            momentum=jnp.sqrt(self.temperatures)[:, None] * m)

    def jax_sample(self, st, temperature, keep=0.0):
        m = jax.pure_callback(
            lambda mm: next(state["jax"]).reshape(mm.shape),
            jax.ShapeDtypeStruct(st.momentum.shape, st.momentum.dtype),
            st.momentum, vmap_method="broadcast_all")
        return st._replace(momentum=jnp.sqrt(temperature) * m)

    def port_sample(self, st, temperature):
        m = torch.as_tensor(next(state["port"])).to(st.momentum)
        st.momentum = torch.sqrt(temperature)[:, None] * m
        return st
    mp.setattr(JaxPlain, "_sample_momentum_all", jax_all)
    mp.setattr(jax_mcmc.HMC, "sample_momentum", jax_sample)
    mp.setattr(mcmc.HMCChains, "sample_momentum", port_sample)
    yield restart
    mp.undo()


@pytest.fixture(scope="module")
def cli_runs(same_orders_and_draws, bank, tmp_path_factory):
    "runs(inference): (JAX summary, port summary), run once a module"
    runs = {}

    def run(inference):
        if inference not in runs:
            out = []
            same_orders_and_draws()
            for package in ("jax", "port"):
                cli = load_jax_cli("train_bnn") if package == "jax" \
                    else train_bnn
                cfg = dict(cli.DEFAULTS)
                cfg.update(CHAINS, **CASES[inference], inference=inference,
                           load_samples=bank, log_dir=str(
                               tmp_path_factory.mktemp(package + inference)))
                out.append(cli.main(cfg))
            runs[inference] = tuple(out)
        return runs[inference]
    return run


def _assert_series_close(tm, jm, names, draws):
    """assert_metrics_close, with HMC's ΔE and total energy held to 1e-6
    of the kinetic energies ½‖m‖² they cancel as well"""
    energy = [n for n in names if n in ("delta_energy", "total_energy")]
    if draws:
        kinetic = 0.5 * float((_draws() ** 2).sum(-1).max())
        potential = N_TRAIN * np.nanmax(np.abs(jm["potential"]))
        for n in energy:
            assert_close(tm[n], jm[n], n, atol=1e-6 * (potential + kinetic))
        names = [n for n in names if n not in energy]
    assert_metrics_close(tm, jm, names)


@pytest.mark.parametrize("inference", list(CASES))
def test_chain_inference_matches_the_jax_cli(cli_runs, inference):
    jax_sum, port_sum = cli_runs(inference)
    assert port_sum["n_diverged"] == jax_sum["n_diverged"] == 0
    assert len(port_sum["chain_dirs"]) == len(jax_sum["chain_dirs"]) == K
    hmc = "HMC" in inference
    for jd, td in zip(jax_sum["chain_dirs"], port_sum["chain_dirs"]):
        names = metric_names(f"{jd}/metrics.h5")
        assert names == metric_names(f"{td}/metrics.h5")
        assert "potential" in names and "test/acc" in names
        assert ("delta_energy" in names) == (inference not in ("SGLD",
                                                               "VerletSGLD",
                                                               "OurHMC"))
        # the SGLD kernel cannot reject: its reject runner takes no test
        assert ("acceptance/rejected" in names) == (inference == "HMC")
        jm = load_metrics(f"{jd}/metrics.h5", names + ["steps"])
        tm = load_metrics(f"{td}/metrics.h5", names + ["steps"])
        np.testing.assert_array_equal(tm["steps"], jm["steps"])
        # eval_skip=2 of 3 epochs: the test pass after epochs 2 and 3 only
        rows = ~np.isnan(jm["test/acc"])
        np.testing.assert_array_equal(rows, ~np.isnan(tm["test/acc"]))
        assert rows.sum() == 2
        if "acceptance/rejected" in names:  # sure outcomes only
            assert not np.any(tm["acceptance/rejected"] == 1)
            assert not np.any(jm["acceptance/rejected"] == 1)
        _assert_series_close(tm, jm, names, hmc)
        js = jax_load_samples(f"{jd}/samples.pt", keep_steps=True)
        ts = load_samples(f"{td}/samples.pt", keep_steps=True)
        assert set(js) == set(ts)
        np.testing.assert_array_equal(ts["steps"], js["steps"])
        for k in js:
            assert_close(ts[k], js[k], k)
    for jres, tres in zip(jax_sum["chains"], port_sum["chains"]):
        assert set(tres) == set(jres)
        assert ("acceptance" in tres) == (inference in ("SGLDReject",
                                                        "HMC"))
        for k in jres:
            np.testing.assert_allclose(tres[k], jres[k], rtol=RTOL,
                                       err_msg=k)
    for k in jax_sum["pooled"]:
        np.testing.assert_allclose(port_sum["pooled"][k],
                                   jax_sum["pooled"][k], rtol=RTOL,
                                   err_msg=k)


def test_classical_hmc_memory_guard(patched, tmp_path):
    """inference=HMC holds every chain's full-data batch: both CLIs refuse
    K·N·(3·32·32)·4 bytes ≥ 2 GB before any chain's run dir
    (train_bnn.py:268-281)"""
    for package in ("jax", "port"):
        cli = load_jax_cli("train_bnn") if package == "jax" else train_bnn
        cfg = dict(cli.DEFAULTS)
        log_dir = tmp_path / package
        cfg.update(CHAINS, **CASES["HMC"], inference="HMC", n_chains=2000,
                   log_dir=str(log_dir))
        with pytest.raises(AssertionError, match="needs full-batch"):
            cli.main(cfg)
        # only the parent run's dir, marked failed
        assert len([d for d in log_dir.iterdir() if d.is_dir()]) == 1
