"""The port's `train_bnn` with `n_chains=2` against the JAX CLI's
(`experiments/train_bnn.py`, as `tests/test_cli.py` drives it): per-chain
run dirs with the full artifact contract, per-chain and pooled results,
the same metric series, values and samples a chain on the same warm start,
minibatch orders and T=0, and `eval_bnn` reproducing a chain's result from
its dir. Data, model, warm start and tolerances are test_torch_cli.py's.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.io import load_samples as jax_load_samples
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxChains
from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
from bnn_priors_tpu_torch.io import load_metrics, load_samples
from bnn_priors_tpu_torch.parallel import MultiChainRunnerReject

from test_torch_cli import (CFG, N_TRAIN, RTOL, assert_close,  # noqa: F401
                            assert_metrics_close, bank, load_jax_cli,
                            metric_names, patched)
from test_torch_models import torch_threads_per_worker  # noqa: F401

CHAINS = dict(CFG, n_chains=2, temperature=1.0, n_samples=1)
# one minibatch order a chain, different between the chains, so that at
# T=0 the two chains from one warm start still part: (K, n_full, B)
B = CFG["batch_size"]
ORDERS = np.stack([np.random.RandomState(8 + c).permutation(N_TRAIN)
                   for c in range(2)])[:, :N_TRAIN // B * B].reshape(2, -1, B)


@pytest.fixture(scope="module")
def fixed_orders(patched):
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxChains, "_epoch_idxs", lambda self, cycle=0, epoch=0:
               jnp.asarray(ORDERS, dtype=jnp.int32))
    mp.setattr(MultiChainRunnerReject, "_epoch_idxs",
               lambda self, cycle=0, epoch=0:
               torch.as_tensor(ORDERS).to(self.device))
    yield mp
    mp.undo()


def _chain_run(cli, cfg, log_dir):
    full = dict(cli.DEFAULTS)
    full.update(cfg, log_dir=str(log_dir))
    return cli.main(full)


@pytest.fixture(scope="module")
def jax_chains_t0(fixed_orders, bank, tmp_path_factory):
    return _chain_run(load_jax_cli("train_bnn"),
                      dict(CHAINS, temperature=0.0, load_samples=bank),
                      tmp_path_factory.mktemp("jax_chains_t0"))


@pytest.fixture(scope="module")
def port_chains_t0(fixed_orders, bank, tmp_path_factory):
    return _chain_run(train_bnn, dict(CHAINS, temperature=0.0,
                                      load_samples=bank),
                      tmp_path_factory.mktemp("port_chains_t0"))


@pytest.fixture(scope="module")
def port_chains(patched, bank, tmp_path_factory):
    return _chain_run(train_bnn, dict(CHAINS, load_samples=bank),
                      tmp_path_factory.mktemp("port_chains"))


def test_chain_run_dirs(port_chains):
    "tests/test_cli.py:53-65, for the port"
    summary = port_chains
    assert len(summary["chains"]) == 2 and summary["n_diverged"] == 0
    assert {"lp_ensemble", "acc_ensemble"} <= set(summary["pooled"])
    for c, d in enumerate(summary["chain_dirs"]):
        d = Path(d)
        for artifact in ("config.json", "run.json", "samples.pt",
                         "metrics.h5"):
            assert (d / artifact).exists(), (c, artifact)
        assert json.loads((d / "config.json").read_text())["chain_index"] == c
        rj = json.loads((d / "run.json").read_text())
        assert rj["status"] == "COMPLETED"
        assert rj["artifacts"] == ["samples.pt", "metrics.h5"]
        assert rj["result"] == summary["chains"][c]
        assert 0.0 <= rj["result"]["acceptance"] <= 1.0
        bank = load_samples(str(d / "samples.pt"), keep_steps=True)
        # one sample a sampling epoch, at the step after the epoch
        np.testing.assert_array_equal(bank["steps"], [6])
    parent = Path(summary["chain_dirs"][0]).parent
    runs = [json.loads((p / "run.json").read_text())
            for p in parent.iterdir() if p.is_dir()]
    assert sum(r["result"] == summary for r in runs) == 1


def test_chain_metrics_match_the_jax_cli(jax_chains_t0, port_chains_t0):
    """every chain's metric series (its minibatch steps, exact/*, ΔE,
    acceptance/*, preconditioner/*, test/*), its bank and its result, at
    the single-chain comparison's tolerances"""
    jax_chains, port_chains = jax_chains_t0, port_chains_t0
    assert len(jax_chains["chain_dirs"]) == len(port_chains["chain_dirs"])
    losses, banks, err = [], [], 0.0
    for jd, td in zip(jax_chains["chain_dirs"], port_chains["chain_dirs"]):
        names = metric_names(Path(jd) / "metrics.h5")
        assert names == metric_names(Path(td) / "metrics.h5")
        for must in ("exact/potential", "acceptance/rejected",
                     "delta_energy", "test/acc", "potential",
                     "est_temperature/net.0.weight_prior.p",
                     "preconditioner/net.0.weight_prior.p"):
            assert must in names, must
        jm = load_metrics(Path(jd) / "metrics.h5", names)
        tm = load_metrics(Path(td) / "metrics.h5", names)
        np.testing.assert_array_equal(tm["steps"], jm["steps"])
        assert_metrics_close(tm, jm, names)
        js = jax_load_samples(str(Path(jd) / "samples.pt"), keep_steps=True)
        ts = load_samples(str(Path(td) / "samples.pt"), keep_steps=True)
        assert set(js) == set(ts)
        np.testing.assert_array_equal(ts["steps"], js["steps"])
        for k in js:
            assert_close(ts[k], js[k], k)
            err = max(err, np.abs(ts[k] - js[k]).max())
        losses.append(tm["loss"])
        banks.append(ts)
    # the two chains parted, by far more than the packages differ, so a
    # row or column of the wrong chain would show
    assert np.nanmin(np.abs(losses[0] - losses[1])) > 100 * RTOL
    apart = max(np.abs(banks[0][k] - banks[1][k]).max() for k in banks[0]
                if k != "steps")
    assert apart > 10 * err, (apart, err)
    assert set(port_chains) == set(jax_chains)
    for jres, tres in zip(jax_chains["chains"], port_chains["chains"]):
        assert set(tres) == set(jres)
        for k in jres:
            np.testing.assert_allclose(tres[k], jres[k], rtol=RTOL,
                                       err_msg=k)
    for k in jax_chains["pooled"]:
        np.testing.assert_allclose(port_chains["pooled"][k],
                                   jax_chains["pooled"][k], rtol=RTOL,
                                   err_msg=k)


def test_eval_bnn_reproduces_a_chain(port_chains, tmp_path):
    d = port_chains["chain_dirs"][1]
    cfg = dict(eval_bnn.DEFAULTS)
    cfg.update(config_file=str(Path(d) / "config.json"), skip_first=0,
               device="cpu", calibration_eval=True, log_dir=str(tmp_path))
    res = eval_bnn.main(cfg)
    assert {"ece", "ace", "rmsce"} <= set(res)
    for k in ("lp_ensemble", "acc_ensemble", "lp_last", "acc_last"):
        np.testing.assert_allclose(res[k], port_chains["chains"][1][k],
                                   rtol=1e-6, err_msg=k)
