"""The port's `train_bnn` with the HMC inferences beside the JAX CLI's:
`OurHMC` (HMCRunner), `HMCReject` and `HMC` (HMCRunnerReject; `HMC` with
one batch of all N points and the M-H test on). Both sides run each on
test_torch_cli.py's data, model and warm start at temperature 1 and
momentum 1; the momentum draws differ between the packages, so the runs
are held to the same run files, metric series and sample steps, and the
port's to finite values. With `n_chains>1` the three run on the chain
axis (held to the JAX CLI in test_torch_cli_chain_inferences.py).
Classical HMC runs in test_torch_cli_hmc_classical.py, to keep each
file's time short.
"""
import json

import numpy as np
import pytest

from bnn_priors_tpu_torch.experiments import train_bnn
from bnn_priors_tpu_torch.io import load_metrics, load_samples

from test_torch_cli import (CFG, bank, load_jax_cli,  # noqa: F401
                            metric_names, only_dir, patched)
from test_torch_models import torch_threads_per_worker  # noqa: F401

HMC = dict(CFG, temperature=1.0, momentum=1.0, burnin=0, n_samples=1,
           reject_samples=False)
INFERENCES = ["OurHMC", "HMCReject", "HMC"]


@pytest.fixture(scope="module")
def hmc_runs(patched, bank, tmp_path_factory):
    "run(package, inference): that package's CLI run dir, once a module"
    runs = {}

    def run(package, inference):
        if (package, inference) not in runs:
            cli = load_jax_cli("train_bnn") if package == "jax" else train_bnn
            log_dir = tmp_path_factory.mktemp(f"{package}_{inference}")
            cfg = dict(cli.DEFAULTS)
            cfg.update(HMC, inference=inference, load_samples=bank,
                       log_dir=str(log_dir))
            runs[package, inference] = cli.main(cfg), only_dir(log_dir)
        return runs[package, inference]
    return run


@pytest.mark.parametrize("inference", ["OurHMC", "HMCReject"])
def test_hmc_inference_writes_the_jax_metrics(hmc_runs, inference):
    assert_writes_the_jax_metrics(hmc_runs, inference)


def assert_writes_the_jax_metrics(hmc_runs, inference):
    "the two CLIs' run files for `inference`"
    (jres, jdir), (tres, tdir) = (hmc_runs("jax", inference),
                                  hmc_runs("port", inference))
    trun = json.loads((tdir / "run.json").read_text())
    jrun = json.loads((jdir / "run.json").read_text())
    assert trun["status"] == "COMPLETED" and trun["result"] == tres
    assert trun["artifacts"] == [a for a in jrun["artifacts"]
                                 if a != "chain.ckpt.npz"]
    names = metric_names(jdir / "metrics.h5")
    assert names == metric_names(tdir / "metrics.h5")
    assert "delta_energy" in names
    assert ("acceptance/rejected" in names) == (inference == "HMC")
    jm = load_metrics(jdir / "metrics.h5", ["steps"])
    tm = load_metrics(tdir / "metrics.h5", ["steps", "potential",
                                           "delta_energy"])
    np.testing.assert_array_equal(tm["steps"], jm["steps"])
    for k in ("potential", "delta_energy"):
        v = tm[k][~np.isnan(tm[k])]
        assert v.size and np.all(np.isfinite(v)), k
    js = load_samples(str(jdir / "samples.pt"), keep_steps=True)
    ts = load_samples(str(tdir / "samples.pt"), keep_steps=True)
    assert set(ts) == set(js)
    np.testing.assert_array_equal(ts["steps"], js["steps"])
    assert set(tres) == set(jres)
    assert all(np.isfinite(v) for v in tres.values())


@pytest.mark.parametrize("inference", INFERENCES)
def test_hmc_with_chains_raises(patched, bank, tmp_path, inference):
    """the HMC inferences with n_chains=2, once refused, run: two chain run
    dirs COMPLETED, finite per-chain and pooled results, and an acceptance
    rate where the chains take the M-H test (classical HMC)"""
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(HMC, inference=inference, n_chains=2, load_samples=bank,
               log_dir=str(tmp_path))
    summary = train_bnn.main(cfg)
    assert len(summary["chain_dirs"]) == 2 and summary["n_diverged"] == 0
    for res in summary["chains"]:
        assert ("acceptance" in res) == (inference == "HMC")
        assert all(np.isfinite(v) for v in res.values())
    assert all(np.isfinite(v) for v in summary["pooled"].values())
