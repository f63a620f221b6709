"""The port's SGD baseline CLI (`python -m
bnn_priors_tpu_torch.experiments.train_sgd`) against
`experiments/train_sgd.py`: the artifact contract of
tests/test_cli.py::test_train_sgd_baseline_artifact_contract, the same
flags and defaults but `--device`, and the same run: both CLIs on
`--data random --model densenet` (RandomData of seed 0 on both sides),
warm started from one JAX-written parameter set, one fixed minibatch
order, in float32 at rtol 1e-4.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.data import RandomData as JaxRandom
from bnn_priors_tpu.inference.runner import SGLDRunner as JaxRunner
from bnn_priors_tpu_torch import exp_utils, interop
from bnn_priors_tpu_torch.data import RandomData
from bnn_priors_tpu_torch.experiments import train_sgd
from bnn_priors_tpu_torch.inference import SGLDRunner
from bnn_priors_tpu_torch.io import load_metrics, load_samples

from test_torch_cli import REPO, load_jax_cli
from test_torch_models import torch_threads_per_worker  # noqa: F401

ARGS = ["--data", "random", "--model", "densenet", "--width", "8",
        "--n_epochs", "3", "--epochs_per_sample", "1", "--skip_first", "1",
        "--batch_size", "64", "--lr", "0.01", "--device", "cpu"]
PERM = np.random.RandomState(3).permutation(1000)


def test_train_sgd_baseline_artifact_contract(tmp_path, capsys):
    """a tiny run writes the run files and a COMPLETED result, and prints
    the result as its last line; `python -m` reaches the same parser"""
    result = train_sgd.main([*ARGS, "--log_dir", str(tmp_path)])
    for artifact in ("config.json", "run.json", "samples.pt", "metrics.h5"):
        assert (tmp_path / artifact).exists(), artifact
    rj = json.loads((tmp_path / "run.json").read_text())
    assert rj["status"] == "COMPLETED" and rj["result"] == result
    assert "lp_ensemble" in rj["result"]
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == rj["result"]
    assert json.loads((tmp_path / "config.json").read_text())[
        "temperature"] == 0.0
    usage = subprocess.run(
        [sys.executable, "-m", "bnn_priors_tpu_torch.experiments.train_sgd",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert usage.returncode == 0 and "--epochs_per_sample" in usage.stdout


def test_flags_and_defaults_match_jax(monkeypatch):
    "the same flags with the same defaults, but --device (cuda, not tpu)"
    captured = {}

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        captured["defaults"] = vars(orig(self, []))
        raise Stop
    import argparse
    orig = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop):
        load_jax_cli("train_sgd").main()
    monkeypatch.undo()
    ours = vars(train_sgd.parser().parse_args([]))
    theirs = captured["defaults"]
    assert set(ours) == set(theirs)
    assert {k for k in ours if ours[k] != theirs[k]} == {"device"}
    assert ours["device"] == "cuda" and theirs["device"] == "tpu"


def test_failed_run_is_recorded(tmp_path):
    with pytest.raises(Exception):
        train_sgd.main([*ARGS[:-2], "--device", "tpu",
                        "--log_dir", str(tmp_path)])
    assert json.loads((tmp_path / "run.json").read_text()) == {
        "status": "FAILED"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """both CLIs on ARGS, from one JAX parameter draw with He-uniform
    weights and through PERM every epoch"""
    mp = pytest.MonkeyPatch()
    jdata = JaxRandom(seed=0)
    jm = jax_exp.get_model(jdata.norm.train_X, jdata.norm.train_y,
                           "densenet", 8, 3, "improper", 0.0, 1.0,
                           "improper", 0.0, 1.0, True, {}, {})
    params, _ = jm.init(jax.random.key(5), dtype=jnp.float32)
    params = jax_exp.he_uniform_initialize(params, jax.random.key(6))
    start = {k: np.asarray(v) for k, v in params.items()}
    mp.setattr(jax_exp, "get_data", lambda name: JaxRandom(seed=0))
    mp.setattr(jax_exp, "he_uniform_initialize",
               lambda p, key: {k: jnp.asarray(start[k]) for k in p})
    mp.setattr(exp_utils, "get_data",
               lambda name, device="cuda": RandomData(seed=0, device=device))
    mp.setattr(exp_utils, "he_uniform_initialize",
               lambda model, gen: interop.load_jax_state(model, start, {}))
    mp.setattr(JaxRunner, "_epoch_perm",
               lambda self, cycle, epoch: jnp.asarray(PERM))
    mp.setattr(SGLDRunner, "_epoch_perm",
               lambda self, cycle, epoch: PERM)
    out = {}
    try:
        for name, main in (("jax", lambda argv: (
                mp.setattr(sys, "argv", ["train_sgd.py", *argv]),
                load_jax_cli("train_sgd").main())),
                ("port", train_sgd.main)):
            d = tmp_path_factory.mktemp(name)
            main([*ARGS, "--log_dir", str(d)])
            out[name] = d
    finally:
        mp.undo()
    return out


def test_sgd_run_matches_jax_at_t0(runs):
    "the same SGD trajectory: samples, metric series and result"
    jd, td = runs["jax"], runs["port"]
    jres = json.loads((jd / "run.json").read_text())
    tres = json.loads((td / "run.json").read_text())
    assert jres["status"] == tres["status"] == "COMPLETED"
    for k in jres["result"]:
        np.testing.assert_allclose(tres["result"][k], jres["result"][k],
                                   rtol=1e-4, err_msg=k)
    js, ts = load_samples(str(jd / "samples.pt")), load_samples(
        str(td / "samples.pt"))
    assert set(js) == set(ts)
    for k in js:
        assert js[k].shape == ts[k].shape == (3,) + js[k].shape[1:], k
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    keys = ("loss", "lr", "test/loss")
    jm, tm = load_metrics(jd / "metrics.h5", keys), load_metrics(
        td / "metrics.h5", keys)
    for k in keys:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
