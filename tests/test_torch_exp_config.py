"""The port's sacred-style config and run directories
(`bnn_priors_tpu_torch/exp/config.py`) against the JAX package's copy:
the same argv lists parse to equal dicts or raise the same errors, and a
`RunDirectory` numbers and records runs the same way."""
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bnn_priors_tpu.exp import config as jax_config
from bnn_priors_tpu_torch.exp import config

DEFAULTS = dict(data="mnist", lr=5e-4, cycles=60, batchnorm=True,
                load_samples=None, weight_prior_params={}, compute_dtype=None,
                temperatures=[1.0])


def both(fn_name, *args):
    """(port result or exception, JAX result or exception); results as
    their repr, so a parsed NaN equals itself"""
    out = []
    for mod in (config, jax_config):
        try:
            out.append(("ok", repr(getattr(mod, fn_name)(*args))))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize("argv", [
    [], ["with"], ["with", "data=fake_cifar10", "lr=0.01", "cycles=3"],
    ["lr=1e-3", "batchnorm=False", "load_samples=None"],
    ["batchnorm=yes"], ["batchnorm=off"], ["batchnorm=1"], ["batchnorm=maybe"],
    ["weight_prior_params={\"a\": 1}"], ["weight_prior_params.a=1.5"],
    ["temperatures=[0.1, 1.0]"], ["compute_dtype=bfloat16"],
    ["cycles=2.5"], ["cycles=x"], ["data=True"], ["unknown=1"],
    ["lr"], ["data=a=b"], ["weight_prior_params.a.b=2"]])
def test_parse_cli_matches_jax(argv):
    port, jax = both("parse_cli", DEFAULTS, argv)
    assert port == jax


@settings(max_examples=200, deadline=None)
@given(value=st.text(max_size=12),
       default=st.sampled_from([None, True, 1, 1.0, "s", {}, [1]]))
def test_coerce_matches_jax(value, default):
    port, jax = both("coerce", value, default)
    assert port == jax


def test_cfg_get_and_set():
    cfg = {"a": {"b": 1}}
    for mod in (config, jax_config):
        c = json.loads(json.dumps(cfg))
        mod.cfg_set(c, "a.c.d", 2)
        assert mod.cfg_get(c, "a.c.d") == 2 and mod.cfg_get(c, "a.x") is None
        assert c == {"a": {"b": 1, "c": {"d": 2}}}


def test_run_directory_matches_jax(tmp_path):
    cfg = {"seed": 3, "lr": 1e-3}
    runs = {}
    for name, mod in (("port", config), ("jax", jax_config)):
        d = tmp_path / name
        first = mod.RunDirectory(d, cfg)
        second = mod.RunDirectory(d, cfg)
        assert (first.run_id, second.run_id) == (1, 2)
        assert first.artifact("metrics.h5") == d / "1" / "metrics.h5"
        first.artifact("metrics.h5")  # registered once
        first.finish({"acc": 0.5})
        second.fail(ValueError("boom"))
        runs[name] = [json.loads((d / str(i) / "run.json").read_text())
                      for i in (1, 2)]
        assert json.loads((d / "1" / "config.json").read_text()) == cfg
    for port, jax in zip(runs["port"], runs["jax"]):
        assert set(port) == set(jax)
        for k in ("status", "artifacts", "result", "fail_trace"):
            assert port.get(k) == jax.get(k), k
    assert runs["port"][0]["status"] == "COMPLETED"
    assert runs["port"][0]["artifacts"] == ["metrics.h5"]
    assert runs["port"][1]["status"] == "FAILED"
    assert runs["port"][1]["fail_trace"] == "boom"
