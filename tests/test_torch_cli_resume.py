"""The port's `train_bnn` with `checkpoint_every` and `resume_from`, for one
chain and for K chains: the checkpoint files take the JAX CLI's names
(`chain.ckpt.npz`, `chains.ckpt.npz`) in the run dir, and a run stopped
after epoch 2 and resumed in a fresh run dir continues to the
uninterrupted run's samples and metric rows, bit for bit, at temperature 1.
Data, model and warm start are test_torch_cli.py's.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from bnn_priors_tpu_torch.experiments import train_bnn
from bnn_priors_tpu_torch.io import load_metrics, load_samples

from test_torch_cli import (CFG, bank, metric_names,  # noqa: F401
                            only_dir, patched)
from test_torch_models import torch_threads_per_worker  # noqa: F401

# two cycles of 2 epochs (1 warmup, 1 sampling); the stopped run is one
# cycle of the same epochs
FULL = dict(CFG, temperature=1.0, cycles=2, n_samples=2)
STOPPED = dict(FULL, cycles=1, n_samples=1, checkpoint_every=1)


def _run(cfg, log_dir):
    full = dict(train_bnn.DEFAULTS)
    full.update(cfg, log_dir=str(log_dir))
    return train_bnn.main(full)


def _rows(path):
    """{(name, step): value} of a metrics file, but the wall-clock timings
    and the missing entries (NaN; -2**63 in an integer series)"""
    names = metric_names(path)
    m = load_metrics(path, names + ["steps"])
    missing = lambda v: (v == np.iinfo(np.int64).min if v.dtype.kind == "i"
                         else np.isnan(v))
    return {(n, int(s)): float(v) for n in names
            for s, v in zip(m["steps"], m[n]) if not missing(v)}


def _assert_continues(resumed_dir, full_dir):
    "the resumed run dir's samples and rows are the full run's tail"
    rs = load_samples(str(resumed_dir / "samples.pt"), keep_steps=True)
    fs = load_samples(str(full_dir / "samples.pt"), keep_steps=True)
    assert len(fs["steps"]) == 2
    np.testing.assert_array_equal(rs["steps"], fs["steps"][-1:])
    for k in fs:
        np.testing.assert_array_equal(rs[k][-1], fs[k][-1], err_msg=k)
    rrows = _rows(resumed_dir / "metrics.h5")
    frows = _rows(full_dir / "metrics.h5")
    assert len(rrows) > 50
    assert min(s for _, s in rrows) > 0
    assert {k: frows[k] for k in rrows} == rrows


@pytest.fixture(scope="module")
def single(patched, bank, tmp_path_factory):
    "the uninterrupted run, the stopped run and the resumed run"
    out = {}
    for name, cfg in (("full", FULL), ("stopped", STOPPED)):
        d = tmp_path_factory.mktemp(name)
        out[name] = (_run(dict(cfg, load_samples=bank), d), only_dir(d))
    d = tmp_path_factory.mktemp("resumed")
    ckpt = out["stopped"][1] / "chain.ckpt.npz"
    out["resumed"] = (_run(dict(FULL, load_samples=bank,
                                resume_from=str(ckpt)), d), only_dir(d))
    return out


def test_checkpoint_every_writes_the_jax_file(single):
    _, d = single["stopped"]
    run = json.loads((d / "run.json").read_text())
    assert run["artifacts"] == ["metrics.h5", "samples.pt", "chain.ckpt.npz"]
    assert (d / "chain.ckpt.npz").is_file()
    assert not list(d.glob("*.tmp"))
    with np.load(d / "chain.ckpt.npz") as f:
        assert int(f["meta.next_epoch_index"]) == 2  # the last write
        assert int(f["meta.mstep"]) == 2 * 4 + 1
    _, full = single["full"]
    assert not (full / "chain.ckpt.npz").exists()


def test_resume_continues_the_uninterrupted_run(single):
    res, d = single["resumed"]
    assert d != single["stopped"][1]  # a fresh run dir
    cfg = json.loads((d / "config.json").read_text())
    assert cfg["resume_from"].endswith("chain.ckpt.npz")
    _assert_continues(d, single["full"][1])
    assert np.isfinite(res["lp_ensemble"])


def test_chains_resume_continues_the_uninterrupted_run(patched, bank,
                                                      tmp_path):
    "n_chains=2: `chains.ckpt.npz` in the parent run dir, every chain"
    chains = dict(n_chains=2)
    full = _run(dict(FULL, load_samples=bank, **chains), tmp_path / "full")
    stopped = _run(dict(STOPPED, load_samples=bank, **chains),
                   tmp_path / "stopped")
    parent = Path(stopped["chain_dirs"][0]).parent
    ckpts = list(parent.glob("*/chains.ckpt.npz"))
    assert len(ckpts) == 1
    run = json.loads((ckpts[0].parent / "run.json").read_text())
    assert "chains.ckpt.npz" in run["artifacts"] and "chain_index" not in \
        json.loads((ckpts[0].parent / "config.json").read_text())
    resumed = _run(dict(FULL, load_samples=bank, resume_from=str(ckpts[0]),
                        **chains), tmp_path / "resumed")
    for rd, fd in zip(resumed["chain_dirs"], full["chain_dirs"]):
        _assert_continues(Path(rd), Path(fd))
