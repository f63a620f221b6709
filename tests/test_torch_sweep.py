"""The port's `sweep_tempering` against the JAX package's
(`experiments/sweep_tempering.py`) on the same command: `data=random
model=densenet`, 2 temperatures × 2 replicates as one bank of 4 chains.

At temperature 0 (no noise enters) both sweeps start every chain from the
same parameters and visit the data in the same fixed order a chain (as
test_torch_cli_chain_inferences.py injects them), and every chain's run
directory matches the JAX sweep's in float32 at rtol 1e-4: config keys,
run files, metric series, samples and result. Further: at non-zero
temperatures each chain's runner temperature is its config's
(c = r·len(temperatures) + t), a split bank (`max_chains_per_program`)
gives the same directories and refuses to resume, `eval_bnn` reads a
sweep chain's directory in both packages, and the mesh and multi-process
keys run (`n_devices=2` on two CPU positions gives the one bank's
results) or refuse what cannot run before any run dir. The JAX sweep runs
with `n_devices=1`:
its default, every JAX device, is 8 virtual CPU devices here."""
import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu.io import load_samples as jax_load_samples
from bnn_priors_tpu.parallel import MultiChainRunner as JaxPlain
from bnn_priors_tpu.parallel import MultiChainRunnerReject as JaxReject
from bnn_priors_tpu_torch import exp_utils
from bnn_priors_tpu_torch.experiments import eval_bnn, sweep_tempering
from bnn_priors_tpu_torch.experiments.train_bnn import model_of
from bnn_priors_tpu_torch.io import load_metrics, load_samples
from bnn_priors_tpu_torch.parallel import (MultiChainRunner,
                                           MultiChainRunnerReject)

from test_torch_cli import RTOL, assert_close, load_jax_cli, metric_names
from test_torch_models import torch_threads_per_worker  # noqa: F401

TEMPS, REPS = [0.0, 0.0], 2
K = len(TEMPS) * REPS
N_TRAIN, BATCH = 1000, 100  # RandomData's 2,000 points, half to train
SWEEP = dict(data="random", model="densenet", temperatures=TEMPS,
             replicates=REPS, cycles=1, warmup=1, burnin=0, n_samples=2,
             skip=1, skip_first=0, batch_size=BATCH, lr=1e-3,
             metrics_skip=1, progressbar=False, device="cpu")
INFERENCES = ("VerletSGLD", "VerletSGLDReject")


def _orders(n_chains, n_full, batch):
    "(n_chains, n_full, B): a fixed minibatch order a chain"
    return np.stack([np.random.RandomState(20 + c).permutation(N_TRAIN)[
        :n_full * batch].reshape(n_full, batch) for c in range(n_chains)])


@pytest.fixture(scope="module")
def inits():
    """a prior draw of the densenet a chain (float32 numpy), from the
    port's model of the sweep's config"""
    cfg = dict(sweep_tempering.DEFAULTS, **SWEEP)
    data = exp_utils.get_data_from_config(cfg, device="cpu")
    model = model_of(cfg, "cpu", train=data.norm.train)
    return [{k: v.detach().numpy().copy() for k, v in copy.deepcopy(
        model).init(torch.Generator().manual_seed(100 + c)).params().items()}
        for c in range(K)]


@pytest.fixture(scope="module")
def same_orders_and_inits(inits):
    "both packages' chain runners start from `inits` and visit `_orders`"
    mp = pytest.MonkeyPatch()
    jax_idxs = lambda self, cycle=0, epoch=0: jnp.asarray(
        _orders(self.n_chains, self.n_full, self.batch_size), jnp.int32)
    port_idxs = lambda self, cycle=0, epoch=0: torch.as_tensor(
        _orders(self.n_chains, self.n_full, self.batch_size)).to(self.device)
    for cls in (JaxPlain, JaxReject):
        mp.setattr(cls, "_epoch_idxs", jax_idxs)
    for cls in (MultiChainRunner, MultiChainRunnerReject):
        mp.setattr(cls, "_epoch_idxs", port_idxs)
    jax_init, port_init = JaxPlain.__init__, MultiChainRunner.__init__

    def jax_with_inits(self, *args, **kwargs):
        kwargs["init_params_fn"] = lambda c, key: {
            k: jnp.asarray(v) for k, v in inits[c].items()}
        jax_init(self, *args, **kwargs)

    def port_with_inits(self, *args, **kwargs):
        kwargs["init_params_fn"] = lambda c, g: {
            k: torch.as_tensor(v) for k, v in inits[c].items()}
        port_init(self, *args, **kwargs)
    mp.setattr(JaxPlain, "__init__", jax_with_inits)
    mp.setattr(MultiChainRunner, "__init__", port_with_inits)
    yield
    mp.undo()


def _sweep(package, log_dir, **kw):
    "the package's sweep on SWEEP + kw: (results, chain dirs in order)"
    cli = load_jax_cli("sweep_tempering") if package == "jax" \
        else sweep_tempering
    cfg = dict(cli.DEFAULTS)
    cfg.update(SWEEP, log_dir=str(log_dir), **kw)
    if package == "jax":
        cfg["n_devices"] = 1
    results = cli.main(cfg)
    dirs = sorted((d for d in Path(log_dir).iterdir() if d.is_dir()),
                  key=lambda d: int(d.name))
    return results, dirs


@pytest.fixture(scope="module")
def sweeps(same_orders_and_inits, tmp_path_factory):
    "sweeps(inference): (JAX sweep, port sweep) at T=0, run once a module"
    runs = {}

    def run(inference):
        if inference not in runs:
            runs[inference] = tuple(
                _sweep(p, tmp_path_factory.mktemp(p + inference),
                       inference=inference) for p in ("jax", "port"))
        return runs[inference]
    return run


def _series_close(ours, ref, names):
    """the metric series at rtol 1e-4, with three kinds held to the size of
    their terms (the first two as test_torch_cli.assert_metrics_close, at
    this data's N): ΔE and the total energy to 1e-6 of N·U, a leaf's
    configurational temperature to 10% of its series' largest value, and
    the log prior, whose ~3,300 terms of either sign pass near 0 in the
    series, to rtol 1e-4 of its largest value (measured: 5.4e-5 at a value
    of 0.128 in a series up to 40, 1.4e-6 of it)"""
    energy = N_TRAIN * np.nanmax(np.abs(np.asarray(ref["potential"])))
    for name in names:
        r = np.asarray(ref[name], dtype=np.float64)
        finite = np.abs(r[np.isfinite(r)])
        atol = 1e-5
        if name in ("delta_energy", "total_energy"):
            atol = max(atol, 1e-6 * energy)
        elif name.startswith("est_config_temp/") and finite.size:
            atol = max(atol, 0.1 * finite.max())
        elif name == "log_prior":
            atol = max(atol, RTOL * finite.max())
        assert_close(ours[name], r, name, atol=atol)


@pytest.mark.parametrize("inference", INFERENCES)
def test_sweep_matches_the_jax_sweep(sweeps, inference):
    """K chain dirs in chain order, each as the JAX sweep's: config keys
    and the chain's grid position, run files, metric series, samples and
    result (rtol 1e-4)"""
    (jres, jdirs), (tres, tdirs) = sweeps(inference)
    assert len(jdirs) == len(tdirs) == len(jres) == len(tres) == K
    for c, (jd, td) in enumerate(zip(jdirs, tdirs)):
        jcfg = json.loads((jd / "config.json").read_text())
        tcfg = json.loads((td / "config.json").read_text())
        assert set(tcfg) == set(jcfg)
        r, t = divmod(c, len(TEMPS))
        for k, v in dict(chain_index=c, replicate=r, temperature=TEMPS[t],
                         n_chains=K, temperatures=TEMPS).items():
            assert tcfg[k] == jcfg[k] == v, k
        jrun = json.loads((jd / "run.json").read_text())
        trun = json.loads((td / "run.json").read_text())
        assert trun["status"] == jrun["status"] == "COMPLETED"
        assert trun["artifacts"] == jrun["artifacts"] == ["samples.pt",
                                                          "metrics.h5"]
        names = metric_names(jd / "metrics.h5")
        assert names == metric_names(td / "metrics.h5")
        assert "potential" in names and "test/acc" in names
        assert ("delta_energy" in names) == inference.endswith("Reject")
        jm = load_metrics(jd / "metrics.h5", names)
        tm = load_metrics(td / "metrics.h5", names)
        np.testing.assert_array_equal(tm["steps"], jm["steps"])
        if "acceptance/rejected" in names:  # sure outcomes only
            np.testing.assert_array_equal(tm["acceptance/rejected"],
                                          jm["acceptance/rejected"])
        _series_close(tm, jm, names)
        js = jax_load_samples(str(jd / "samples.pt"), keep_steps=True)
        ts = load_samples(str(td / "samples.pt"), keep_steps=True)
        assert set(ts) == set(js)
        np.testing.assert_array_equal(ts["steps"], js["steps"])
        assert len(ts["steps"]) == 2
        for k in js:
            assert_close(ts[k], js[k], k)
        assert trun["result"] == tres[c]
        assert set(tres[c]) == set(jres[c])
        assert ("acceptance" in tres[c]) == inference.endswith("Reject")
        for k, v in jres[c].items():
            np.testing.assert_allclose(tres[c][k], v, rtol=RTOL, err_msg=k)


def test_eval_bnn_reads_a_sweep_chain_dir(sweeps, tmp_path):
    """the sweep's config carries only the sweep's keys (no init_method
    and the like): both packages' eval_bnn evaluate a port chain dir, the
    port's reproducing the sweep's result for that chain"""
    _, (tres, tdirs) = sweeps("VerletSGLDReject")
    c = K - 1
    out = {}
    for package in ("jax", "port"):
        cli = load_jax_cli("eval_bnn") if package == "jax" else eval_bnn
        cfg = dict(cli.DEFAULTS)
        cfg.update(run_dir=str(tdirs[c]), skip_first=0, device="cpu",
                   log_dir=str(tmp_path / package))
        out[package] = cli.main(cfg)
    for k, v in out["jax"].items():
        np.testing.assert_allclose(out["port"][k], v, rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(out["port"][k], tres[c][k], rtol=1e-6,
                                   err_msg=k)


@pytest.fixture
def runners(monkeypatch):
    "every chain runner the port's sweep runs (the reject one inherits run)"
    seen, real = [], MultiChainRunner.run

    def run(self, *args, **kwargs):
        seen.append(self)
        return real(self, *args, **kwargs)
    monkeypatch.setattr(MultiChainRunner, "run", run)
    return seen


@pytest.mark.parametrize("inference", INFERENCES)
def test_chain_temperatures_follow_the_grid(runners, tmp_path, inference):
    """at non-zero temperatures: one runner of K chains whose temperature
    vector is the configs' temperatures in chain order, the reject runner
    for the reject inference, and each result carries its grid position"""
    temps = [0.1, 1.0]
    results, dirs = _sweep("port", tmp_path, inference=inference,
                           temperatures=temps)
    assert len(runners) == 1 and runners[0].n_chains == K
    assert isinstance(runners[0], MultiChainRunnerReject) == \
        inference.endswith("Reject")
    for c, d in enumerate(dirs):
        cfg = json.loads((d / "config.json").read_text())
        assert cfg["temperature"] == temps[c % len(temps)]
        assert cfg["replicate"] == c // len(temps)
        assert float(runners[0].temperatures[c]) == pytest.approx(
            cfg["temperature"], rel=1e-7)
        assert results[c]["temperature"] == cfg["temperature"]
        assert results[c]["replicate"] == cfg["replicate"]
        assert np.isfinite(results[c]["lp_ensemble"])


def test_split_bank_gives_the_same_directories(runners, tmp_path):
    """max_chains_per_program=3 on 4 chains: two parts of 2 chains with
    their own seeds, one after another; the same K chain dirs (config and
    grid position, run files, result keys) as one bank"""
    one, one_dirs = _sweep("port", tmp_path / "one", temperatures=[0.1, 1.0])
    split, split_dirs = _sweep("port", tmp_path / "split",
                               temperatures=[0.1, 1.0],
                               max_chains_per_program=3)
    assert [r.n_chains for r in runners] == [K, 2, 2]
    assert runners[1].gen.initial_seed() != runners[2].gen.initial_seed()
    assert runners[0].gen.initial_seed() == runners[1].gen.initial_seed()
    assert [d.name for d in one_dirs] == [d.name for d in split_dirs]
    for a, b, ra, rb in zip(one_dirs, split_dirs, one, split):
        ca = json.loads((a / "config.json").read_text())
        cb = json.loads((b / "config.json").read_text())
        assert set(ca) == set(cb)
        assert {k: v for k, v in ca.items() if k not in
                ("log_dir", "max_chains_per_program")} == \
            {k: v for k, v in cb.items() if k not in
             ("log_dir", "max_chains_per_program")}
        ja, jb = (json.loads((d / "run.json").read_text()) for d in (a, b))
        assert ja["status"] == jb["status"] == "COMPLETED"
        assert ja["artifacts"] == jb["artifacts"]
        assert set(ra) == set(rb)
        assert (ra["temperature"], ra["replicate"]) == (rb["temperature"],
                                                        rb["replicate"])


def test_split_bank_refuses_to_resume(tmp_path):
    "resuming a split sweep raises before any chain dir is made"
    with pytest.raises(AssertionError, match="partitioned"):
        _sweep("port", tmp_path, max_chains_per_program=2,
               resume_from=str(tmp_path / "none.npz"))
    assert not any(d.is_dir() for d in tmp_path.iterdir())


def test_checkpoint_and_resume_at_the_end(tmp_path):
    """checkpoint_every writes the bank's state to log_dir/
    sweep_checkpoint.npz; a sweep resumed from the state after the last
    epoch runs nothing and records `n_samples: 0` in each chain dir, as the
    JAX sweep does (sweep_tempering.py:217-221)"""
    _sweep("port", tmp_path / "full", temperatures=[0.1, 1.0],
           checkpoint_every=1)
    ckpt = tmp_path / "full" / "sweep_checkpoint.npz"
    assert ckpt.exists()
    results, dirs = _sweep("port", tmp_path / "resumed",
                           temperatures=[0.1, 1.0], resume_from=str(ckpt))
    assert len(dirs) == K
    for c, res in enumerate(results):
        assert res == {"n_samples": 0, "temperature": [0.1, 1.0][c % 2],
                       "replicate": c // 2}


@pytest.mark.parametrize("n,m", [(30, None), (30, 60), (30, 7), (4, 3),
                                 (5, 1)])
def test_part_bounds_match_the_jax_partition(n, m):
    "parts as even as possible, at most m chains each (JAX :178-183)"
    parts = sweep_tempering.part_bounds(n, m)
    m = m or n
    n_parts = -(-n // m)
    edges = np.linspace(0, n, n_parts + 1).astype(int)
    assert parts == list(zip(edges[:-1].tolist(), edges[1:].tolist()))
    assert all(0 < b - a <= m for a, b in parts)


@pytest.mark.parametrize("key,value", [
    ("n_devices", 2), ("coordinator_address", "localhost:1234"),
    ("num_processes", 2), ("process_id", 0)])
def test_mesh_keys_raise(tmp_path, key, value, monkeypatch):
    """the mesh and multi-process keys run: n_devices=2 on two CPU
    positions gives the one-bank sweep's results, a coordinator or a rank
    alone changes nothing; what cannot run is refused before any run dir:
    more devices than there are (naming both counts), a multi-process run
    without its coordinator and rank (test_torch_distributed.py runs one)"""
    from bnn_priors_tpu_torch import device
    if key == "n_devices":
        with pytest.raises(ValueError, match="n_devices=2 but only 1"):
            _sweep("port", tmp_path, n_devices=2)
        assert not any(tmp_path.iterdir())
        monkeypatch.setenv(device.CPU_DEVICES_ENV, "2")
    elif key == "num_processes":
        with pytest.raises(ValueError, match="coordinator_address and "
                                             "process_id"):
            _sweep("port", tmp_path, num_processes=2)
        assert not any(tmp_path.iterdir())
        return
    results, dirs = _sweep("port", tmp_path / "run", **{key: value})
    assert len(dirs) == len(results) == K
    if key == "n_devices":
        ref, _ = _sweep("port", tmp_path / "one", n_devices=1)
        for a, b in zip(results, ref):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    else:
        assert all(np.isfinite(v) for r in results for v in r.values())


def test_defaults():
    """the JAX sweep's keys, the card by default, its default inference and
    grid (run_experiment.sh's 6 × 5), one bank unless split"""
    jax_defaults = load_jax_cli("sweep_tempering").DEFAULTS
    ours = sweep_tempering.DEFAULTS
    assert set(ours) == set(jax_defaults)
    assert ours["device"] == "cuda" and ours["max_chains_per_program"] is None
    for k in ("inference", "temperatures", "replicates", "data", "model"):
        assert ours[k] == jax_defaults[k], k


def test_the_pipeline_imports_without_jax():
    """with jax unimportable (sys.modules["jax"] = None), the sweep and
    eval CLIs, the evaluation and the data modules import, and neither
    jax nor the JAX package is loaded"""
    import subprocess
    import sys
    code = """
import sys
sys.modules["jax"] = None
import bnn_priors_tpu_torch.experiments.sweep_tempering
import bnn_priors_tpu_torch.experiments.eval_bnn
import bnn_priors_tpu_torch.evaluate
import bnn_priors_tpu_torch.data
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "bnn_priors_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
