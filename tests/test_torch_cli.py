"""The port's command lines against the JAX package's: `train_bnn` and
`eval_bnn` of `bnn_priors_tpu_torch.experiments` beside
`experiments/train_bnn.py` and `experiments/eval_bnn.py`.

Both sides run on `data=fake_cifar10 model=googleresnet`, monkeypatched to
FakeCIFAR10(n_train=100, n_test=25) and a depth-8 ResNet, warm started
from one JAX-written sample bank, in float32 at temperature 0 with the
augmentation off and one fixed minibatch order (`_epoch_perm`) on both
runner classes. The JAX runs are shared through module-scoped fixtures.
The K-chain CLI is in test_torch_cli_chains.py.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.data import FakeCIFAR10 as JaxFakeCIFAR10
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxReject
from bnn_priors_tpu.inference.runner import SGLDRunner as JaxRunner
from bnn_priors_tpu.io import HDF5ModelSaver as JaxModelSaver
from bnn_priors_tpu.io import load_samples as jax_load_samples
from bnn_priors_tpu.models import google_resnet as jax_gr
from bnn_priors_tpu_torch import exp_utils, models, precision
from bnn_priors_tpu_torch.data import FakeCIFAR10
from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
from bnn_priors_tpu_torch.inference import (SGLDRunner,
                                            VerletSGLDRunnerReject)
from bnn_priors_tpu_torch.io import load_metrics, load_samples

from test_torch_models import torch_threads_per_worker  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
N_TRAIN, N_TEST = 100, 25
PERM = np.random.RandomState(7).permutation(N_TRAIN)
# one cycle of 3 epochs (1 warmup, 2 sampling), 3 full batches + a tail
CFG = dict(data="fake_cifar10", model="googleresnet",
           inference="VerletSGLDReject", reject_samples=True,
           temperature=0.0, cycles=1, warmup=1, burnin=0, n_samples=2,
           skip=1, skip_first=0, batch_size=32, lr=1e-3, metrics_skip=1,
           progressbar=False, device="cpu")
GET_MODEL = exp_utils.get_model  # the registry, unpatched
# float32 on both sides, the frameworks summing in their own orders
RTOL, ATOL = 1e-4, 1e-5


def load_jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class JaxNoAug(JaxFakeCIFAR10):
    augment_fn = None


class PortNoAug(FakeCIFAR10):
    augment_fn = None


def port_resnet8(name, device="cuda", dtype=torch.float32, seed=0,
                 **priors):
    net = models.ResNet(depth=8).to(dtype)
    net.init(torch.Generator().manual_seed(int(seed)))
    return net.to(device)


@pytest.fixture(scope="module")
def patched():
    """both packages' data and model registries cut to the test's size, and
    one minibatch order for both reject runners"""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_exp, "get_data_seeded", lambda name, seed: JaxNoAug(
        n_train=N_TRAIN, n_test=N_TEST, seed=int(seed)))
    mp.setattr(jax_exp, "get_model", lambda *a: jax_gr.ResNet(depth=8))
    mp.setattr(exp_utils, "get_data_seeded",
               lambda name, seed, device="cuda": PortNoAug(
                   n_train=N_TRAIN, n_test=N_TEST, seed=int(seed),
                   device=device))
    mp.setattr(exp_utils, "get_model", port_resnet8)
    fixed = lambda self, cycle, epoch: PERM
    for cls in (JaxRunner, JaxReject, SGLDRunner, VerletSGLDRunnerReject):
        mp.setattr(cls, "_epoch_perm", fixed)
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    "a JAX-written one-sample bank: a JAX init with He weights, f32"
    params, state = jax_gr.ResNet(depth=8).init(jax.random.key(0),
                                                dtype=jnp.float32)
    params = jax_exp.he_initialize(params, jax.random.key(1))
    path = tmp_path_factory.mktemp("bank") / "samples.pt"
    with JaxModelSaver(str(path)) as saver:
        saver.add_state_dict({k: np.asarray(v) for k, v in
                              {**params, **state}.items()}, step=0)
    return str(path)


def only_dir(log_dir):
    dirs = [d for d in Path(log_dir).iterdir() if d.is_dir()]
    assert len(dirs) == 1, dirs
    return dirs[0]


@pytest.fixture(scope="module")
def cli_run(patched, bank, tmp_path_factory):
    """`cli_run(package, inference)`: that package's CLI on the shared
    config and warm start, run once a module"""
    runs = {}

    def run(package, inference):
        if (package, inference) not in runs:
            log_dir = tmp_path_factory.mktemp(f"{package}_{inference}")
            cli = load_jax_cli("train_bnn") if package == "jax" else train_bnn
            cfg = dict(cli.DEFAULTS)
            # only GGMC can reject: the SGLD kernel's ΔE is infinite
            cfg.update(CFG, inference=inference,
                       reject_samples=inference == "VerletSGLDReject",
                       load_samples=bank, log_dir=str(log_dir))
            runs[package, inference] = cli.main(cfg), only_dir(log_dir)
        return runs[package, inference]
    return run


@pytest.fixture(scope="module")
def jax_single(cli_run):
    return cli_run("jax", "VerletSGLDReject")


@pytest.fixture(scope="module")
def port_single(cli_run):
    return cli_run("port", "VerletSGLDReject")


def metric_names(path):
    "every dataset of a metrics file (nested names such as acceptance/*)"
    import h5py
    names = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: names.append(k)
                     if isinstance(v, h5py.Dataset) else None)
    return sorted(k for k in names if not k.startswith("timings/")
                  and k != "timestamps")


def assert_close(a, b, err_msg, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=RTOL,
                               atol=atol, equal_nan=True, err_msg=err_msg)


def assert_metrics_close(ours, ref, names):
    """the port's metric series against the JAX package's, NaN and ±inf
    where the reference has them (the SGLD kernel's ΔE is infinite). Two
    kinds of series are sums that cancel, so f32 bounds their error by the
    size of their terms:
    * ΔE and the total energy sum terms of the size of N·U (N the
      training points, U the largest logged potential; 3.9e4 here):
      measured up to 3.4e-3 absolute, 8.6e-8 of N·U, bounded at 1e-6 of it;
    * a leaf's configurational temperature ⟨θ,g⟩·N/d sums gradient entries,
      which carry ~1.5e-3 of the gradient's scale in f32 (JAX 6.7e-5, port
      2.2e-5 from an f64 gradient of scale 4.4e-2), and cancel for the
      batchnorm leaves: measured up to 3.1% of the series' largest value
      (net.3.main.1.weight), bounded at 10% of it."""
    energy = N_TRAIN * np.nanmax(np.abs(np.asarray(ref["potential"])))
    for name in names:
        r = np.asarray(ref[name], dtype=np.float64)
        finite = np.abs(r[np.isfinite(r)])
        atol = 0.0
        if name in ("delta_energy", "total_energy"):
            atol = 1e-6 * energy
        elif name.startswith("est_config_temp/") and finite.size:
            atol = 0.1 * finite.max()
        assert_close(ours[name], r, name, atol=max(ATOL, atol))


# what each runner must log beside the minibatch series
MUST = {"SGLD": (),
        "VerletSGLD": ("delta_energy", "total_energy"),
        "SGLDReject": ("delta_energy",),
        "VerletSGLDReject": ("delta_energy", "acceptance/rejected")}


def test_single_chain_matches_the_jax_cli(jax_single, port_single):
    assert_runs_match(jax_single, port_single, "VerletSGLDReject")


def assert_runs_match(jax_run, port_run, inference):
    """two single-chain run dirs of the two CLIs on the same warm start,
    order and T=0: the same config keys, artifacts, metric series, samples
    and result"""
    (jres, jdir), (tres, tdir) = jax_run, port_run
    jcfg = json.loads((jdir / "config.json").read_text())
    tcfg = json.loads((tdir / "config.json").read_text())
    assert set(jcfg) == set(tcfg)
    jrun = json.loads((jdir / "run.json").read_text())
    trun = json.loads((tdir / "run.json").read_text())
    assert jrun["status"] == trun["status"] == "COMPLETED"
    # the JAX CLI also registers its checkpoint path, which it writes only
    # with checkpoint_every; the port registers it only then
    assert trun["artifacts"] == [a for a in jrun["artifacts"]
                                 if a != "chain.ckpt.npz"]
    assert trun["artifacts"] == ["metrics.h5", "samples.pt"]

    names = metric_names(jdir / "metrics.h5")
    assert names == metric_names(tdir / "metrics.h5")
    for must in ("potential", "test/acc", "acceptance/is_sample",
                 "est_temperature/net.0.weight_prior.p",
                 "preconditioner/net.0.weight_prior.p") + MUST[inference]:
        assert must in names, must
    jm = load_metrics(jdir / "metrics.h5", names)
    tm = load_metrics(tdir / "metrics.h5", names)
    np.testing.assert_array_equal(tm["steps"], jm["steps"])
    assert_metrics_close(tm, jm, names)

    js = jax_load_samples(str(jdir / "samples.pt"), keep_steps=True)
    ts = load_samples(str(tdir / "samples.pt"), keep_steps=True)
    assert set(js) == set(ts)
    np.testing.assert_array_equal(ts["steps"], js["steps"])
    assert len(ts["steps"]) == 2
    for k in js:
        assert_close(ts[k], js[k], k)

    assert set(tres) == set(jres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=RTOL, err_msg=k)


def _port_run(cfg, log_dir):
    full = dict(train_bnn.DEFAULTS)
    full.update(CFG, log_dir=str(log_dir), **cfg)
    return train_bnn.main(full), only_dir(log_dir)


def test_augmented_run_is_finite(patched, bank, tmp_path, monkeypatch):
    "FakeCIFAR10 with its augment_fn, at temperature 1"
    monkeypatch.setattr(exp_utils, "get_data_seeded",
                        lambda name, seed, device="cuda": FakeCIFAR10(
                            n_train=N_TRAIN, n_test=N_TEST, seed=int(seed),
                            device=device))
    seen = []
    real = FakeCIFAR10.augment_fn
    monkeypatch.setattr(FakeCIFAR10, "augment_fn", staticmethod(
        lambda x, g: seen.append(x.shape) or real(x, g)))
    res, d = _port_run(dict(load_samples=bank, temperature=1.0), tmp_path)
    pots = load_metrics(d / "metrics.h5", ["potential"])["potential"]
    assert np.all(np.isfinite(pots)) and len(pots) == 3 * 4 + 1 + 2
    # every minibatch step, none of the boundaries: 3 epochs × 4 steps
    assert len(seen) == 12 and seen[0] == (32, 3, 32, 32)
    assert np.isfinite(res["lp_ensemble"])


@pytest.mark.parametrize("inference", ["SGLD", "VerletSGLD", "SGLDReject"])
def test_plain_inference_writes_the_artifacts(patched, tmp_path, inference):
    res, d = _port_run(dict(inference=inference, reject_samples=False,
                            temperature=1.0), tmp_path)
    run = json.loads((d / "run.json").read_text())
    assert run["status"] == "COMPLETED" and run["result"] == res
    for artifact in ("config.json", "run.json", "metrics.h5", "samples.pt"):
        assert (d / artifact).exists(), artifact
    bank = load_samples(str(d / "samples.pt"), keep_steps=True)
    assert len(bank["steps"]) == 2
    assert {"lp_ensemble", "lp_last", "acc_ensemble", "acc_last"} == set(res)
    m = load_metrics(d / "metrics.h5", ["steps", "potential", "test/acc"])
    assert np.all(np.isfinite(m["potential"]))


def test_eval_bnn_reproduces_a_run(port_single, tmp_path):
    res, d = port_single
    cfg = dict(eval_bnn.DEFAULTS)
    cfg.update(run_dir=str(d), skip_first=0, device="cpu",
               calibration_eval=True, log_dir=str(tmp_path))
    out = eval_bnn.main(cfg)
    assert {"ece", "ace", "rmsce"} <= set(out)
    assert 0.0 <= out["ece"] <= 1.0
    for k in res:
        np.testing.assert_allclose(out[k], res[k], rtol=1e-6, err_msg=k)


def test_eval_bnn_on_a_jax_run_dir(jax_single, tmp_path):
    _, d = jax_single
    jcfg = dict(load_jax_cli("eval_bnn").DEFAULTS)
    jcfg.update(run_dir=str(d), skip_first=0, device="cpu",
                calibration_eval=True, log_dir=str(tmp_path / "jax"))
    jout = load_jax_cli("eval_bnn").main(jcfg)
    cfg = dict(eval_bnn.DEFAULTS)
    cfg.update(run_dir=str(d), skip_first=0, device="cpu",
               calibration_eval=True, log_dir=str(tmp_path / "port"))
    out = eval_bnn.main(cfg)
    assert set(out) == set(jout)
    for k in jout:
        np.testing.assert_allclose(out[k], jout[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("key,value", [
    ("profile_dir", "p"),
    ("n_devices", 2), ("coordinator_address", "localhost:1234"),
    ("num_processes", 2), ("process_id", 0), ("chain_group_size", 2),
    ("eval_skip", 2), ("matmul_precision", "highest")])
def test_unported_keys_raise(tmp_path, key, value):
    """the keys once refused are all ported now (the CLI keeps no list of
    unported keys): each is accepted (test_torch_profile.py runs
    `profile_dir`, test_torch_distributed.py the multi-process keys,
    `test_n_devices_splits_the_bank` below `n_devices`,
    test_torch_precision.py every `matmul_precision`), and what they
    cannot run is refused before any run dir: more devices than there
    are, naming both counts, and a multi-process run without its
    coordinator and rank"""
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(CFG, log_dir=str(tmp_path), **{key: value})
    assert not hasattr(train_bnn, "UNPORTED")
    if key in ("chain_group_size", "eval_skip", "profile_dir",
               "coordinator_address", "process_id", "matmul_precision"):
        train_bnn.check_config(cfg)
        if key == "matmul_precision":  # JAX's legacy name of float32
            assert precision.mode_of(value) is precision.MODES["float32"]
        return
    if key == "n_devices":  # the CPU is one device unless raised
        cfg["n_chains"] = 2
        with pytest.raises(ValueError, match="n_devices=2 but only 1"):
            train_bnn.main(cfg)
    elif key == "num_processes":
        with pytest.raises(ValueError, match="coordinator_address and "
                                             "process_id"):
            train_bnn.main(cfg)
    assert not any(tmp_path.iterdir())  # refused before any run dir


def test_n_devices_splits_the_bank(patched, bank, tmp_path, monkeypatch):
    """n_chains=2 n_devices=2 on two CPU positions: two sub-banks, the same
    chain dirs and results as one bank; n_devices with one chain is
    refused"""
    from bnn_priors_tpu_torch import device
    monkeypatch.setenv(device.CPU_DEVICES_ENV, "2")
    out = {}
    for n in (None, 2):
        cfg = dict(train_bnn.DEFAULTS)
        cfg.update(CFG, n_chains=2, n_devices=n, load_samples=bank,
                   log_dir=str(tmp_path / str(n)))
        out[n] = train_bnn.main(cfg)
    assert len(out[2]["chain_dirs"]) == 2
    for a, b in zip(out[2]["chains"] + [out[2]["pooled"]],
                    out[None]["chains"] + [out[None]["pooled"]]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    cfg.update(n_chains=1, log_dir=str(tmp_path / "one"))
    with pytest.raises(ValueError, match="needs n_chains > 1"):
        train_bnn.main(cfg)
    assert not (tmp_path / "one").exists()


@pytest.mark.parametrize("inference", ["SGLD", "VerletSGLD", "SGLDReject"])
def test_plain_chain_kernels_raise(patched, bank, tmp_path, inference):
    """the SGLD-family inferences with n_chains=2, once refused, run: two
    chain run dirs COMPLETED and finite per-chain and pooled results (held
    to the JAX CLI in test_torch_cli_chain_inferences.py)"""
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(CFG, inference=inference, n_chains=2, load_samples=bank,
               reject_samples=inference == "SGLDReject",
               log_dir=str(tmp_path))
    summary = train_bnn.main(cfg)
    assert len(summary["chain_dirs"]) == 2 and summary["n_diverged"] == 0
    for res in summary["chains"] + [summary["pooled"]]:
        assert res and all(np.isfinite(v) for v in res.values())
    for d in summary["chain_dirs"]:
        rj = json.loads((Path(d) / "run.json").read_text())
        assert rj["status"] == "COMPLETED"


@pytest.mark.parametrize("key", ["n_devices"])
def test_unported_eval_keys_raise(tmp_path, key):
    """n_devices larger than the devices there are (the CPU is one) raises,
    naming both counts, before the run dir (JAX eval_bnn.py:59-66); ood_eval
    and marglik_eval are ported (test_torch_cli_eval_trio.py)"""
    cfg = dict(eval_bnn.DEFAULTS)
    cfg.update(run_dir=str(tmp_path), device="cpu",
               log_dir=str(tmp_path / "eval"), **{key: 2})
    with pytest.raises(ValueError, match="n_devices=2 but only 1 device"):
        eval_bnn.main(cfg)
    assert not (tmp_path / "eval").exists()


def test_eval_bnn_splits_the_bank_over_devices(port_single, tmp_path,
                                               monkeypatch):
    """eval_bnn n_devices=2 on two CPU positions: the bank split over both,
    the same result as one device"""
    from bnn_priors_tpu_torch import device
    monkeypatch.setenv(device.CPU_DEVICES_ENV, "2")
    res, d = port_single
    out = {}
    for n in (None, 2):
        cfg = dict(eval_bnn.DEFAULTS)
        cfg.update(run_dir=str(d), skip_first=0, device="cpu",
                   calibration_eval=True, n_devices=n,
                   log_dir=str(tmp_path / str(n)))
        out[n] = eval_bnn.main(cfg)
    assert out[2] == out[None]


def test_devices(tmp_path):
    "the default device is the card, and 'tpu' is not a device of the port"
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(CFG, device="tpu", log_dir=str(tmp_path))
    with pytest.raises(ValueError, match="tpu"):
        train_bnn.main(cfg)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cli in (train_bnn, eval_bnn):
        cfg = dict(cli.DEFAULTS, log_dir=str(tmp_path))
        if cli is train_bnn:
            cfg.update(CFG, device="cuda")
        assert cfg["device"] == "cuda" or cli is train_bnn
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(cfg)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("key", ["weight_prior_params", "bias_prior_params"])
def test_prior_params_raise(patched, tmp_path, monkeypatch, key):
    """a parameter the prior does not take (gaussian has no df) fails the
    run with the constructor's TypeError, as in the JAX package"""
    monkeypatch.setattr(exp_utils, "get_model", GET_MODEL)
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(CFG, log_dir=str(tmp_path), **{key: {"df": 3.0}})
    with pytest.raises(TypeError, match="df"):
        train_bnn.main(cfg)
    run = json.loads((only_dir(tmp_path) / "run.json").read_text())
    assert run["status"] == "FAILED"


def test_a_failed_run_records_failed(patched, tmp_path):
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(CFG, init_method="nonsense", log_dir=str(tmp_path))
    with pytest.raises(ValueError, match="init_method"):
        train_bnn.main(cfg)
    run = json.loads((only_dir(tmp_path) / "run.json").read_text())
    assert run["status"] == "FAILED" and "init_method" in run["fail_trace"]


@pytest.mark.parametrize("method", ["he", "he_uniform", "he_zerobias"])
def test_initializers_follow_the_jax_family(method):
    """each init_method draws every leaf from the JAX initializer's family:
    the same zero leaves, the same bounds, standard deviations within 25%
    (the two draw from different generators)"""
    params, _ = jax_gr.ResNet(depth=8).init(jax.random.key(0),
                                            dtype=jnp.float64)
    ref = getattr(jax_exp, method + "_initialize")(params, jax.random.key(2))
    net = models.ResNet(depth=8).to(torch.float64)
    getattr(exp_utils, method + "_initialize")(
        net, torch.Generator().manual_seed(2))
    ours = {k: v.detach().numpy() for k, v in net.params().items()}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        a, b = ours[k], np.asarray(v)
        assert a.shape == b.shape, k
        if not b.any():
            assert not a.any(), k
            continue
        if b.size >= 256:
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.25,
                                       err_msg=k)
            if method == "he_uniform":  # the same bound, up to sampling
                np.testing.assert_allclose(np.abs(a).max(), np.abs(b).max(),
                                           rtol=0.05, err_msg=k)


def test_the_module_entry_point(tmp_path):
    """`python -m ... with k=v` parses its argv with the port's parse_cli
    and refuses a TPU before it makes a run dir"""
    out = subprocess.run(
        [sys.executable, "-m", "bnn_priors_tpu_torch.experiments.train_bnn",
         "with", "device=tpu", f"log_dir={tmp_path}"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "device='tpu'" in out.stderr
    assert not any(tmp_path.iterdir())


def test_argv_drives_a_run(patched, bank, tmp_path):
    "the same config through `with k=v` argv gives the same run"
    from bnn_priors_tpu_torch.exp.config import parse_cli
    argv = ["with"] + [f"{k}={v}" for k, v in CFG.items()] + [
        f"load_samples={bank}", f"log_dir={tmp_path}", "n_samples=1",
        "save_samples=False"]
    res = train_bnn.main(parse_cli(train_bnn.DEFAULTS, argv))
    run = json.loads((only_dir(tmp_path) / "run.json").read_text())
    assert run["status"] == "COMPLETED" and run["result"] == res
    assert run["artifacts"] == ["metrics.h5"]


def test_without_h5py_the_cli_raises(patched, tmp_path, monkeypatch):
    "no run file is dropped silently: the run fails and says why"
    from bnn_priors_tpu_torch.io import hdf5
    monkeypatch.setattr(hdf5, "HAVE_H5PY", False)
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(CFG, log_dir=str(tmp_path))
    with pytest.raises(ImportError, match="h5py"):
        train_bnn.main(cfg)
    run = json.loads((only_dir(tmp_path) / "run.json").read_text())
    assert run["status"] == "FAILED" and "h5py" in run["fail_trace"]


def test_imports_leave_out_jax_sklearn_and_tqdm():
    """every module of the port, in a fresh interpreter: no jax, no
    sklearn, and no tqdm beyond what torch itself imports"""
    code = """
import sys, pkgutil, importlib, torch
before = set(sys.modules)
import bnn_priors_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
bad = [m for m in new if m.split(".")[0] in ("jax", "jaxlib", "sklearn",
                                             "tqdm", "bnn_priors_tpu")]
assert not bad, bad
print(len([m for m in new if m.startswith("bnn_priors_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 40
