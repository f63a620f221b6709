"""The prior grid through the port's CLI and models, beside the JAX
package: potentials of JAX-initialised ResNet-20s with hierarchical and
mixture priors, `train_bnn` on `data=cifar10_small` from local CIFAR-10
files with a Student-t prior and `eval_bnn` on its bank, bias prior
params, and the commands both packages refuse (`weight_prior_params` on
the ResNet-20 models, and the two registry names that need a parameter no
ResNet-20 passes)."""
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
from bnn_priors_tpu.models import google_resnet as jax_gr
from bnn_priors_tpu_torch import exp_utils
from bnn_priors_tpu_torch.data import write_cifar10_batches
from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
from bnn_priors_tpu_torch.interop import load_jax_state
from bnn_priors_tpu_torch.io import load_samples

from test_torch_models import (F64StatsBatchNorm, _batch,  # noqa: F401
                               _jax_potential_and_grad,
                               _port_potential_and_grad,
                               torch_threads_per_worker)

REPO = Path(__file__).resolve().parent.parent
N_TRAIN, N_TEST = 40, 12
X0, Y0 = np.zeros((2, 3, 32, 32), np.float32), np.arange(2) % 10
MODELS = ("googleresnet", "correlatedgoogleresnet")


def jax_model(model, weight_prior="gaussian", weight_params=None,
              bias_prior="gaussian", bias_params=None):
    "the JAX CLI's model (`get_model` with the paper's defaults)"
    return jax_exp.get_model(X0, Y0, model, 0, 20, weight_prior, 0.0,
                             2 ** 0.5, bias_prior, 0.0, 1.0, True,
                             weight_params or {}, bias_params or {})


def port_model(model, weight_prior="gaussian", weight_params=None,
               bias_prior="gaussian", bias_params=None, **kw):
    return exp_utils.get_model(model, weight_prior=weight_prior,
                               bias_prior=bias_prior,
                               weight_prior_params=weight_params,
                               bias_prior_params=bias_params, device="cpu",
                               **kw)


@pytest.mark.parametrize("name", ["gaussian_gamma", "laplace",
                                  "scale_mixture_empirical"])
def test_jax_resnet20_potential(name, monkeypatch):
    """a JAX googleresnet with the prior, its init loaded by name: the
    port's potential and gradient equal JAX's in f64"""
    monkeypatch.setattr(jax_gr, "BatchNorm2d", F64StatsBatchNorm)
    jm = jax_model("googleresnet", name)
    params, state = jm.init(jax.random.key(0), dtype=jnp.float64)
    params = jax_exp.he_initialize(params, jax.random.key(1))
    tm = port_model("googleresnet", name, dtype=torch.float64)
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in state.items()})
    x, y = _batch(n=4)
    jpot, _, jg = _jax_potential_and_grad(jm, params, state, x, y)
    tpot, tg = _port_potential_and_grad(tm, x, y)
    np.testing.assert_allclose(tpot, jpot, rtol=1e-9)
    np.testing.assert_allclose(tg, jg, rtol=1e-9,
                               atol=1e-9 * np.abs(jg).max())


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    "CIFAR-10 python batches of random images, BNN_PRIORS_DATA's layout"
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (N_TRAIN + N_TEST, 3, 32, 32)).astype(np.uint8)
    y = rng.randint(0, 10, N_TRAIN + N_TEST)
    root = tmp_path_factory.mktemp("data")
    write_cifar10_batches(str(root / "CIFAR"), x[:N_TRAIN], y[:N_TRAIN],
                          x[N_TRAIN:], y[N_TRAIN:])
    return str(root)


def _cli(tmp_path, **kw):
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(data="cifar10_small", model="googleresnet",
               inference="VerletSGLDReject", reject_samples=True, cycles=1,
               warmup=1, n_samples=1, burnin=0, skip_first=0, batch_size=16,
               lr=1e-3, metrics_skip=1, progressbar=False, device="cpu",
               log_dir=str(tmp_path))
    cfg.update(kw)
    return cfg


def test_cli_student_t_on_cifar10_files_then_eval(cifar_root, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("BNN_PRIORS_DATA", cifar_root)
    cfg = _cli(tmp_path / "train", weight_prior="student-t")
    result = train_bnn.main(cfg)
    run_dir = next((tmp_path / "train").iterdir())
    assert json.loads((run_dir / "run.json").read_text())["status"] == \
        "COMPLETED"
    assert all(np.isfinite(v) for v in result.values())
    bank = load_samples(str(run_dir / "samples.pt"))
    assert bank["net.14.weight_prior.p"].shape == (1, 10, 64)
    ecfg = dict(eval_bnn.DEFAULTS, run_dir=str(run_dir), skip_first=0,
                device="cpu", log_dir=str(tmp_path / "eval"))
    out = eval_bnn.main(ecfg)
    for k in result:
        np.testing.assert_allclose(out[k], result[k], rtol=1e-5, err_msg=k)


def test_cli_hierarchical_prior_bank_evaluates(cifar_root, tmp_path,
                                               monkeypatch):
    """a bank with a hyper leaf (gaussian_gamma's scale) is evaluated by
    eval_bnn with the run's prior; init_method=prior starts every hyper
    leaf at its pin"""
    monkeypatch.setenv("BNN_PRIORS_DATA", cifar_root)
    cfg = _cli(tmp_path / "train", weight_prior="gaussian_gamma",
               init_method="prior")
    result = train_bnn.main(cfg)
    run_dir = next((tmp_path / "train").iterdir())
    bank = load_samples(str(run_dir / "samples.pt"))
    assert bank["net.14.weight_prior.scale.p"].shape == (1,)
    out = eval_bnn.main(dict(eval_bnn.DEFAULTS, run_dir=str(run_dir),
                             skip_first=0, device="cpu",
                             log_dir=str(tmp_path / "eval")))
    for k in result:
        np.testing.assert_allclose(out[k], result[k], rtol=1e-5, err_msg=k)
    model = train_bnn.model_of(cfg, "cpu", seed=5)
    scale = model.params()["net.14.weight_prior.scale.p"]
    np.testing.assert_allclose(float(scale.detach()),
                               np.log(np.expm1(2 ** 0.5 / 8)), rtol=1e-6)


def test_bias_prior_params_in_both_packages(cifar_root, tmp_path,
                                            monkeypatch):
    """bias_prior=student-t bias_prior_params={"df": 3.0}: both packages
    build the model with df 3 and agree on its log prior; the port's CLI
    runs it"""
    jm = jax_model("googleresnet", bias_prior="student-t",
                   bias_params={"df": 3.0})
    tm = port_model("googleresnet", bias_prior="student-t",
                    bias_params={"df": 3.0}, dtype=torch.float64)
    prior = dict(tm.named_priors())["net.14.bias_prior"]
    assert prior.hypers["df"] == 3.0
    params = {k: v.detach().numpy() for k, v in tm.params().items()}
    np.testing.assert_allclose(
        float(tm.log_prior().detach()),
        float(jm.log_prior({k: jnp.asarray(v) for k, v in params.items()})),
        rtol=1e-9)
    monkeypatch.setenv("BNN_PRIORS_DATA", cifar_root)
    result = train_bnn.main(_cli(tmp_path, bias_prior="student-t",
                                 bias_prior_params={"df": 3.0}))
    assert all(np.isfinite(v) for v in result.values())


@pytest.mark.parametrize("model", MODELS)
def test_weight_prior_params_refused_as_jax(model, cifar_root, tmp_path,
                                           monkeypatch):
    """the ResNet-20 builders hand weight_prior_params to both layer types
    and one of them is a Normal: both packages raise TypeError"""
    monkeypatch.setenv("BNN_PRIORS_DATA", cifar_root)
    name, params = (("student-t", {"df": 3.0}) if model == "googleresnet"
                    else ("convcorrnormal", {"lengthscale": 0.5}))
    with pytest.raises(TypeError, match="unexpected keyword"):
        jax_model(model, name, params)
    with pytest.raises(TypeError, match="unexpected keyword"):
        port_model(model, name, params)
    cfg = _cli(tmp_path, model=model, weight_prior=name,
               weight_prior_params=params)
    with pytest.raises(TypeError, match="unexpected keyword"):
        train_bnn.main(cfg)
    run = json.loads((next(tmp_path.iterdir()) / "run.json").read_text())
    assert run["status"] == "FAILED"


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", ["datadrivencorrdoublegamma",
                                  "fixedcov_gennorm"])
def test_priors_needing_a_parameter_refused_as_jax(model, name):
    "concentration and beta have no default: both packages raise TypeError"
    with pytest.raises(TypeError, match="missing 1 required"):
        jax_model(model, name)
    with pytest.raises(TypeError, match="missing 1 required"):
        port_model(model, name)


@pytest.mark.parametrize("model", MODELS)
def test_unknown_prior_fails_as_jax(model):
    with pytest.raises(AssertionError, match="unknown prior"):
        jax_model(model, "nonsense")
    with pytest.raises(AssertionError, match="unknown prior"):
        port_model(model, "nonsense")


def test_the_port_and_chip_smoke_import_no_jax():
    """every module of the port and chip_smoke.py, in a fresh interpreter:
    neither JAX nor the JAX package is imported"""
    code = """
import sys, pkgutil, importlib
import bnn_priors_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bnn_priors_tpu"))
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("bnn_priors_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 45
