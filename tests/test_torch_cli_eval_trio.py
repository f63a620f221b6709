"""The paper's evaluation trio (`experiments/run_evaluation.sh`) through
both packages' `eval_bnn` on one run directory: the plain call, CIFAR-10-C
with calibration, SVHN with `ood_eval` and the simple marginal likelihood,
the port's results against the JAX CLI's in float32 at rtol 1e-4.

The run directory is the port's `train_bnn` on `data=cifar10` (a depth-8
ResNet in both packages' registries, as test_torch_cli.py patches it),
with every dataset read from synthetic files in the real layouts under
$BNN_PRIORS_DATA: CIFAR-10's python batches, a CIFAR-10-C corruption
(`.npy`, NHWC) and SVHN's `.mat` files."""
import json

import numpy as np
import pytest

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.models import google_resnet as jax_gr
from bnn_priors_tpu_torch import data, exp_utils
from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn

from test_torch_cli import CFG, RTOL, load_jax_cli, only_dir, port_resnet8
from test_torch_models import torch_threads_per_worker  # noqa: F401

N_TRAIN, N_TEST, N_CORRUPT = 64, 32, 48
SVHN_TRAIN, SVHN_TEST = 40, 24
CALLS = {
    "plain": {},
    "calibration": dict(eval_data="cifar10c-gaussian_blur",
                        calibration_eval=True),
    "ood": dict(eval_data="svhn", ood_eval=True),
    "marglik": dict(marglik_eval=True),
}
KEYS = {"plain": {"lp_ensemble", "lp_last", "acc_ensemble", "acc_last"},
        "ood": {"auroc", "auprc"},
        "marglik": {"simple_logmarglik", "mean_loglik", "simple_marglik"}}


def write_files(root, seed=0):
    """synthetic CIFAR-10 batches, a gaussian_blur corruption and SVHN
    files under `root` (the $BNN_PRIORS_DATA layout)"""
    rng = np.random.RandomState(seed)
    n = N_TRAIN + N_TEST
    y = rng.randint(0, 10, n)
    x = rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    for c in range(10):  # a learnable class mark, as FakeCIFAR10's
        x[y == c, :, 2 + c, :] = 255
    cifar = str(root / "CIFAR")
    data.write_cifar10_batches(cifar, x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:],
                               y[N_TRAIN:])
    blur = (x[N_TRAIN:].astype(np.float32) * 0.5 + 60).astype(np.uint8)
    xc = np.concatenate([blur, blur[:N_CORRUPT - N_TEST]])
    data.write_cifar10_c(cifar, "gaussian_blur", xc.transpose(0, 2, 3, 1),
                         np.r_[y[N_TRAIN:], y[N_TRAIN:N_TRAIN + N_CORRUPT
                                              - N_TEST]])
    ys = rng.randint(0, 10, SVHN_TRAIN + SVHN_TEST)
    xs = rng.randint(0, 120, (SVHN_TRAIN + SVHN_TEST, 3, 32, 32))
    data.write_svhn(str(root / "SVHN"), xs[:SVHN_TRAIN], ys[:SVHN_TRAIN],
                    xs[SVHN_TRAIN:], ys[SVHN_TRAIN:])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """the files under a $BNN_PRIORS_DATA, both registries' googleresnet a
    depth-8 ResNet, and the port's run dir of `train_bnn data=cifar10`"""
    root = tmp_path_factory.mktemp("data")
    write_files(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("BNN_PRIORS_DATA", str(root))
    mp.setattr(jax_exp, "get_model", lambda *a: jax_gr.ResNet(depth=8))
    mp.setattr(exp_utils, "get_model", port_resnet8)
    log_dir = tmp_path_factory.mktemp("run")
    cfg = dict(train_bnn.DEFAULTS)
    cfg.update(CFG, data="cifar10", temperature=1.0, log_dir=str(log_dir))
    train_bnn.main(cfg)
    yield only_dir(log_dir)
    mp.undo()


def evaluate_both(run_dir, tmp_path, **kw):
    "(JAX result, port result) of eval_bnn with `kw` on `run_dir`"
    out = []
    for package in ("jax", "port"):
        cli = load_jax_cli("eval_bnn") if package == "jax" else eval_bnn
        cfg = dict(cli.DEFAULTS)
        cfg.update(run_dir=str(run_dir), skip_first=0, device="cpu",
                   log_dir=str(tmp_path / package), **kw)
        out.append(cli.main(cfg))
    return out


@pytest.mark.parametrize("call", list(CALLS))
def test_eval_call_matches_the_jax_cli(run_dir, tmp_path, call):
    """each call's result keys and values as the JAX CLI's (rtol 1e-4);
    the calibration errors and the OOD scores in [0, 1]; the eval run dir
    COMPLETED with the result"""
    jres, tres = evaluate_both(run_dir, tmp_path, **CALLS[call])
    assert set(tres) == set(jres)
    want = (KEYS["ood"] if call == "ood" else KEYS["plain"]
            | ({"ece", "ace", "rmsce"} if call == "calibration" else set())
            | (KEYS["marglik"] if call == "marglik" else set()))
    assert set(tres) == want
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=RTOL, err_msg=k)
    for k in ("ece", "ace", "rmsce", "auroc", "auprc"):
        if k in tres:
            assert 0.0 <= tres[k] <= 1.0, k
    run = json.loads((only_dir(tmp_path / "port") / "run.json").read_text())
    assert run["status"] == "COMPLETED" and run["result"] == tres


def test_ood_in_distribution_is_the_training_data(run_dir, tmp_path):
    """ood_eval scores the training data's test split against eval_data's:
    with eval_data the training data itself the two sets are the same
    points, AUROC ½"""
    _, tres = evaluate_both(run_dir, tmp_path, eval_data="cifar10",
                            ood_eval=True)
    assert tres["auroc"] == 0.5


def test_calibration_reads_the_corruption(run_dir, tmp_path):
    """the calibration call's test set is the corruption file's 48 rows
    (severity None: all of them), not CIFAR-10's 32 test points"""
    ours = exp_utils.get_data("cifar10c-gaussian_blur", device="cpu")
    assert ours.norm.test_X.shape[0] == N_CORRUPT
    assert ours.norm.train_X.shape[0] == N_TRAIN
    plain, calib = (evaluate_both(run_dir, tmp_path / c, **CALLS[c])[1]
                    for c in ("plain", "calibration"))
    assert plain["lp_ensemble"] != calib["lp_ensemble"]
