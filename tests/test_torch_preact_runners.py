"""The PreAct ResNet-18 through the port's runners and CLI against the JAX
package's: `vwidth_resnet18` at width 4 (44,446 parameters, 48 batchnorm
buffers).

* `VerletSGLDRunnerReject` (GGMC with exact M-H), flat, one chain, f64 at
  temperature 0 on 8x8 images in one fixed order: every logged number, the
  final state (running statistics included) and the bank at rtol 1e-8;
* the JAX run's flat checkpoint carried into the port's runner by
  `interop.load_jax_checkpoint`;
* `train_bnn` on `data=cifar10_small model=vwidth_resnet18 width=4` (the
  synthetic CIFAR-10 files of test_torch_cli_priors.py) against the JAX CLI
  from one sample bank at T=0 in f32 (rtol 1e-4, as test_torch_cli.py), and
  `eval_bnn` on the port's run dir.

The JAX networks take f64 batch statistics (`F64StatsBatchNorm`); each
JAX run is made once a module. The K=2 chain comparison and a data-driven
ResNet-18's JAX checkpoint are in test_torch_data_driven.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.inference.reject import \
    VerletSGLDRunnerReject as JaxRunner
from bnn_priors_tpu.models import conv_nets as jax_cn
from bnn_priors_tpu_torch import exp_utils
from bnn_priors_tpu_torch.experiments import eval_bnn, train_bnn
from bnn_priors_tpu_torch.inference import VerletSGLDRunnerReject
from bnn_priors_tpu_torch.interop import load_jax_checkpoint
from bnn_priors_tpu_torch.io import load_metrics, load_samples
from bnn_priors_tpu_torch.ops import fused_update

from bnn_priors_tpu.io import load_samples as jax_load_samples
from test_torch_cli import assert_close, load_jax_cli, metric_names
from test_torch_cli_mnist import _assert_results_match
from test_torch_cli_priors import N_TRAIN as CIFAR_N, cifar_root  # noqa
from test_torch_models import (F64StatsBatchNorm,  # noqa: F401
                              torch_threads_per_worker)
from test_torch_reject_runner import Recorder

N_TRAIN, N_TEST, BATCH = 32, 8, 16
RUN = dict(epochs_per_cycle=2, warmup_epochs=1, sample_epochs=1,
           learning_rate=1e-3, momentum=0.9, precond_update=1,
           batch_size=BATCH)
PERM = np.random.RandomState(7).permutation(N_TRAIN)
CLOSE = dict(rtol=1e-8, atol=1e-12)


def _data():
    rng = np.random.RandomState(3)
    x = rng.randn(N_TRAIN + N_TEST, 3, 8, 8)
    y = rng.randint(0, 10, N_TRAIN + N_TEST)
    return (x[:N_TRAIN], y[:N_TRAIN]), (x[N_TRAIN:], y[N_TRAIN:])


def _pair(name="vwidth_resnet18", weight_prior="gaussian", wpp=None):
    """(JAX model with f64 batch statistics, port model in f64 with its He
    init) from the two registries, at width 4"""
    (x, y), _ = _data()
    wpp = dict(wpp or {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cn, "BatchNorm2d", F64StatsBatchNorm)
        jm = jax_exp.get_model(jnp.asarray(x), jnp.asarray(y), name, 4, 3,
                               weight_prior, 0.0, 2 ** 0.5, "gaussian", 0.0,
                               1.0, True, dict(wpp), {})
    tm = exp_utils.get_model(name, weight_prior=weight_prior,
                             weight_prior_params=wpp, width=4, device="cpu",
                             dtype=torch.float64)
    exp_utils.he_initialize(tm, torch.Generator().manual_seed(1))
    return jm, tm


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """the JAX single-chain reject runner and its final flat checkpoint,
    once a module"""
    jm, tm = _pair()
    params, state = _np(tm.params()), _np(dict(tm.named_buffers()))
    train, test = (tuple(map(jnp.asarray, d)) for d in _data())
    rec = Recorder()
    jr = JaxRunner(jm, train, test, temperature=0.0, reject_samples=True,
                   init_params={k: jnp.asarray(v) for k, v in params.items()},
                   init_model_state={k: jnp.asarray(v)
                                     for k, v in state.items()},
                   key=jax.random.key(0), packing="flat", metrics_saver=rec,
                   **RUN)
    jr._epoch_perm = lambda cycle, epoch: PERM
    jr.run()
    ckpt = str(tmp_path_factory.mktemp("jax") / "chain.ckpt.npz")
    jr.save_checkpoint(ckpt, 2, 4)

    return jr, rec, ckpt


def _port_runner(tm, saver=None, reject_samples=True):
    train, test = (tuple(map(torch.as_tensor, d)) for d in _data())
    tr = VerletSGLDRunnerReject(tm, train, test, temperature=0.0,
                                reject_samples=reject_samples,
                                metrics_saver=saver, device="cpu",
                                packing="flat", **RUN)
    tr._epoch_perm = lambda cycle, epoch: PERM
    return tr


def test_reject_runner_matches_jax_step_for_step(jax_run):
    jr, jrec, _ = jax_run
    _, tm = _pair()
    trec = Recorder()
    tr = _port_runner(tm, trec)
    assert tr.kernel.packer.names == jr.kernel.packer.names
    before = fused_update.launches
    tr.run()
    assert fused_update.launches == before  # the CPU runs the plain version
    keys = {k for k in jrec.rows if not k[0].startswith("timings/")}
    assert keys == {k for k in trec.rows if not k[0].startswith("timings/")}
    assert {"delta_energy", "acceptance/rejected", "test/acc",
            "preconditioner/net.layer4.1.bn2.weight"} <= {k[0] for k in keys}
    bad = {k: (trec.rows[k], jrec.rows[k]) for k in sorted(keys)
           if not np.isclose(trec.rows[k], jrec.rows[k], **CLOSE)}
    assert not bad, list(bad.items())[:10]
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd)
    assert sum("running_var" in k for k in tsd) == 16
    for k in jsd:
        np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]), err_msg=k,
                                   **CLOSE)
    ts, js = tr.get_samples(), jr.get_samples()
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), err_msg=k,
                                   **CLOSE)


def test_jax_checkpoint_loads_by_name(jax_run):
    """the JAX run's flat `chain.ckpt.npz` into a fresh port runner: every
    parameter and running statistic by name"""
    jr, _, ckpt = jax_run
    _, tm = _pair()
    tr = _port_runner(tm)
    assert load_jax_checkpoint(ckpt, tr) == (2, 4)
    tsd, jsd = tr.current_state_dict(), jr.current_state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k], np.asarray(jsd[k]), err_msg=k)


# -- the CLIs ----------------------------------------------------------------

CFG = dict(data="cifar10_small", model="vwidth_resnet18", width=4,
           inference="VerletSGLDReject", reject_samples=True, temperature=0.0,
           cycles=1, warmup=1, burnin=0, n_samples=1, skip=1, skip_first=0,
           batch_size=16, lr=1e-3, metrics_skip=1, progressbar=False,
           device="cpu")


@pytest.fixture(scope="module")
def cli_runs(cifar_root, tmp_path_factory):
    """the JAX and the port CLI from one sample bank, in one fixed order,
    flat states on both sides"""
    perm = np.random.RandomState(7).permutation(CIFAR_N)
    mp = pytest.MonkeyPatch()
    mp.setenv("BNN_PRIORS_DATA", cifar_root)
    for cls in (JaxRunner, VerletSGLDRunnerReject):
        mp.setattr(cls, "_epoch_perm", lambda self, cycle, epoch: perm)
    cfg = dict(train_bnn.DEFAULTS, **CFG)
    tm = train_bnn.model_of(cfg, "cpu")
    exp_utils.he_initialize(tm, torch.Generator().manual_seed(1))
    sd = _np(tm.state_dict())
    # the JAX CLI's model answers its init with the bank's f32 values (its
    # warm start overwrites them; JAX's per-leaf samplers cost a compile a
    # shape) and its runner packs flat, as the port's
    real_get_model, real_init = jax_exp.get_model, JaxRunner.__init__

    def get_model(*args):
        jm = real_get_model(*args)
        jm.init = lambda key, prefix="", dtype=None: tuple(
            {k: jnp.asarray(sd[k], jnp.int32 if "num_batches" in k
                            else jnp.float32) for k in names}
            for names in (tm.params(), dict(tm.named_buffers())))
        return jm

    def flat_init(self, *args, **kwargs):
        kwargs.setdefault("packing", "flat")
        real_init(self, *args, **kwargs)
    mp.setattr(jax_exp, "get_model", get_model)
    mp.setattr(JaxRunner, "__init__", flat_init)
    try:
        bank = str(tmp_path_factory.mktemp("bank") / "bank.pt")
        from bnn_priors_tpu_torch.io import HDF5ModelSaver
        with HDF5ModelSaver(bank) as saver:
            saver.add_state_dict(sd, step=0)
        out = {}
        for package, cli in (("jax", load_jax_cli("train_bnn")),
                             ("port", train_bnn)):
            log_dir = tmp_path_factory.mktemp(package)
            c = dict(cli.DEFAULTS, **CFG, load_samples=bank,
                     log_dir=str(log_dir))
            result = cli.main(c)
            out[package] = result, next(p for p in log_dir.iterdir()
                                        if p.is_dir())
    finally:
        mp.undo()
    return out


def _assert_deep_dirs_match(jdir, tdir):
    """the same metric series and samples in both run dirs, at rtol 1e-4
    as test_torch_cli_mnist.py holds them, with two more bounds that f32
    sets at this depth (17 batchnorm layers; measured on the CPU): a leaf's
    kinetic temperature ‖m‖²/d is held as its configurational temperature
    is, at 10% of its series' largest value (measured up to 2.5%, on
    batchnorm leaves, whose momenta sum gradients that cancel), and the
    samples at 5e-5 absolute (measured up to 1.23e-5). The f64 runner
    comparison above holds the same path at 1e-8."""
    names = metric_names(jdir / "metrics.h5")
    assert names == metric_names(tdir / "metrics.h5")
    jm = load_metrics(jdir / "metrics.h5", names)
    tm = load_metrics(tdir / "metrics.h5", names)
    np.testing.assert_array_equal(tm["steps"], jm["steps"])
    energy = CIFAR_N * np.nanmax(np.abs(jm["potential"]))
    for name in names:
        ref = np.asarray(jm[name], dtype=np.float64)
        atol = 1e-5
        if name in ("delta_energy", "total_energy"):
            atol = max(atol, 1e-6 * energy)
        elif name.startswith(("est_config_temp/", "est_temperature/")):
            atol = max(atol, 0.1 * np.nanmax(np.abs(ref)))
        assert_close(tm[name], ref, name, atol=atol)
    js = jax_load_samples(str(jdir / "samples.pt"), keep_steps=True)
    ts = load_samples(str(tdir / "samples.pt"), keep_steps=True)
    assert set(js) == set(ts)
    np.testing.assert_array_equal(ts["steps"], js["steps"])
    for k in js:
        assert_close(ts[k], js[k], k, atol=5e-5)
    return names


def test_train_bnn_matches_the_jax_cli(cli_runs):
    (jres, jdir), (tres, tdir) = cli_runs["jax"], cli_runs["port"]
    names = _assert_deep_dirs_match(jdir, tdir)
    assert {"delta_energy", "preconditioner/net.linear.weight_prior.p"} <= \
        set(names)
    assert load_samples(str(tdir / "samples.pt"))[
        "net.layer4.1.bn2.running_mean"].shape == (1, 32)
    _assert_results_match(tres, jres)
    config = json.loads((tdir / "config.json").read_text())
    assert (config["model"], config["width"]) == ("vwidth_resnet18", 4)


def test_eval_bnn_rebuilds_the_model(cli_runs, cifar_root, tmp_path,
                                     monkeypatch):
    """eval_bnn on the port's run dir rebuilds `vwidth_resnet18` at width
    4 from its config and reproduces the run's result"""
    monkeypatch.setenv("BNN_PRIORS_DATA", cifar_root)
    tres, tdir = cli_runs["port"]
    out = eval_bnn.main(dict(eval_bnn.DEFAULTS, run_dir=str(tdir),
                             skip_first=0, device="cpu",
                             log_dir=str(tmp_path)))
    assert set(out) == set(tres)
    for k in tres:
        np.testing.assert_allclose(out[k], tres[k], rtol=1e-6, err_msg=k)
