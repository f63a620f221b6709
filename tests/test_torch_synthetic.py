"""The port's `Synthetic` datasets and the `synthetic.<base>.<prior>` names.

`Synthetic` against the JAX package's with the true model's parameters
carried across (float32): regression labels allclose with the normal draws
injected into JAX's from the port's generator; for classification the
logits allclose, and the port's labels' frequencies against the softmax.
Then `synthetic.random.gaussian` through the port's `train_bnn` (densenet
and classificationdensenet) and `sweep_tempering`, and `eval_bnn` on
their run dirs: the regenerated dataset is bit for bit the run's, and the
evaluation reproduces the run's result.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.data import RandomData as JaxRandom
from bnn_priors_tpu.data import Synthetic as JaxSynthetic
from bnn_priors_tpu_torch import exp_utils, interop
from bnn_priors_tpu_torch.data import RandomData, Synthetic
from bnn_priors_tpu_torch.experiments import (eval_bnn, sweep_tempering,
                                              train_bnn)

from test_torch_models import torch_threads_per_worker  # noqa: F401


def _true_pair(name):
    """the JAX registry's `name` on RandomData(seed=0) with its parameters
    drawn by JAX's `sample_all_priors` in float32, and the port's with
    them loaded"""
    jdata = JaxRandom(seed=0)
    tdata = RandomData(seed=0, device="cpu")
    assert np.array_equal(np.asarray(jdata.norm.X), tdata.norm.X.numpy())
    jm = jax_exp.get_model(jdata.norm.train_X, jdata.norm.train_y, name, 8,
                           3, "gaussian", 0.0, 2 ** 0.5, "gaussian", 0.0, 1.0,
                           True, {}, {})
    params, state = jm.init(jax.random.key(1), dtype=jnp.float32)
    params = jm.sample_all_priors(jax.random.key(2), params)
    tm = exp_utils.get_model(name, x_train=tdata.norm.train_X,
                             y_train=tdata.norm.train_y, width=8, depth=3,
                             device="cpu")
    interop.load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()},
                           {})
    return jdata, tdata, jm, params, state, tm


def test_regression_labels_match_jax(monkeypatch):
    jdata, tdata, jm, params, state, tm = _true_pair("densenet")
    port = Synthetic(tdata, tm, generator=torch.Generator().manual_seed(9))
    eps = torch.randn((2000, 1), generator=torch.Generator().manual_seed(9),
                      dtype=torch.float64).to(torch.float32).numpy()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(eps, dtype))
    jax_syn = JaxSynthetic(jdata, jm, params, state)
    np.testing.assert_allclose(port.norm.y.numpy(), np.asarray(jax_syn.norm.y),
                               rtol=1e-5, atol=1e-6)
    for split in ("train", "test"):
        for ours, theirs in zip(getattr(port.norm, split),
                                getattr(jax_syn.norm, split)):
            assert tuple(ours.shape) == tuple(theirs.shape)
    assert torch.equal(port.unnorm.X, tdata.unnorm.X)
    assert torch.equal(port.unnorm.y, port.norm.y)


def test_classification_logits_match_jax_and_labels_follow_them():
    jdata, tdata, jm, params, state, tm = _true_pair("classificationdensenet")
    with torch.no_grad():
        logits = tm._logits(tm.net_apply(None, tdata.norm.X))
    f, _ = jm.net_apply(params, state, jdata.norm.X, train=False)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm._logits(f, params)),
                               rtol=1e-5, atol=1e-5)
    # label frequencies against the softmax: 4 draws of the 2,000 points,
    # overall and in 4 bins of P(class 1), each within 4 sigma
    p1 = torch.softmax(logits.double(), -1)[:, 1].numpy()
    labels = np.stack([Synthetic(tdata, tm, generator=torch.Generator()
                                 .manual_seed(s)).norm.y.numpy()
                       for s in range(4)])
    assert labels.dtype == np.int64 and set(np.unique(labels)) <= {0, 1}
    bins = np.digitize(p1, np.quantile(p1, [0.25, 0.5, 0.75]))
    for sel in [np.ones_like(p1, bool)] + [bins == b for b in range(4)]:
        count = labels[:, sel].sum()
        mean = 4 * p1[sel].sum()
        sd = math.sqrt(4 * (p1[sel] * (1 - p1[sel])).sum())
        assert abs(count - mean) < 4 * sd + 1e-9, (count, mean, sd)


CLI = dict(data="synthetic.random.gaussian", inference="VerletSGLDReject",
           cycles=1, warmup=1, burnin=0, n_samples=2, skip_first=0,
           batch_size=100, width=8, progressbar=False, device="cpu")


def _spy(monkeypatch):
    "every dataset that get_data_from_config returns, in order"
    seen, orig = [], exp_utils.get_data_from_config

    def spy(cfg, device="cuda"):
        seen.append(orig(cfg, device=device))
        return seen[-1]
    monkeypatch.setattr(exp_utils, "get_data_from_config", spy)
    return seen


def _same_data(a, b):
    for split in ("train", "test"):
        for x, y in zip(getattr(a.norm, split), getattr(b.norm, split)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("model", ["densenet", "classificationdensenet"])
def test_train_bnn_then_eval_regenerate_the_data(model, monkeypatch,
                                                  tmp_path):
    seen = _spy(monkeypatch)
    cfg = dict(train_bnn.DEFAULTS, **CLI, model=model,
               log_dir=str(tmp_path / "train"))
    result = train_bnn.main(cfg)
    run_dir = tmp_path / "train" / "1"
    assert json.loads((run_dir / "run.json").read_text())["status"] == \
        "COMPLETED"
    out = eval_bnn.main(dict(eval_bnn.DEFAULTS, run_dir=str(run_dir),
                             skip_first=0, device="cpu",
                             log_dir=str(tmp_path / "eval")))
    assert out == result
    assert len(seen) == 2
    _same_data(seen[0], seen[1])
    y = seen[0].norm.train_y
    if model == "densenet":
        assert y.shape == (1000, 1) and y.dtype == torch.float32
        # the labels are the model's, not the base dataset's
        base = RandomData(seed=0, device="cpu").norm.train_y
        assert not torch.equal(y, base)
    else:
        assert y.shape == (1000,) and y.dtype == torch.int64


def test_sweep_on_a_synthetic_name(monkeypatch, tmp_path):
    "a 2-chain sweep's chain dirs evaluate to their results on the same data"
    seen = _spy(monkeypatch)
    cfg = dict(sweep_tempering.DEFAULTS, **CLI, model="densenet",
               temperatures=[0.1, 1.0], replicates=1,
               log_dir=str(tmp_path / "sweep"))
    sweep_tempering.main(cfg)
    dirs = sorted(d for d in Path(tmp_path / "sweep").iterdir()
                  if (d / "samples.pt").exists())
    assert len(dirs) == 2
    for d in dirs:
        run = json.loads((d / "run.json").read_text())
        out = eval_bnn.main(dict(eval_bnn.DEFAULTS, run_dir=str(d),
                                 skip_first=0, device="cpu",
                                 log_dir=str(tmp_path / "eval")))
        assert out == {k: run["result"][k] for k in out}
    assert len(seen) == 3
    _same_data(seen[0], seen[1])
    _same_data(seen[0], seen[2])


def test_dataset_device():
    """a Dataset is on the card unless the caller asks for the CPU; arrays
    and tensors both go where it is asked"""
    import inspect

    from bnn_priors_tpu_torch.data import Dataset
    assert inspect.signature(Dataset).parameters["device"].default == "cuda"
    x, y = np.arange(12.0).reshape(6, 2), torch.arange(6)
    d = Dataset(x, y, [0, 1, 2, 3], [4, 5], device="cpu")
    for t in (d.X, d.y, *d.train, *d.test):
        assert t.device.type == "cpu"
    assert torch.equal(d.test[1], torch.tensor([4, 5]))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Dataset(x, y, [0], [1])
