"""The evaluation trio's datasets: the port's `CIFAR10_C`, `SVHN`,
`RandomData` and `RandomOODTestData` against the JAX package's on the same
inputs (synthetic files in the real layouts, written to a temporary
directory; the toy data from the same seeds), and their registry names.

CIFAR-10-C is held on a corruption file of 20,000 rows (two severities)
in both directory layouts, at severity 1, 2 and None; SVHN on `.mat`
files with the digit 0 stored as label 10. Every normalised and raw array
equals the JAX package's exactly: both normalise with the same float32
numpy statistics, and subtraction and division round once either way."""
import numpy as np
import pytest
import torch

from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu.data import cifar as jax_cifar
from bnn_priors_tpu.data import toy as jax_toy
from bnn_priors_tpu_torch import data, exp_utils

from test_torch_models import torch_threads_per_worker  # noqa: F401

N_TRAIN, N_TEST = 30, 8           # the clean CIFAR-10 batches
N_CORRUPT = 20000                 # two severities of 10,000 rows
SVHN_TRAIN, SVHN_TEST = 40, 16


def _images(rng, n):
    return rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{layout: CIFAR root}: clean batches and one corruption file (with
    its labels) under cifar10-c/CIFAR-10-C ('nested') or CIFAR-10-C
    ('flat'); and an SVHN root"""
    rng = np.random.RandomState(0)
    x, y = _images(rng, N_TRAIN + N_TEST), rng.randint(0, 10, N_TRAIN + N_TEST)
    xc = rng.randint(0, 256, (N_CORRUPT, 32, 32, 3)).astype(np.uint8)
    yc = rng.randint(0, 10, N_CORRUPT)
    out = {}
    for layout in ("nested", "flat"):
        root = str(tmp_path_factory.mktemp(layout) / "CIFAR")
        data.write_cifar10_batches(root, x[:N_TRAIN], y[:N_TRAIN],
                                   x[N_TRAIN:], y[N_TRAIN:])
        data.write_cifar10_c(root, "gaussian_blur", xc, yc,
                             nested=layout == "nested")
        out[layout] = root
    svhn = str(tmp_path_factory.mktemp("SVHN"))
    ys = rng.randint(0, 10, SVHN_TRAIN + SVHN_TEST)
    ys[:3] = 0  # the digit 0, stored as label 10
    xs = _images(rng, SVHN_TRAIN + SVHN_TEST)
    xs[:, 1] //= 3  # channel statistics unlike CIFAR-10's
    data.write_svhn(svhn, xs[:SVHN_TRAIN], ys[:SVHN_TRAIN], xs[SVHN_TRAIN:],
                    ys[SVHN_TRAIN:])
    out["svhn"] = svhn
    out["svhn_labels"] = ys
    out["corrupt"] = (xc, yc)
    return out


def _same(ours, theirs):
    "every split of norm and unnorm equal to the JAX package's, bit for bit"
    for split in ("norm", "unnorm"):
        for part in ("train", "test"):
            (tx, ty) = getattr(getattr(ours, split), part)
            (jx, jy) = getattr(getattr(theirs, split), part)
            assert tx.dtype == torch.float32 and ty.dtype == torch.int64
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx),
                                          err_msg=f"{split} {part} X")
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy),
                                          err_msg=f"{split} {part} y")


@pytest.mark.parametrize("severity", [1, 2, None])
@pytest.mark.parametrize("layout", ["nested", "flat"])
def test_cifar10_c_matches_jax(roots, layout, severity):
    """the clean training set and its normalisation, the corrupted test set
    (NHWC file → NCHW) cut to the severity's 10,000 rows, or all rows"""
    root = roots[layout]
    ours = data.CIFAR10_C("gaussian_blur", data_root=root, severity=severity,
                          device="cpu")
    theirs = jax_cifar.CIFAR10_C("gaussian_blur", data_root=root,
                                 severity=severity)
    n = N_CORRUPT if severity is None else 10000
    assert ours.norm.test_X.shape == (n, 3, 32, 32)
    assert ours.norm.train_X.shape == (N_TRAIN, 3, 32, 32)
    _same(ours, theirs)
    xc, yc = roots["corrupt"]
    rows = slice(None) if severity is None else slice((severity - 1) * 10000,
                                                      severity * 10000)
    np.testing.assert_array_equal(ours.unnorm.test_X.numpy(),
                                  xc[rows].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(ours.norm.test_y.numpy(), yc[rows])
    # normalised by the clean training set's statistics
    clean = data.CIFAR10(data_root=root, device="cpu")
    np.testing.assert_array_equal(ours.X_mean, clean.X_mean)
    np.testing.assert_array_equal(ours.X_std, clean.X_std)


def test_svhn_matches_jax(roots):
    """label 10 is the digit 0; the normalisation is SVHN's own training
    split's (the JAX code's; its docstring names CIFAR-10's, ROADMAP §3)"""
    ours = data.SVHN(data_root=roots["svhn"], device="cpu")
    theirs = jax_cifar.SVHN(data_root=roots["svhn"])
    assert ours.norm.train_X.shape == (SVHN_TRAIN, 3, 32, 32)
    assert ours.norm.test_X.shape == (SVHN_TEST, 3, 32, 32)
    _same(ours, theirs)
    ys = roots["svhn_labels"]
    np.testing.assert_array_equal(ours.norm.train_y.numpy(), ys[:SVHN_TRAIN])
    assert (ours.norm.train_y == 0).sum() >= 3
    x = ours.unnorm.train_X.numpy()
    np.testing.assert_array_equal(
        ours.X_mean, x.mean(axis=(0, 2, 3), keepdims=True))
    np.testing.assert_array_equal(
        ours.X_std, x.std(axis=(0, 2, 3), keepdims=True, ddof=1))
    cifar = data.CIFAR10(data_root=roots["nested"], device="cpu")
    assert not np.allclose(ours.X_mean, cifar.X_mean, rtol=0.05)
    xn = ours.norm.train_X.double()
    np.testing.assert_allclose(xn.mean((0, 2, 3)).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(xn.std((0, 2, 3)).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", ["RandomData", "RandomOODTestData"])
def test_toy_data_bit_equal_to_jax(name, seed):
    """the same RandomState draws in the same order: every array, the
    statistics and the train/test split equal the JAX package's"""
    ours = getattr(data, name)(dim=5, n_points=101, seed=seed, device="cpu")
    theirs = getattr(jax_toy, name)(dim=5, n_points=101, seed=seed)
    for split in ("norm", "unnorm"):
        for part in ("train", "test"):
            (tx, ty) = getattr(getattr(ours, split), part)
            (jx, jy) = getattr(getattr(theirs, split), part)
            assert tx.dtype == ty.dtype == torch.float32
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert ours.norm.train_X.shape == (50, 5)
    assert ours.norm.test_y.shape == (51, 1)
    for k in ("X_mean", "X_std", "y_mean", "y_std"):
        np.testing.assert_array_equal(getattr(ours, k),
                                      np.asarray(getattr(theirs, k)))
    x = ours.unnorm.test_X.numpy()
    if name == "RandomOODTestData":  # test points outside the train range
        assert x.min() >= 1.0 and ours.unnorm.train_X.numpy().max() <= 1.0
    else:
        assert x.min() >= -1.0 and x.max() <= 1.0


def test_toy_constant_column_std_is_one():
    "a constant input column is divided by 1 (toy.py:33), as in JAX"
    x = np.random.RandomState(3).uniform(-1, 1, (20, 3)).astype(np.float32)
    x[:, 1] = 0.5
    y = np.zeros((20, 1), np.float32) + np.arange(20, dtype=np.float32)[:, None]
    ours = data.RandomData.__new__(data.RandomData)
    ours._build(x, y, 10, "cpu")
    theirs = jax_toy.RandomData.__new__(jax_toy.RandomData)
    theirs._build(x, y, 10)
    assert ours.X_std[1] == 1.0
    np.testing.assert_array_equal(ours.norm.X.numpy(), np.asarray(theirs.norm.X))
    np.testing.assert_array_equal(ours.norm.y.numpy(), np.asarray(theirs.norm.y))
    np.testing.assert_array_equal(ours.norm.X.numpy()[:, 1], 0.0)


@pytest.mark.parametrize("name,cls", [
    ("svhn", "SVHN"), ("random", "RandomData"),
    ("random_ood_test", "RandomOODTestData"),
    ("cifar10c-gaussian_blur", "CIFAR10_C")])
def test_registry_names(roots, monkeypatch, tmp_path, name, cls):
    """the JAX registry's names build the port's classes from the default
    roots under $BNN_PRIORS_DATA, with the JAX package's arrays"""
    import os
    import shutil
    os.symlink(roots["nested"], tmp_path / "CIFAR")
    shutil.copytree(roots["svhn"], tmp_path / "SVHN")
    monkeypatch.setenv("BNN_PRIORS_DATA", str(tmp_path))
    seed = {"seed": 2} if name.startswith("random") else {}
    ours = exp_utils.get_data(name, device="cpu", **seed)
    assert type(ours).__name__ == cls
    theirs = jax_exp.get_data(name, **seed)
    assert type(theirs).__name__ == cls
    if cls == "CIFAR10_C":  # all 20,000 rows of the file
        assert ours.norm.test_X.shape[0] == N_CORRUPT
    for part in ("train", "test"):
        np.testing.assert_array_equal(getattr(ours.norm, part)[0].numpy(),
                                      np.asarray(getattr(theirs.norm,
                                                         part)[0]))


@pytest.mark.parametrize("name", ["random", "random_ood_test"])
def test_seeded_toy_data_follow_the_config_seed(name):
    """get_data_seeded passes `seed` to the constructors that take it, so
    get_data_from_config pins the toy points to the run's seed (eval
    re-hydration scores the points the run trained on), as in JAX"""
    for seed in (0, 5):
        cfg = {"data": name, "seed": seed}
        ours = exp_utils.get_data_from_config(cfg, device="cpu")
        again = exp_utils.get_data_seeded(name, seed, device="cpu")
        theirs, _ = jax_exp.get_data_from_config(cfg)
        for d in (again, theirs):
            np.testing.assert_array_equal(ours.norm.train_X.numpy(),
                                          np.asarray(d.norm.train_X))
    other = exp_utils.get_data_seeded(name, 6, device="cpu")
    assert not np.array_equal(other.norm.train_X.numpy(),
                              ours.norm.train_X.numpy())


def test_seed_goes_only_to_constructors_that_take_it(roots, monkeypatch,
                                                     tmp_path):
    """a file-backed dataset gets no `seed` (signature-checked): svhn
    builds through get_data_seeded with any seed"""
    import shutil
    shutil.copytree(roots["svhn"], tmp_path / "SVHN")
    monkeypatch.setenv("BNN_PRIORS_DATA", str(tmp_path))
    a = exp_utils.get_data_seeded("svhn", 3, device="cpu")
    b = exp_utils.get_data_seeded("svhn", 4, device="cpu")
    assert torch.equal(a.norm.train_X, b.norm.train_X)


def test_synthetic_names_still_raise():
    """synthetic.<base>.<prior>, once refused (ROADMAP item 13), builds:
    the base's inputs with labels drawn from the config's model, the same
    from the same config (tests/test_torch_synthetic.py holds it to JAX)"""
    from bnn_priors_tpu_torch.experiments import train_bnn
    cfg = dict(train_bnn.DEFAULTS, data="synthetic.random.gaussian",
               model="densenet", width=8, seed=0)
    a = exp_utils.get_data_from_config(cfg, device="cpu")
    b = exp_utils.get_data_from_config(cfg, device="cpu")
    base = exp_utils.get_data_seeded("random", 0, device="cpu")
    assert torch.equal(a.norm.train_X, base.norm.train_X)
    assert torch.equal(a.norm.y, b.norm.y)
    assert not torch.equal(a.norm.y, base.norm.y)
