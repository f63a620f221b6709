"""The port's MNIST-family and UCI loaders against the JAX package's, on
the same files: synthetic IDX files in MNIST's format (plain and gzipped,
in the root and in torchvision's `raw/`), `FakeMNIST`, `RotatedMNIST`'s
rotated test copies, and three of the bundled UCI datasets with their
train-split normalisation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_priors_tpu import data as jax_data
from bnn_priors_tpu import exp_utils as jax_exp
from bnn_priors_tpu_torch import data, exp_utils

from test_torch_models import torch_threads_per_worker  # noqa: F401

N_TRAIN, N_TEST = 40, 12


def _images(seed=0):
    "uint8 (N, 28, 28) images and labels 0-9 for train and test"
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (N_TRAIN, 28, 28)), rng.randint(0, 10, N_TRAIN),
            rng.randint(0, 256, (N_TEST, 28, 28)), rng.randint(0, 10, N_TEST))


def _same(ours, theirs):
    for (tx, ty), (jx, jy) in ((ours.norm.train, theirs.norm.train),
                               (ours.norm.test, theirs.norm.test),
                               (ours.unnorm.train, theirs.unnorm.train)):
        assert tx.dtype == torch.float32 and ty.dtype == torch.int64
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("gz,sub", [(False, ""), (True, ""), (True, "raw")])
@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_idx_files_read_as_jax_reads_them(tmp_path, monkeypatch, cls, gz,
                                          sub):
    """the default root $BNN_PRIORS_DATA/<subdir>, files plain or .gz, in
    it or in its raw/"""
    root = tmp_path / getattr(data, cls).subdir
    data.write_idx_files(str(root / sub), *_images(), gz=gz)
    monkeypatch.setenv("BNN_PRIORS_DATA", str(tmp_path))
    ours = getattr(data, cls)(device="cpu")
    _same(ours, getattr(jax_data, cls)())
    assert ours.norm.train_X.shape == (N_TRAIN, 784)
    assert float(ours.norm.train_X.max()) <= 1.0
    name = "mnist" if cls == "MNIST" else "fashion_mnist"
    _same(exp_utils.get_data_seeded(name, 3, device="cpu"),
          jax_exp.get_data_seeded(name, 3))


def test_missing_idx_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte"):
        data.MNIST(data_root=str(tmp_path), device="cpu")


def test_rotated_mnist_matches_jax(tmp_path):
    "the test set and its ±45° and ±90° copies, as JAX rotates them"
    data.write_idx_files(str(tmp_path), *_images(1))
    ours = data.RotatedMNIST(data_root=str(tmp_path), device="cpu")
    _same(ours, jax_data.RotatedMNIST(data_root=str(tmp_path)))
    assert ours.norm.test_X.shape == (3 * N_TEST, 784)
    rotated = ours.norm.test_X[N_TEST:]
    assert not torch.equal(rotated[:N_TEST], ours.norm.test_X[:N_TEST])


def test_fake_mnist_matches_jax():
    _same(data.FakeMNIST(n_train=N_TRAIN, n_test=N_TEST, seed=4,
                         device="cpu"),
          jax_data.FakeMNIST(n_train=N_TRAIN, n_test=N_TEST, seed=4))
    _same(exp_utils.get_data("fake_mnist", n_train=N_TRAIN, n_test=N_TEST,
                             device="cpu"),
          jax_exp.get_data("fake_mnist", n_train=N_TRAIN, n_test=N_TEST))


@pytest.mark.parametrize("name", ["yacht", "boston", "energy"])
def test_bundled_uci_matches_jax(name):
    """the bundled split 0 read in place, normalised with the training
    split's statistics (ddof=1), targets (N, 1), as the JAX loader makes
    them (to f32 rounding: JAX reduces the means in XLA)"""
    ours = exp_utils.get_data(f"UCI_{name}", device="cpu")
    theirs = jax_exp.get_data(f"UCI_{name}")
    assert ours.norm.train_y.shape[1:] == (1,)
    for (tx, ty), (jx, jy) in ((ours.norm.train, theirs.norm.train),
                               (ours.norm.test, theirs.norm.test)):
        assert tx.dtype == ty.dtype == torch.float32
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(ours.unnorm.train_X.numpy(),
                                  np.asarray(theirs.unnorm.train_X))
    for k in ("X_mean", "X_std", "y_mean", "y_std"):
        np.testing.assert_allclose(getattr(ours, k),
                                   np.asarray(getattr(theirs, k)), rtol=1e-6)
    train_x = ours.norm.train_X.double()
    np.testing.assert_allclose(train_x.mean(0).numpy(), 0, atol=1e-4)


def test_uci_root_search(tmp_path, monkeypatch):
    """$BNN_PRIORS_DATA/UCI comes first; without it the bundled splits"""
    monkeypatch.setenv("BNN_PRIORS_DATA", str(tmp_path))
    bundled = exp_utils.get_data("UCI_yacht", device="cpu")
    src = data.uci.BUNDLED_UCI + "/yacht"
    dst = tmp_path / "UCI" / "yacht"
    dst.mkdir(parents=True)
    for f in ("data.txt", "index_features.txt", "index_target.txt",
              "index_train_0.txt", "index_test_0.txt"):
        text = open(f"{src}/{f}").read()
        if f == "index_train_0.txt":  # a shorter training split
            text = "\n".join(text.split("\n")[:50])
        (dst / f).write_text(text)
    local = exp_utils.get_data("UCI_yacht", device="cpu")
    assert local.norm.train_X.shape[0] == 50 < bundled.norm.train_X.shape[0]


@pytest.mark.parametrize("name", ["svhn", "random", "cifar10c-fog"])
def test_unported_data_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        exp_utils.get_data(name, device="cpu")
