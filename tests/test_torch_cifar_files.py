"""CIFAR-10 from local python batches: the port's loaders (`cifar10`,
`cifar10_augmented`, `cifar10_small`) against the JAX package's on small
synthetic batches in the CIFAR-10 format, written to a temporary
directory: the same normalised arrays, the same `_small` cut and the same
missing-file error."""
import os

import numpy as np
import pytest
import torch

from bnn_priors_tpu.data import cifar as jax_cifar
from bnn_priors_tpu_torch import exp_utils
from bnn_priors_tpu_torch.data import (CIFAR10, CIFAR10Augmented,
                                       CIFAR10Small, write_cifar10_batches)
from test_torch_models import torch_threads_per_worker  # noqa: F401

N_TRAIN, N_TEST = 60, 12


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (N_TRAIN + N_TEST, 3, 32, 32)).astype(np.uint8)
    y = rng.randint(0, 10, N_TRAIN + N_TEST)
    r = tmp_path_factory.mktemp("cifar")
    write_cifar10_batches(str(r), x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:],
                          y[N_TRAIN:])
    return str(r)


def _same(tdata, jdata):
    for (tx, ty), (jx, jy) in ((tdata.norm.train, jdata.norm.train),
                               (tdata.norm.test, jdata.norm.test),
                               (tdata.unnorm.train, jdata.unnorm.train)):
        assert tx.dtype == torch.float32 and ty.dtype == torch.int64
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("cls,jcls", [
    (CIFAR10, jax_cifar.CIFAR10),
    (CIFAR10Augmented, jax_cifar.CIFAR10Augmented)])
def test_cifar10_matches_jax(root, cls, jcls):
    tdata = cls(data_root=root, device="cpu")
    jdata = jcls(data_root=root)
    assert tdata.norm.train_X.shape == (N_TRAIN, 3, 32, 32)
    assert tdata.norm.test_X.shape == (N_TEST, 3, 32, 32)
    _same(tdata, jdata)
    # the train set's channels are normalised, with the n-1 std
    x = tdata.norm.train_X.double()
    np.testing.assert_allclose(x.mean((0, 2, 3)).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(x.std((0, 2, 3)).numpy(), 1.0, atol=1e-5)
    assert (getattr(cls, "augment_fn", None) is None) == (cls is CIFAR10)


@pytest.mark.parametrize("n_train", [None, 25])
def test_cifar10_small_cut(root, n_train):
    kw = {} if n_train is None else {"n_train": n_train}
    tdata = CIFAR10Small(data_root=root, device="cpu", **kw)
    jdata = jax_cifar.CIFAR10Small(data_root=root, **kw)
    assert tdata.norm.train_X.shape[0] == (n_train or N_TRAIN)
    _same(tdata, jdata)
    full = CIFAR10(data_root=root, device="cpu")
    np.testing.assert_array_equal(tdata.unnorm.train_X.numpy(),
                                  full.unnorm.train_X[:n_train].numpy())


def test_registry_root_and_layouts(root, monkeypatch, tmp_path):
    """the three names in the registry; the default root
    $BNN_PRIORS_DATA/CIFAR; batches under cifar-10-batches-py or the root
    itself"""
    monkeypatch.setenv("BNN_PRIORS_DATA", os.path.dirname(root))
    os.rename(root, os.path.join(os.path.dirname(root), "CIFAR"))
    try:
        for name, cls in (("cifar10", CIFAR10),
                          ("cifar10_augmented", CIFAR10Augmented),
                          ("cifar10_small", CIFAR10Small)):
            data = exp_utils.get_data(name, device="cpu")
            assert type(data) is cls and data.norm.train_X.device.type == "cpu"
            data = exp_utils.get_data_seeded(name, 3, device="cpu")
            assert type(data) is cls
        flat = os.path.join(os.path.dirname(root), "CIFAR",
                            "cifar-10-batches-py")
        a = CIFAR10(data_root=flat, device="cpu")  # the batches' own dir
        b = CIFAR10(data_root=os.path.dirname(flat), device="cpu")
        assert torch.equal(a.norm.train_X, b.norm.train_X)
    finally:
        os.rename(os.path.join(os.path.dirname(root), "CIFAR"), root)


def test_missing_files_fail_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError) as theirs:
        jax_cifar.CIFAR10(data_root=str(tmp_path))
    with pytest.raises(FileNotFoundError) as ours:
        CIFAR10(data_root=str(tmp_path), device="cpu")
    assert str(ours.value) == str(theirs.value)
    assert "data_batch_1" in str(ours.value)
