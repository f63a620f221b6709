"""The port's HDF5 metrics and sample files (`bnn_priors_tpu_torch/io`)
against the JAX package's: the same call sequence gives files with the
same datasets, dtypes, shapes, chunks, filters and values (NaN-equal,
timestamps aside), and each package's `load_samples` reads the other's
sample bank."""
import h5py
import numpy as np
import pytest

from bnn_priors_tpu.io import hdf5 as jax_hdf5
from bnn_priors_tpu_torch.io import hdf5


def metrics_calls(saver):
    "interleaved scalars, merged row blocks, flushes, late and int/bool keys"
    saver.add_scalar("loss", 1.5, 0)
    saver.add_scalar("acceptance/is_sample", 1, 0)
    saver.add_scalar("loss", 1.25, 1)
    saver.add_rows({"loss": np.array([1.0, 0.75, 0.5]),
                    "est/all": np.array([0.1, 0.2, 0.3], np.float32)},
                   np.array([1, 2, 3]))  # first row merges into step 1
    saver.flush(keep_last_row=True)
    saver.add_scalar("flag", True, 3)  # into the kept row
    saver.add_scalar("acceptance/rejected", 0, 4)
    for step in range(5, 20):
        saver.add_scalar("loss", 0.1 * step, step)
        if step % 3 == 0:
            saver.add_scalar("late", float(step), step)
    saver.flush(every_s=1e9)  # too soon: writes nothing
    saver.add_rows({"acceptance/rejected": np.array([1, 0], np.int64)},
                   np.array([20, 21]))
    saver.flush()
    with pytest.raises(ValueError, match="backwards"):
        saver.add_scalar("loss", 0.0, 3)


def reopen_calls(saver):
    """a row re-opened after a full flush. Its filler for a column that has
    no cached value is a float NaN, which both packages write into an int64
    column as -(2**63) (and which h5py cannot convert into a bool column,
    in either package: the runners log their flags as ints)"""
    saver.add_scalar("loss", 1.0, 0)
    saver.add_scalar("acceptance/rejected", 0, 0)
    saver.flush()
    saver.add_rows({"loss": np.array([9.0, 8.0])}, np.array([0, 1]))


def datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, v):
            if isinstance(v, h5py.Dataset):
                out[name] = (v.dtype, v.shape, v.chunks, v.fletcher32,
                             v.maxshape, np.asarray(v))
        f.visititems(visit)
    return out


def assert_same_files(a, b):
    da, db = datasets(a), datasets(b)
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k][:5] == db[k][:5], k
        if k != "timestamps":
            np.testing.assert_array_equal(da[k][5], db[k][5], err_msg=k)


@pytest.mark.parametrize("calls", [metrics_calls, reopen_calls])
def test_metrics_files_match(tmp_path, calls):
    paths = {}
    for name, mod in (("port", hdf5), ("jax", jax_hdf5)):
        paths[name] = tmp_path / f"{name}.h5"
        with mod.HDF5Metrics(paths[name], chunk_size=7) as saver:
            calls(saver)
    assert_same_files(paths["port"], paths["jax"])
    d = datasets(paths["port"])
    if calls is reopen_calls:
        np.testing.assert_array_equal(d["steps"][5], [0, 0, 1])
        np.testing.assert_array_equal(d["loss"][5], [1.0, 9.0, 8.0])
        np.testing.assert_array_equal(d["acceptance/rejected"][5],
                                      [0, -(2 ** 63), -(2 ** 63)])
        return
    dtype, shape, chunks, fletcher32, maxshape, _ = d["loss"]
    assert (shape, chunks, fletcher32, maxshape) == ((22,), (7,), True,
                                                     (None,))
    assert dtype == np.float64 and d["flag"][0] == np.bool_
    assert d["acceptance/rejected"][0] == np.int64
    # float32 rows beside float NaN fillers are written as float64 (both)
    assert d["est/all"][0] == np.float64
    # the int64 NaN quirk and NaN fillers
    assert d["acceptance/rejected"][5][0] == -(2 ** 63)
    assert np.isnan(d["late"][5][0]) and d["late"][5][6] == 6.0
    np.testing.assert_array_equal(d["steps"][5], np.arange(22))
    loss = d["loss"][5]
    assert loss[1] == 1.0 and np.isnan(loss[4]) and np.isnan(loss[21])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sample_banks_match_and_cross_load(tmp_path, writer):
    rng = np.random.RandomState(0)
    sds = [{"net.0.weight_prior.p": rng.randn(4, 3, 3, 3).astype(np.float32),
            "net.1.running_mean": rng.randn(4),
            "net.1.num_batches_tracked": np.asarray(i, np.int64)}
           for i in range(3)]
    paths = {}
    for name, mod in (("port", hdf5), ("jax", jax_hdf5)):
        paths[name] = tmp_path / f"{name}.pt"
        with mod.HDF5ModelSaver(paths[name]) as saver:
            for i, sd in enumerate(sds):
                saver.add_state_dict(sd, step=10 * i)
                saver.flush()
            assert set(saver.load_samples(keep_steps=False)) == set(sds[0])
    assert_same_files(paths["port"], paths["jax"])
    read = {"port": hdf5.load_samples, "jax": jax_hdf5.load_samples}
    reader = "jax" if writer == "port" else "port"
    bank = read[reader](paths[writer], keep_steps=True)
    np.testing.assert_array_equal(bank["steps"], [0, 10, 20])
    for k in sds[0]:
        np.testing.assert_array_equal(bank[k], np.stack([sd[k] for sd in sds]))
    assert "steps" not in read[reader](paths[writer])
    assert datasets(paths["port"])["net.0.weight_prior.p"][2] == (1, 4, 3,
                                                                  3, 3)


def test_without_h5py(monkeypatch, tmp_path):
    "the package imports without h5py; a saver then says what is missing"
    monkeypatch.setattr(hdf5, "HAVE_H5PY", False)
    for make in (hdf5.HDF5Metrics, hdf5.HDF5ModelSaver, hdf5.load_samples):
        with pytest.raises(ImportError, match="h5py"):
            make(tmp_path / "x.h5")
