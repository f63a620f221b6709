"""The port's diagnostics plotting (`bnn_priors_tpu_torch.plot`) and
run collection (`bnn_priors_tpu_torch.notebook_utils`) against the JAX
package's: the numeric helpers on the same inputs, a metrics.h5 written by
the port's `HDF5Metrics` loaded by both packages' `load_metrics`, the line
data each plotting function draws on Agg axes, the RaoB predictive band,
and the run-collection DataFrames of run dirs made by the port's
`RunDirectory`.
"""
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from bnn_priors_tpu import notebook_utils as jax_nb  # noqa: E402
from bnn_priors_tpu import plot as jax_plot  # noqa: E402
from bnn_priors_tpu_torch import models, notebook_utils, plot  # noqa: E402
from bnn_priors_tpu_torch.exp.config import RunDirectory  # noqa: E402
from bnn_priors_tpu_torch.inference import VerletSGLDRunner  # noqa: E402
from bnn_priors_tpu_torch.io import HDF5Metrics  # noqa: E402

from test_torch_cli import REPO  # noqa: E402
from test_torch_models import torch_threads_per_worker  # noqa: E402,F401


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """a port VerletSGLDRunner run of a small DenseNet on the CPU, its
    metrics.h5 written by the port's HDF5Metrics; (path, params)"""
    path = tmp_path_factory.mktemp("run") / "metrics.h5"
    g = torch.Generator().manual_seed(0)
    x = torch.randn(48, 3, generator=g)
    y = torch.sin(x.sum(-1, keepdim=True))
    model = models.DenseNet(3, 1, width=6, depth=2)
    with HDF5Metrics(path) as ms:
        r = VerletSGLDRunner(model, (x, y), None, epochs_per_cycle=2,
                             warmup_epochs=1, sample_epochs=1, cycles=2,
                             learning_rate=1e-3, momentum=0.9, batch_size=16,
                             metrics_saver=ms, seed=1, device="cpu")
        r.run(progressbar=False)
    params = {k: v.detach().numpy() for k, v in model.params().items()}
    return path, params


def _same(a, b):
    "nested dicts of arrays, key for key, bit for bit"
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


def _drawn(ax):
    """what an axes holds: each line's data, colour and label, each
    collection's paths, the legend's texts and the y limits"""
    legend = ax.get_legend()
    return {"lines": [(ln.get_xydata(),
                       matplotlib.colors.to_rgba(ln.get_color()),
                       ln.get_label(),
                       ln.get_linestyle(), ln.get_linewidth())
                      for ln in ax.lines],
            "collections": [[p.vertices for p in c.get_paths()]
                            for c in ax.collections],
            "legend": None if legend is None else
            [t.get_text() for t in legend.get_texts()],
            "ylim": ax.get_ylim()}


def _same_drawing(draw_jax, draw_port):
    "each package draws on fresh Agg axes; the same data, bit for bit"
    out = []
    for draw in (draw_jax, draw_port):
        fig, ax = plt.subplots()
        draw(ax)
        out.append(_drawn(ax))
        plt.close(fig)
    j, t = out
    assert len(t["lines"]) == len(j["lines"]) > 0
    for (jd, *jrest), (td, *trest) in zip(j["lines"], t["lines"]):
        np.testing.assert_array_equal(td, jd)
        assert trest == jrest
    assert len(t["collections"]) == len(j["collections"])
    for jc, tc in zip(j["collections"], t["collections"]):
        assert len(tc) == len(jc)
        for jp, tp in zip(jc, tc):
            np.testing.assert_array_equal(tp, jp)
    assert t["legend"] == j["legend"] and t["ylim"] == j["ylim"]
    return t


@pytest.mark.parametrize("fn", ["weighted_var_se", "ewma", "chi2_coverage",
                                "get_sizes"])
def test_numeric_helpers_match_jax(fn):
    rng = np.random.RandomState(0)
    if fn == "weighted_var_se":
        w, x = rng.rand(7) + 0.1, rng.randn(3, 11, 7)
        args = (w, x)
    elif fn == "ewma":
        args = (rng.randn(50), 0.9)
        assert plot.ewma(args[0], 0.0) is args[0]
    elif fn == "chi2_coverage":
        dfs = np.array([1, 4, 30, 500])
        est = rng.chisquare(dfs, size=(20, 4)) / dfs * 0.7
        args = (est, np.full(20, 0.7), dfs, (0.05, 0.5, 0.95))
    else:
        args = ({"a": rng.randn(2, 3), "b": rng.randn(4), "c": np.float64(1)},)
    j, t = getattr(jax_plot, fn)(*args), getattr(plot, fn)(*args)
    if fn == "get_sizes":
        assert t == j == {"a": 6, "b": 4, "c": 1}
        return
    for jv, tv in zip(j if isinstance(j, tuple) else (j,),
                      t if isinstance(t, tuple) else (t,)):
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)


def test_load_metrics_of_the_ports_file(tiny_run):
    path, params = tiny_run
    m = plot.load_metrics(path)
    _same(m, jax_plot.load_metrics(path))
    assert {"est_temperature", "est_config_temp", "temperature", "steps",
            "potential", "acceptance"} <= set(m)
    assert set(params) <= set(m["est_temperature"])
    assert plot.get_sizes(params) == jax_plot.get_sizes(params)


@pytest.mark.parametrize("kind", ["temperature_stderr",
                                  "kinetic_temperature_intervals", "metric",
                                  "vlines"])
def test_plots_draw_what_jax_draws(tiny_run, kind):
    path, params = tiny_run
    m = plot.load_metrics(path)
    sizes = plot.get_sizes(params)

    def draw(mod):
        if kind == "temperature_stderr":
            return lambda ax: mod.temperature_stderr(
                ax, m, "est_temperature", sizes, ewma_alpha=0.5)
        if kind == "kinetic_temperature_intervals":
            return lambda ax: mod.kinetic_temperature_intervals(ax, m, sizes)
        if kind == "metric":
            return lambda ax: mod.metric(ax, m, "potential", iqr_ylim=1.5)
        return lambda ax: (ax.plot(m["steps"], m["potential"]),
                           mod.vlines(ax, m, np.asarray(
                               m["acceptance"]["is_sample"]) > 0))
    drawn = _same_drawing(draw(jax_plot), draw(plot))
    if kind == "kinetic_temperature_intervals":
        # a dashed level and a coverage series a confidence level
        assert len(drawn["lines"]) == 10
    if kind == "vlines":
        n = int((np.asarray(m["acceptance"]["is_sample"]) > 0).sum())
        assert n > 0 and len(drawn["collections"][0]) == n


def test_gp_posterior_band_of_the_raob_predictives():
    """the band of the port's RaoB predictive against the band of JAX's,
    at the same data and prior: the same sorted line and edges"""
    import jax
    import jax.numpy as jnp

    from bnn_priors_tpu import models as jax_models
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20, 1))
    y = (2.0 * x[:, 0] + 0.1 * rng.normal(size=20))[:, None]
    xs = rng.normal(size=(15, 1))
    jm = jax_models.RaoBLinearRegression(jnp.asarray(x), jnp.asarray(y),
                                         noise_std=0.3, std_w=1.0)
    params, state = jm.init(jax.random.key(0))
    jmean, jstd = (np.asarray(a) for a in
                   jm.predictive(params, state, jnp.asarray(xs)))
    tm = models.RaoBLinearRegression(torch.as_tensor(x), torch.as_tensor(y),
                                     noise_std=0.3, std_w=1.0).double()
    tmean, tstd = (a.numpy() for a in
                   tm.predictive(None, torch.as_tensor(xs)))
    np.testing.assert_allclose(tmean, jmean, rtol=1e-8)
    np.testing.assert_allclose(tstd, jstd, rtol=1e-8)
    lines = []

    def draw(mod, mean, std):
        def f(ax):
            lines.append(mod.gp_posterior(ax, xs, mean, std, label="pred"))
        return f
    drawn = _same_drawing(draw(jax_plot, tmean, tstd),
                          draw(plot, tmean, tstd))
    xdata, ydata = lines[-1].get_data()
    order = np.argsort(xs[:, 0])
    np.testing.assert_array_equal(xdata, xs[order, 0])
    np.testing.assert_array_equal(ydata, tmean[order, 0])
    assert len(drawn["lines"]) == 3  # the mean and the two band edges
    # JAX's own predictive draws the same band to its rounding
    fig, ax = plt.subplots()
    plot.gp_posterior(ax, xs, jmean, jstd)
    for a, b in zip(ax.lines, drawn["lines"]):
        np.testing.assert_allclose(a.get_xydata(), b[0], rtol=1e-8)
    plt.close(fig)


def _runs(tmp_path):
    "two finished runs, one in flight, one without metrics, and a jugdir"
    for i, temp in enumerate([0.1, 1.0]):
        run = RunDirectory(tmp_path, {"temperature": temp, "lr": 0.01,
                                      "weight_prior": "gaussian",
                                      "prior": {"scale": 1.0 + i}})
        (run.dir / "metrics.h5").touch()
        run.finish({"acc_ensemble": 0.9 + 0.01 * i, "lp_ensemble": -0.3})
    RunDirectory(tmp_path, {"temperature": 3.0, "lr": 0.01})
    (tmp_path / "jugdir").mkdir()
    (tmp_path / "jugdir" / "metrics.h5").touch()
    (tmp_path / "notes.txt").write_text("not a run")


def test_collect_runs_and_unique_cols_match_jax(tmp_path):
    _runs(tmp_path)
    df = notebook_utils.collect_runs(tmp_path)
    jdf = jax_nb.collect_runs(tmp_path)
    assert len(df) == 2 and list(df.columns) == list(jdf.columns)
    assert df.astype(str).equals(jdf.astype(str))
    assert set(df["temperature"]) == {0.1, 1.0}
    assert "result.acc_ensemble" in df.columns and "prior.scale" in df.columns
    assert notebook_utils.unique_cols(df) == jax_nb.unique_cols(jdf)
    assert {"temperature", "prior.scale"} <= set(
        notebook_utils.unique_cols(df))
    assert notebook_utils.unique_cols(df, blacklist=set()) == \
        jax_nb.unique_cols(jdf, blacklist=set())
    every = notebook_utils.collect_runs(tmp_path, metrics_must_exist=False)
    assert len(every) == 3
    assert every.astype(str).equals(
        jax_nb.collect_runs(tmp_path, metrics_must_exist=False).astype(str))


@pytest.mark.parametrize("nested", [
    {}, {"a": 1}, {"a": {"b": 1, "c": {"d": [1, 2]}}, "e": "x"},
    {"result": {"acc": 0.5, "lp": None}, "status": "COMPLETED"}])
def test_flatten_matches_jax(nested):
    assert notebook_utils.flatten(nested) == jax_nb.flatten(nested)


def test_package_imports_without_pandas_matplotlib_h5py():
    "the package and these modules import with the three blocked"
    code = """
import sys
for m in ("pandas", "matplotlib", "h5py"):
    sys.modules[m] = None
import bnn_priors_tpu_torch.notebook_utils as nb
import bnn_priors_tpu_torch.plot as plot
import bnn_priors_tpu_torch.eff_dim, bnn_priors_tpu_torch.exp
import bnn_priors_tpu_torch.experiments.tasks.sgd_baselines
assert plot.ewma([1.0, 2.0], 0.5)[-1] == 1.5
try:
    nb.collect_runs(".")
except ImportError:
    print("pandas needed")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["pandas", "needed"]
