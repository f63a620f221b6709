"""Tempering/temperature-diagnostic plotting; counterpart of
`bnn_priors_tpu/plot.py` (reference: `bnn_priors/plot.py`), with the same
names.

The key sampler-health observables from the papers: weighted-mean kinetic /
configurational temperature with Cochran-1977 standard errors, and χ²(d)
confidence-interval coverage counts for the per-parameter kinetic
temperature. numpy and scipy: the caller passes matplotlib axes in, and the
module imports matplotlib only for the default colour map of
`kinetic_temperature_intervals`.

`load_metrics(path)` adapts a metrics.h5 file (the port's `HDF5Metrics`
writes the JAX package's layout) into the nested dict layout these
functions consume; it alone needs h5py.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import scipy.signal
import scipy.stats

__all__ = ("load_metrics", "get_sizes", "weighted_var_se", "ewma",
           "temperature_stderr", "chi2_coverage",
           "kinetic_temperature_intervals", "metric", "vlines")


def load_metrics(path) -> Dict:
    """metrics.h5 → nested dict: scalar series at top level, per-parameter
    series grouped under 'est_temperature'/'est_config_temp'/'preconditioner'."""
    import h5py
    out: Dict = {}
    with h5py.File(path, "r") as f:
        def visit(k, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            arr = np.asarray(obj)
            if "/" in k:
                group, name = k.split("/", 1)
                out.setdefault(group, {})[name] = arr
            else:
                out[k] = arr
        f.visititems(visit)
    # 'acceptance/...' stays grouped; est_* groups keyed by parameter name
    return out


def get_sizes(params: Dict[str, np.ndarray]) -> Dict[str, int]:
    "parameter name → element count (weights for temperature averaging)"
    return {k: int(np.prod(np.shape(v))) for k, v in params.items()}


def weighted_var_se(w, x):
    """Mean of a weighted mean and the (squared) standard error of that mean,
    via the ratio-estimator variance of Cochran (1977, "Sampling Techniques",
    eq. 6.9 applied to x̄_w = Σwx/Σw):

        Var(x̄_w) ≈ n / ((n-1)·W²) · Σᵢ wᵢ²·(xᵢ − x̄_w)²,   W = Σᵢ wᵢ.

    (The three-term expansion used in `reference/plot.py:18-37` — which
    adapts a CC BY-SA stats.stackexchange answer — reduces algebraically to
    this single sum of weighted squared residuals; derived independently
    here from the ratio-estimator form.)

    w: (n,) weights; x: (..., n) per-parameter series. Returns (mean, var)."""
    w = np.asarray(w, dtype=float)
    n, = w.shape
    assert x.shape[-1] == n
    total_w = w.sum()
    mean = (x @ w) / total_w
    resid = w * (x - mean[..., None])
    var = (resid ** 2).sum(-1) * n / ((n - 1) * total_w ** 2)
    return mean, var


def ewma(array, alpha):
    """Exponential moving average y_t = α·y_{t-1} + (1-α)·x_t with y_{-1}=x_0
    (so the series starts at the first observation). alpha=0 disables.

    Runs as a first-order IIR filter; for the direct-form-II-transposed state
    of ``lfilter`` with b=[1-α], a=[1, -α], the state update is z_t = α·y_t,
    so seeding y_{-1}=x_0 means an initial state of [α·x_0]."""
    if alpha == 0.0:
        return array
    array = np.asarray(array)
    zi = np.array([alpha * array[0]], dtype=float)
    smoothed, _ = scipy.signal.lfilter([1.0 - alpha], [1.0, -alpha],
                                       array, zi=zi)
    return smoothed


def _plot_band(ax, x, mean, var, ewma_alpha, color=None, label=None,
               fill_alpha=0.05, **kwargs):
    "mean ± 2σ band (the reference's gp_posterior on a diagonal Gaussian)"
    mean_s = ewma(mean, ewma_alpha)
    line, *_ = ax.plot(x, mean_s, color=color, **kwargs)
    if label is not None:
        line.set_label(label)
    C = line.get_color()
    sd = 2 * np.sqrt(var)
    lower = ewma(mean - sd, ewma_alpha)
    upper = ewma(mean + sd, ewma_alpha)
    ax.fill_between(x, lower, upper, alpha=fill_alpha, color=C)
    ax.plot(x, lower, color=C, linewidth=0.5)
    ax.plot(x, upper, color=C, linewidth=0.5)


def gp_posterior(ax, x, mean, std, ewma_alpha: float = 0.0,
                 label: Optional[str] = None, sort=True, fill_alpha=0.05,
                 **kwargs):
    """Posterior-predictive band: mean line ± 2σ confidence region over
    sorted inputs (reference `plot.py:181-207`, which takes a gpytorch
    MultivariateNormal; here mean/std arrays — e.g. the output of the
    port's `models.RaoBRegressionModel.predictive(params, x)`, as numpy —
    mean ± 2σ is gpytorch's `confidence_region()`)."""
    x = np.asarray(x).reshape(-1)
    mean = np.asarray(mean).reshape(-1)
    std = np.asarray(std).reshape(-1)
    if sort:
        i = np.argsort(x)
        x, mean, std = x[i], mean[i], std[i]
    mean_s = ewma(mean, ewma_alpha)
    line, *_ = ax.plot(x, mean_s, **kwargs)
    if label is not None:
        line.set_label(label)
    C = line.get_color()
    lower = ewma(mean - 2 * std, ewma_alpha)
    upper = ewma(mean + 2 * std, ewma_alpha)
    ax.fill_between(x, lower, upper, alpha=fill_alpha, color=C)
    ax.plot(x, lower, color=C, linewidth=0.5)
    ax.plot(x, upper, color=C, linewidth=0.5)
    return line


def temperature_stderr(ax, metrics, temp_group, sizes: Dict[str, int],
                       ewma_alpha: float = 0.0, mask=slice(None), label=None,
                       legend=True, line_kwargs={}, confidence_kwargs={}):
    """Weighted mean ± SE of the per-parameter temperatures
    ('est_temperature' or 'est_config_temp') against the target temperature."""
    temperatures = metrics[temp_group]
    if label is None:
        label = temp_group
    mean = temperatures["all"][mask]
    keys = [k for k in temperatures.keys() if k != "all"]
    if keys:
        temps = np.stack([temperatures[k][mask] for k in keys], axis=1)
        weights = np.array([sizes[k] for k in keys], dtype=float)
        _mean, var_se = weighted_var_se(weights, temps)
    else:
        # aggregate-only metrics (e.g. the multichain sweep): no
        # per-parameter spread available, draw the mean with zero band
        var_se = np.zeros_like(mean)

    steps = metrics["steps"][mask]
    line, *_ = ax.plot(steps, metrics["temperature"][mask], linestyle="--",
                       **line_kwargs)
    _plot_band(ax, steps, mean, var_se, ewma_alpha, color=line.get_color(),
               label=label, **confidence_kwargs)
    if legend:
        ax.legend()


def chi2_coverage(est_temps, temperature, dfs, confidences):
    """Vectorized χ² interval-coverage counts for kinetic temperature.

    If momenta are sampled at temperature T, the per-parameter kinetic
    temperature estimate of a d-dimensional parameter is T·χ²(d)/d
    distributed, so ``est/T`` should land inside the central χ²(d)/d
    interval at rate = confidence level.

    est_temps: (T_steps, P) per-parameter kinetic-temperature series.
    temperature: (T_steps,) target temperature. dfs: (P,) parameter sizes.
    confidences: (C,) central-interval levels.
    Returns (C, T_steps) fraction of parameters inside each interval."""
    confidences = np.asarray(confidences, dtype=float)
    dfs = np.asarray(dfs, dtype=float)
    tail = (1.0 - confidences)[:, None] / 2.0                    # (C, 1)
    lower = scipy.stats.chi2.ppf(tail, dfs) / dfs                # (C, P)
    upper = scipy.stats.chi2.ppf(1.0 - tail, dfs) / dfs          # (C, P)
    scaled = est_temps / np.asarray(temperature)[:, None]        # (T, P)
    inside = ((lower[:, None, :] <= scaled[None]) &
              (scaled[None] <= upper[:, None, :]))               # (C, T, P)
    return inside.mean(axis=-1)


def kinetic_temperature_intervals(ax, metrics, sizes: Dict[str, int],
                                  mask=slice(None), ewma_alpha: float = 0.0,
                                  confidences=(0.05, 0.25, 0.50, 0.75, 0.95),
                                  label="confidence", legend=True, cmap=None,
                                  hline_kwargs={}, plot_kwargs={}):
    """Fraction of parameters whose kinetic temperature falls inside each
    χ²(d) confidence interval — should track the confidence level if the
    sampler is healthy (the paper's key diagnostic). Computed by
    `chi2_coverage` on a stacked (steps, params) array."""
    confidences = np.asarray(confidences, dtype=float)
    keys = [k for k in metrics["est_temperature"].keys() if k != "all"]
    est = np.stack([metrics["est_temperature"][k][mask] for k in keys],
                   axis=-1)
    dfs = np.array([sizes[k] for k in keys])
    coverage = chi2_coverage(est, metrics["temperature"][mask], dfs,
                             confidences)

    if cmap is None:
        import matplotlib
        cmap = matplotlib.colormaps["plasma"]
    steps = metrics["steps"][mask]
    for level, series, color in zip(confidences, coverage, cmap(confidences)):
        line = ax.axhline(level, linestyle="--", linewidth=0.5,
                          color=color, **hline_kwargs)
        kwargs = dict(linestyle="-", color=line.get_color(),
                      label=f"{label} {level:.2f}")
        kwargs.update(plot_kwargs)
        ax.plot(steps, ewma(series, ewma_alpha), **kwargs)
    if legend:
        ax.legend()


def metric(ax, metrics, name, mask=slice(None), ewma_alpha: float = 0.0,
           legend=True, iqr_ylim=None, transform=(lambda x: x),
           plot_kwargs={}):
    """Plot one named metric series with optional EWMA smoothing. With
    ``iqr_ylim=r``, clip the y-axis to median ± r·IQR (a robust window that
    survives divergence spikes), never clipping tighter than the data range
    padded by 5% of the IQR."""
    val = ewma(transform(metrics[name][mask]), ewma_alpha)
    kwargs = dict(label=name)
    kwargs.update(plot_kwargs)
    ax.plot(metrics["steps"][mask], val, **kwargs)
    if legend:
        ax.legend()
    if iqr_ylim is not None:
        q25, median, q75 = np.nanpercentile(val, (25, 50, 75))
        iqr = q75 - q25
        pad = 0.05 * iqr
        lo = max(median - iqr_ylim * iqr, np.nanmin(val) - pad)
        hi = min(median + iqr_ylim * iqr, np.nanmax(val) + pad)
        ax.set_ylim((lo, hi))


def vlines(ax, metrics, mask, plot_kwargs={}):
    """Full-height vertical markers at the masked steps (e.g. stored-sample
    boundaries), drawn in axis-fraction y coordinates so they span the axes
    regardless of data limits."""
    steps = metrics["steps"][mask]
    kwargs = dict(color="red", linestyle="--")
    kwargs.update(plot_kwargs)
    ax.vlines(steps, 0.0, 1.0,
              transform=ax.get_xaxis_transform(which="grid"), **kwargs)
