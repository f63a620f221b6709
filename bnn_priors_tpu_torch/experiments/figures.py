"""The paper-figure notebooks' computations as plain functions (the
notebooks under `experiments/notebooks/` call them and plot what they
return; the JAX package's `experiments/Plot_*.ipynb` do the same work in
their cells).

- `Plot_CIFAR10_resnet` (Figs 3, 5, A.10): `cifar10_fits`, `covariances`,
  `lengthscales`, `family_fits`, `mvt_dfs`.
- `Plot_MNIST_convnet_covariances` (Fig 4): `mnist_fits`, `covariances`,
  `scalar_variances`, `best_families`.
- `Plot_weight_histograms` (Figs 1, 2, A.2): `sgd_model`, `sgd_weights`
  (the SGLD runner at temperature 0: momentum SGD), `weight_leaves`,
  `fit_weights`, `densities`.
- `Plot_temperature_diagnostics`: `temperature_diagnostics` (a
  `VerletSGLDRunner` run streaming its per-leaf kinetic and
  configurational temperatures to a metrics file, then `plot`'s loader,
  sizes and χ² coverage).
- `Plot_tempering_curves`: `tempering_grid` (a bank of chains over
  temperatures × replicates, `evaluate_model` on each chain's samples),
  and `tempering_curve`, `grid_matrix` over a sweep's run dirs as
  `notebook_utils.run_records` reads them (no pandas).

The fitted priors are read from the port's own copies
(`models.default_fits_root()`, `read_fit`). Every function that runs a
model takes `device=`, the card unless the caller asks for the CPU, and a
seed. The module imports neither matplotlib nor pandas; the run's metrics
file is written by `io.HDF5Metrics` and read by `plot.load_metrics`, both
looked up when the function runs.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np
import scipy.stats
import torch
import torch.nn.functional as F

from .. import exp_utils, io, plot
from ..evaluate import evaluate_model
from ..inference import SGLDRunner, VerletSGLDRunner
from ..models.data_driven import default_fits_root, read_fit
from ..parallel.multichain import MultiChainRunner

__all__ = ("FAMILIES", "short", "cifar10_fits", "mnist_fits", "covariances",
           "lengthscales", "family_fits", "mvt_dfs", "scalar_variances",
           "best_families", "sgd_model", "sgd_weights", "weight_leaves",
           "fit_weights", "densities", "temperature_diagnostics",
           "tempering_grid", "tempering_curve", "grid_matrix")

FAMILIES = ("gennorm", "dgamma", "t", "laplace", "cauchy")


def short(key):
    "a fitted leaf's name without the DataParallel prefix and the prior leaf"
    return key.replace("net.module.", "").replace(".weight_prior.p", "")


# -- Plot_CIFAR10_resnet and Plot_MNIST_convnet_covariances --------------------
def cifar10_fits(root=None):
    "(mean_covs, lengthscales, weight_fits) of the CIFAR-10 ResNet-20 fits"
    root = Path(root or default_fits_root())
    return tuple(read_fit(root / name) for name in (
        "cifar10_mean_covs.pkl.gz", "cifar10_fitted_lengthscales.pkl.gz",
        "cifar10_weight_fits.pkl.gz"))


def mnist_fits(root=None):
    "(mean_covs, fits) of the MNIST ConvNet"
    root = Path(root or default_fits_root())
    return tuple(read_fit(root / name) for name in (
        "mean_covs_mnist_classification.pkl.gz",
        "fits_mnist_classification.pkl.gz"))


def covariances(mean_covs, shape=None, n=None):
    """[(key, covariance)] of the leaves with a covariance matrix, in the
    file's order: only those of `shape` if it is given, the first `n` if it
    is given (the CIFAR-10 figure: the first eight 9×9, the 3×3 kernels)"""
    out = [(k, np.asarray(c)) for k, (_, c) in mean_covs.items()
           if np.ndim(c) == 2 and (shape is None or np.shape(c) == shape)]
    return out[:n]


def scalar_variances(mean_covs):
    "{short name: variance} of the leaves fitted a scalar variance"
    return {short(k): float(np.asarray(c)) for k, (_, c) in mean_covs.items()
            if np.ndim(c) == 0}


def lengthscales(fitted):
    "(keys, lengthscales) of the fitted squared-exponential lengthscales"
    keys = list(fitted)
    return keys, np.asarray([fitted[k] for k in keys], dtype=np.float64)


def _ranked(fits):
    "the per-layer ranked fits of a fits file (a dict, or its first entry)"
    return fits[0] if isinstance(fits, (list, tuple)) else fits


def family_fits(weight_fits, families=FAMILIES):
    """(layers, {family: log-likelihood minus the layer's best}, GenNorm β
    per layer); NaN where a layer has no fit of that family"""
    ranked = _ranked(weight_fits)
    layers = list(ranked)
    ll = {f: [] for f in families}
    beta = []
    for lay in layers:
        fits = {name: (lp, prm) for name, lp, prm in ranked[lay]
                if name in families}
        base = max(lp for lp, _ in fits.values())
        for f in families:
            ll[f].append(fits[f][0] - base if f in fits else np.nan)
        beta.append(fits["gennorm"][1][0] if "gennorm" in fits else np.nan)
    return (layers, {f: np.asarray(v, dtype=np.float64)
                     for f, v in ll.items()},
            np.asarray(beta, dtype=np.float64))


def best_families(fits):
    "[(short name, best family, its log-likelihood)] a layer"
    return [(short(lay), fitlist[0][0], fitlist[0][1])
            for lay, fitlist in _ranked(fits).items()]


def mvt_dfs(root=None):
    """(short names, softplus(df)) a layer of the optimised multivariate-t
    priors (`cifar10_opt_mvt.pkl`)"""
    mvt = torch.load(Path(root or default_fits_root()) / "cifar10_opt_mvt.pkl",
                     weights_only=False)
    names, dfs = [], []
    for key, (_lik, prm) in mvt.items():
        names.append(short(key))
        dfs.append(float(F.softplus(prm["df"])))
    return names, np.asarray(dfs, dtype=np.float64)


# -- Plot_weight_histograms ---------------------------------------------------
def sgd_model(x, y, width=32, depth=3, seed=0, device="cuda",
              dtype=torch.float32):
    """the CNN the histograms are drawn from: `classificationconvnet` with
    improper priors (the potential is the likelihood alone), its widths
    from (x, y), drawn from `seed`"""
    return exp_utils.get_model(
        "classificationconvnet", weight_prior="improper", weight_loc=0.0,
        weight_scale=1.41, bias_prior="improper", bias_loc=0.0,
        bias_scale=1.0, batchnorm=True, weight_prior_params={},
        bias_prior_params={}, x_train=x, y_train=y, width=width, depth=depth,
        device=device, dtype=dtype, seed=seed)


def sgd_weights(model, train, epochs=2, learning_rate=5e-3, momentum=0.9,
                batch_size=128, seed=0, device="cuda", metrics_saver=None):
    """`SGLDRunner` at temperature 0, which is momentum SGD (every update at
    noise_std 0): `epochs` epochs, the last one a sampling epoch, each
    step's metrics to `metrics_saver` if one is given. Returns (runner,
    {name: numpy parameter})"""
    runner = SGLDRunner(model, train, None, epochs_per_cycle=epochs,
                        warmup_epochs=0, sample_epochs=1, cycles=1,
                        learning_rate=learning_rate, momentum=momentum,
                        temperature=0.0, batch_size=batch_size,
                        metrics_saver=metrics_saver, seed=seed, device=device)
    runner.run(progressbar=False)
    params = {k: v.detach().cpu().numpy()
              for k, v in runner.kernel.params_of(runner.chain).items()}
    return runner, params


def weight_leaves(params, n=6):
    "the first `n` weight leaves (`...weight_prior.p`)"
    return [k for k in params if "weight_prior.p" in k][:n]


def fit_weights(w):
    """a leaf's weights in f64 divided by their std, and their maximum-
    likelihood normal (loc, scale), Laplace (loc, scale) and Student-t
    (df, loc, scale) fits (scipy)"""
    w = np.asarray(w).ravel().astype(np.float64)
    w = w / w.std()
    return {"w": w, "normal": scipy.stats.norm.fit(w),
            "laplace": scipy.stats.laplace.fit(w),
            "t": scipy.stats.t.fit(w)}


def densities(fit, n=400):
    "(grid over the weights' range, {family: the fitted density on it})"
    w = fit["w"]
    grid = np.linspace(w.min(), w.max(), n)
    return grid, {"normal": scipy.stats.norm.pdf(grid, *fit["normal"]),
                  "laplace": scipy.stats.laplace.pdf(grid, *fit["laplace"]),
                  "t": scipy.stats.t.pdf(grid, *fit["t"])}


# -- Plot_temperature_diagnostics ---------------------------------------------
def temperature_diagnostics(model, train, run_dir, epochs_per_cycle=8,
                            warmup_epochs=4, sample_epochs=4, cycles=3,
                            learning_rate=1e-4, momentum=0.98,
                            temperature=1.0, batch_size=64, seed=1,
                            device="cuda",
                            confidences=(0.05, 0.25, 0.50, 0.75, 0.95)):
    """a `VerletSGLDRunner` run whose saver streams every step's per-leaf
    kinetic (`est_temperature`) and configurational (`est_config_temp`)
    temperatures to `<run_dir>/metrics.h5`, then that file read back.
    Returns a dict: `runner`; `metrics` (`plot.load_metrics`'s nested
    dict); `sizes` (`plot.get_sizes`); `keys` (the leaves, in the file's
    order); `coverage`, the (confidences, rows) fraction of leaves whose
    kinetic temperature lies in its χ²(d) interval (`plot.chi2_coverage`);
    `sampling`, the rows of the sampling epochs"""
    path = os.path.join(run_dir, "metrics.h5")
    with io.HDF5Metrics(path) as saver:
        runner = VerletSGLDRunner(
            model, train, None, epochs_per_cycle=epochs_per_cycle,
            warmup_epochs=warmup_epochs, sample_epochs=sample_epochs,
            cycles=cycles, learning_rate=learning_rate, momentum=momentum,
            temperature=temperature, batch_size=batch_size,
            metrics_saver=saver, seed=seed, device=device)
        runner.run(progressbar=False)
    params = {k: v.detach().cpu().numpy()
              for k, v in runner.kernel.params_of(runner.chain).items()}
    metrics = plot.load_metrics(path)
    sizes = plot.get_sizes(params)
    keys = [k for k in metrics["est_temperature"] if k != "all"]
    est = np.stack([metrics["est_temperature"][k] for k in keys], axis=-1)
    coverage = plot.chi2_coverage(est, metrics["temperature"],
                                  [sizes[k] for k in keys], confidences)
    # row i holds global step i + 1's metrics
    epoch = (np.asarray(metrics["steps"]) + 1) // runner.steps_per_epoch
    sampling = np.asarray([runner._is_sampling_epoch(int(e)) for e in epoch])
    return {"runner": runner, "metrics": metrics, "sizes": sizes,
            "keys": keys, "coverage": coverage, "sampling": sampling}


# -- Plot_tempering_curves ----------------------------------------------------
def tempering_grid(model, train, test, temperatures, replicates,
                   kernel="VerletSGLD", learning_rate=1e-3, momentum=0.9,
                   batch_size=32, cycles=4, epochs_per_cycle=3,
                   warmup_epochs=1, sample_epochs=1, seed=0, device="cuda"):
    """the demo grid: one `MultiChainRunner` bank of temperatures ×
    replicates chains (chain c at temperature c // replicates), then
    `evaluate_model` on each chain's samples. Returns (the (temperatures,
    replicates) matrix of `lp_ensemble`, the runner)"""
    temps = np.repeat(np.asarray(temperatures, dtype=np.float64), replicates)
    runner = MultiChainRunner(
        model, train, n_chains=len(temps), temperatures=temps, kernel=kernel,
        learning_rate=learning_rate, momentum=momentum, batch_size=batch_size,
        cycles=cycles, epochs_per_cycle=epochs_per_cycle,
        warmup_epochs=warmup_epochs, sample_epochs=sample_epochs, seed=seed,
        device=device)
    runner.run(progressbar=False)
    lp = [evaluate_model(runner.model, test, runner.chain_samples(c))[
        "lp_ensemble"] for c in range(len(temps))]
    return np.asarray(lp).reshape(len(temperatures), replicates), runner


def tempering_curve(records, metric="result.lp_ensemble", by="weight_prior"):
    """{`by` value: (temperatures, mean of `metric`)}, both sorted, over
    `notebook_utils.run_records`' records: the notebook's `groupby(by)`,
    then `groupby("temperature")[metric].mean()`"""
    groups = {}
    for r in records:
        groups.setdefault(r[by], {}).setdefault(r["temperature"], []).append(
            r[metric])
    out = {}
    for key in sorted(groups):
        temps = sorted(groups[key])
        out[key] = (np.asarray(temps, dtype=np.float64),
                    np.asarray([math.fsum(groups[key][t]) / len(groups[key][t])
                                for t in temps]))
    return out


def grid_matrix(records, metric="result.lp_ensemble"):
    """(temperatures, replicates, the (temperatures, replicates) matrix of
    `metric`) of a sweep's records; every cell must be filled once"""
    temps = sorted({r["temperature"] for r in records})
    reps = sorted({r["replicate"] for r in records})
    out = np.full((len(temps), len(reps)), np.nan)
    for r in records:
        i, j = temps.index(r["temperature"]), reps.index(r["replicate"])
        assert np.isnan(out[i, j]), (r["temperature"], r["replicate"])
        out[i, j] = r[metric]
    assert not np.isnan(out).any(), "a grid cell has no run"
    return np.asarray(temps), np.asarray(reps), out
