"""Run-collection utilities for the analysis notebooks; counterpart of
`bnn_priors_tpu/notebook_utils.py`, with the same names.

A sweep directory holds one subdirectory per run, each with `config.json`
and `run.json` (written by `exp.config.RunDirectory` or `train_sgd`);
`run_records` reads them into one dict per run with dot-flattened keys plus
a `the_dir` entry, `collect_runs` makes those a DataFrame, and
`unique_cols` lists the swept hyperparameters. pandas is imported where a
DataFrame is built, so the package (`flatten` and `run_records` too) runs
without it.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ("flatten", "run_records", "collect_runs", "unique_cols")

# Directories that live alongside run dirs but are not runs: sacred's source
# snapshot dir and the jug task-queue state dir (exp/taskqueue.py creates it).
_NON_RUN_DIRS = frozenset({"_sources", "jugdir"})


def flatten(nested: dict) -> dict:
    """nested dict → flat dict with dot-joined keys ({'a': {'b': 1}} →
    {'a.b': 1}): `pandas.json_normalize(nested, sep=".")`'s record, in its
    order (top-level values in place, each nested dict's keys after them;
    an empty nested dict gives no key), without pandas"""
    return _flatten(nested, "", 0) if nested else {}


def _flatten(d: dict, prefix: str, level: int) -> dict:
    out = dict(d)
    for k, v in d.items():
        key = k if level == 0 else f"{prefix}.{k}"
        if not isinstance(v, dict):
            if level != 0:
                out[key] = out.pop(k)
            continue
        del out[k]
        out.update(_flatten(v, key, level + 1))
    return out


def _read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def run_records(base_log_dir, metrics_must_exist=True) -> list:
    """One dict per run directory under `base_log_dir`: config.json and
    run.json keys dot-flattened, plus `the_dir` (the run directory Path).
    Runs missing either JSON file — or, with `metrics_must_exist`, a
    metrics.h5 — are skipped (crashed/in-flight). No pandas."""
    records = []
    for run_dir in sorted(Path(base_log_dir).iterdir()):
        if not run_dir.is_dir() or run_dir.name in _NON_RUN_DIRS:
            continue
        if metrics_must_exist and not (run_dir / "metrics.h5").is_file():
            continue
        try:
            record = {**flatten(_read_json(run_dir / "config.json")),
                      **flatten(_read_json(run_dir / "run.json"))}
        except FileNotFoundError:
            continue
        record["the_dir"] = run_dir
        records.append(record)
    return records


def collect_runs(base_log_dir, metrics_must_exist=True) -> pd.DataFrame:
    """Gather every run directory under `base_log_dir` into a DataFrame,
    one row of `run_records` a run."""
    import pandas as pd
    return pd.DataFrame.from_records(
        run_records(base_log_dir, metrics_must_exist))


# Columns that differ between runs without being swept hyperparameters:
# run-lifecycle bookkeeping and result metrics.
_DEFAULT_BLACKLIST = {
    "heartbeat", "log_dir", "run_id", "start_time", "status", "stop_time",
    "the_dir", "seed",
} | {f"result.{k}" for k in
     ("acc_last", "acc_ensemble", "lp_last", "lp_ensemble", "ece", "ace",
      "rmsce", "auroc", "auprc")}


def unique_cols(df: pd.DataFrame, blacklist=None):
    "columns that vary across runs (the swept hyperparameters)"
    blacklist = _DEFAULT_BLACKLIST if blacklist is None else blacklist
    cols = []
    for c in df.columns:
        if c in blacklist:
            continue
        try:
            if df[c].astype(str).nunique() > 1:
                cols.append(c)
        except TypeError:
            continue
    return cols
