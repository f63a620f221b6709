"""Run-collection utilities for the analysis notebooks; counterpart of
`bnn_priors_tpu/notebook_utils.py`, with the same names.

A sweep directory holds one subdirectory per run, each with `config.json`
and `run.json` (written by `exp.config.RunDirectory` or `train_sgd`);
`collect_runs` turns them into one DataFrame row per run with dot-flattened
keys plus a `the_dir` column, and `unique_cols` lists the swept
hyperparameters. pandas is imported where a DataFrame is built, so the
package imports without it.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ("flatten", "collect_runs", "unique_cols")

# Directories that live alongside run dirs but are not runs: sacred's source
# snapshot dir and the jug task-queue state dir (exp/taskqueue.py creates it).
_NON_RUN_DIRS = frozenset({"_sources", "jugdir"})


def flatten(nested: dict) -> dict:
    "nested dict → flat dict with dot-joined keys ({'a': {'b': 1}} → {'a.b': 1})"
    import pandas as pd
    return pd.json_normalize(nested, sep=".").to_dict(orient="records")[0] \
        if nested else {}


def _read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def collect_runs(base_log_dir, metrics_must_exist=True) -> pd.DataFrame:
    """Gather every run directory under `base_log_dir` into a DataFrame:
    config.json and run.json keys dot-flattened into columns, plus `the_dir`
    (the run directory Path). Runs missing either JSON file — or, with
    `metrics_must_exist`, a metrics.h5 — are skipped (crashed/in-flight)."""
    import pandas as pd
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
    return pd.DataFrame.from_records(records)


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
