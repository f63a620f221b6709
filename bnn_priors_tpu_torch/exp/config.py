"""Sacred-style CLI config: defaults + `with key=value` overrides
(counterpart of `bnn_priors_tpu/exp/config.py`, kept as a copy of its own:
the port imports nothing of the JAX package).

The reference uses sacred (`train_bnn.py:38-116`), whose CLI syntax is
`python -m bnn_priors_tpu_torch.experiments.train_bnn with data=fake_cifar10
lr=0.01 weight_prior_params='{"a":1}'`. This module reproduces that syntax
(including nested dotted keys and JSON-encoded dict values) on top of a
plain dict, and the FileStorageObserver layout: numbered run dirs with
`config.json` and `run.json`.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict


def parse_cli(defaults: Dict[str, Any], argv=None) -> Dict[str, Any]:
    argv = argv if argv is not None else sys.argv[1:]
    cfg = dict(defaults)
    args = list(argv)
    if args and args[0] == "with":
        args = args[1:]
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        # sacred errors on unknown config keys; a typo'd override must not
        # silently leave the default in place for a multi-hour run. Dotted
        # keys may extend dict-valued defaults (weight_prior_params.a=1).
        root = key.split(".")[0]
        if root not in cfg:
            raise KeyError(f"unknown config key {key!r} "
                           f"(known: {', '.join(sorted(cfg))})")
        cfg_set(cfg, key, coerce(value, cfg_get(cfg, key)))
    return cfg


def cfg_get(cfg, dotted):
    cur = cfg
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def cfg_set(cfg, dotted, value):
    parts = dotted.split(".")
    cur = cfg
    for part in parts[:-1]:
        cur = cur.setdefault(part, {})
    cur[parts[-1]] = value


def coerce(value: str, default):
    "string → typed value, guided by the default's type / JSON syntax"
    if isinstance(default, dict) or value[:1] in "[{":
        return json.loads(value)
    if isinstance(default, bool) or value in ("True", "False", "true", "false"):
        # accept the common truthy/falsy spellings; anything else is an
        # error — `batchnorm=1` silently meaning False would invert the run
        low = value.lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"cannot parse {value!r} as a bool")
    if value == "None":
        return None
    if isinstance(default, int) and not isinstance(default, bool):
        try:
            return int(value)
        except ValueError:
            pass
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


class RunDirectory:
    "FileStorageObserver-like numbered run dir: config.json + run.json"

    def __init__(self, log_dir, config: Dict[str, Any]):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        n = 1
        while True:
            d = log_dir / str(n)
            try:
                d.mkdir()
                break
            except FileExistsError:
                n += 1
        self.dir = d
        self.run_id = n
        self.config = config
        with open(d / "config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)
        self._run = {"status": "RUNNING", "start_time": time.time(),
                     "artifacts": [], "result": None}
        self._write_run()

    def _write_run(self):
        with open(self.dir / "run.json", "w") as f:
            json.dump(self._run, f, indent=2, default=str)

    def artifact(self, name: str) -> Path:
        "register and return the path of an artifact (cf. sneaky_artifact)"
        if name not in self._run["artifacts"]:
            self._run["artifacts"].append(name)
            self._write_run()
        return self.dir / name

    def finish(self, result):
        self._run["status"] = "COMPLETED"
        self._run["result"] = result
        self._run["stop_time"] = time.time()
        self._write_run()

    def fail(self, err):
        self._run["status"] = "FAILED"
        self._run["fail_trace"] = str(err)
        self._run["stop_time"] = time.time()
        self._write_run()
