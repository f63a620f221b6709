"""File-locked task queue for multi-host experiment fan-out; counterpart
of `bnn_priors_tpu/exp/taskqueue.py`, with the same names, records and task
identities.

A task script *declares* a grid of tasks; any number of worker processes
run it against a shared "jugdir", claiming tasks atomically through the
filesystem, so a sweep scales across hosts with no coordinator (jug's
execution model, as in the reference's ``experiments/jug/*.py``):

- a task is *claimed* by atomically creating ``<name>-<hash>.lock``;
- a finished task has ``<name>-<hash>/result.json``; re-running the script
  skips it;
- a crashed worker leaves a stale lock: ``invalidate`` (cf. ``jug
  invalidate``) or ``cleanup(stale_s=...)`` reclaims it.

A task's hash is the sha256 of the same JSON as the JAX package's, so a
jugdir written by either package's queue reads the same in the other.

Each worker process pins itself to one card with ``CUDA_VISIBLE_DEVICES``
in the ``env`` argument of `run_script_task` (one GPU a process).
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

__all__ = ("Task", "TaskQueue", "BarrierNotReady", "run_script_task")

# the checkout's root: the directory that holds the package
_ROOT = Path(__file__).resolve().parents[2]


class BarrierNotReady(Exception):
    """Raised by `TaskQueue.barrier()` while upstream tasks are outstanding
    (the jug pattern: re-run the script until the barrier passes)."""


def _task_hash(name: str, args, kwargs) -> str:
    payload = json.dumps([name, list(args), dict(sorted(kwargs.items()))],
                         default=str, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class Task:
    """One unit of work: ``fn(*args, **kwargs)``, identified by a stable
    content hash of (fn name, args) — same identity scheme as jug, so a
    grid declared twice maps onto the same records."""

    def __init__(self, fn: Callable, *args, **kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = getattr(fn, "__name__", str(fn))
        self.hash = _task_hash(self.name, args, kwargs)

    def describe(self) -> str:
        parts = [repr(a) for a in self.args]
        parts += [f"{k}={v!r}" for k, v in sorted(self.kwargs.items())]
        return f"{self.name}({', '.join(parts)})"


class TaskQueue:
    """A shared task directory ("jugdir") plus the declared task list.

    Usage (mirrors a jug task file)::

        q = TaskQueue(log_dir / "jugdir")

        @q.generator
        def train_sgd(replicate, **config): ...

        for i in range(10):
            train_sgd(i, model="googleresnet", data="cifar10_augmented")

        q.execute()          # in every worker process, on every host
    """

    def __init__(self, jugdir):
        self.jugdir = Path(jugdir)
        self.jugdir.mkdir(parents=True, exist_ok=True)
        self.tasks: List[Task] = []
        self._barriers = 0

    # -- declaration -------------------------------------------------------
    def add(self, fn: Callable, *args, **kwargs) -> Task:
        t = Task(fn, *args, **kwargs)
        self.tasks.append(t)
        return t

    def generator(self, fn: Callable) -> Callable:
        "decorator: calling the function enqueues a Task (jug.TaskGenerator)"
        def enqueue(*args, **kwargs):
            return self.add(fn, *args, **kwargs)
        enqueue.__name__ = getattr(fn, "__name__", "task")
        enqueue.original = fn
        return enqueue

    # -- state -------------------------------------------------------------
    def _dir(self, t: Task) -> Path:
        return self.jugdir / f"{t.name}-{t.hash}"

    def _lock(self, t: Task) -> Path:
        return self.jugdir / f"{t.name}-{t.hash}.lock"

    def _result_status(self, t: Task) -> Optional[str]:
        """Status from the durable result record, or None if there is no
        readable record (missing, being invalidated, or torn read on a
        shared filesystem — all mean "no durable record yet")."""
        try:
            with open(self._dir(t) / "result.json") as f:
                return json.load(f)["status"]  # "done"|"failed"|"waiting"
        except (OSError, json.JSONDecodeError, KeyError):
            # OSError covers FileNotFoundError plus transient shared-fs
            # errors (NFS ESTALE); KeyError covers a torn/partial record
            # that parsed as JSON but lacks "status"
            return None

    def state(self, t: Task) -> str:
        status = self._result_status(t)
        if status is not None:
            return status
        if self._lock(t).exists():
            return "running"
        return "waiting"

    def status(self) -> Dict[str, int]:
        "counts per state, like `jug status`"
        counts = {"waiting": 0, "running": 0, "done": 0, "failed": 0}
        for t in self.tasks:
            counts[self.state(t)] += 1
        return counts

    def result(self, t: Task):
        with open(self._dir(t) / "result.json") as f:
            rec = json.load(f)
        if rec["status"] != "done":
            raise RuntimeError(f"task {t.describe()} is {rec['status']}")
        return rec["result"]

    # -- claiming / execution ----------------------------------------------
    def _claim(self, t: Task) -> bool:
        "atomic at-most-once claim via O_CREAT|O_EXCL"
        try:
            fd = os.open(self._lock(t), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump({"pid": os.getpid(), "host": os.uname().nodename,
                       "time": time.time()}, f)
        return True

    def _finish(self, t: Task, status: str, result=None, error=None):
        d = self._dir(t)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / ".result.tmp"
        with open(tmp, "w") as f:
            json.dump({"status": status, "result": result, "error": error,
                       "task": t.describe(), "time": time.time()}, f,
                      indent=2, default=str)
        os.replace(tmp, d / "result.json")
        self._lock(t).unlink(missing_ok=True)

    def execute(self, max_tasks: Optional[int] = None,
                keep_failed: bool = True, verbose: bool = True) -> int:
        """Worker loop: claim + run every waiting task (jug execute).
        Returns the number of tasks this worker completed."""
        ran = 0
        done = 0
        for t in self.tasks:
            if max_tasks is not None and ran >= max_tasks:
                break
            if self.state(t) != "waiting" or not self._claim(t):
                continue
            # Double-check under the lock: another worker may have claimed,
            # finished, and removed its lock between our state check and our
            # claim — its result.json is the durable record of that.
            status = self._result_status(t)
            if status is not None and status != "waiting":
                self._lock(t).unlink(missing_ok=True)
                continue
            if verbose:
                print(f"[taskqueue] running {t.describe()}", flush=True)
            ran += 1  # counts executions (incl. failures) toward max_tasks
            try:
                result = t.fn(*t.args, **t.kwargs)
            except Exception as e:  # noqa: BLE001 — record, don't kill the worker
                self._finish(t, "failed" if keep_failed else "waiting",
                             error="".join(traceback.format_exception(e)))
                if verbose:
                    print(f"[taskqueue] FAILED {t.describe()}: {e}", flush=True)
            else:
                self._finish(t, "done", result=result)
                done += 1
        return done

    def barrier(self):
        """All tasks declared so far must be done before the script may
        proceed (jug.barrier): raise BarrierNotReady otherwise. Re-run the
        script after more workers finish."""
        st = self.status()
        if st["waiting"] or st["running"]:
            raise BarrierNotReady(
                f"{st['waiting']} waiting + {st['running']} running tasks "
                f"before barrier {self._barriers}")
        if st["failed"]:
            raise RuntimeError(f"{st['failed']} failed tasks before barrier; "
                               "invalidate() them to retry")
        self._barriers += 1

    # -- maintenance ---------------------------------------------------------
    def invalidate(self, name: Optional[str] = None, failed_only: bool = True):
        "clear results/locks so tasks rerun (jug invalidate)"
        for t in self.tasks:
            if name is not None and t.name != name:
                continue
            if failed_only and self.state(t) != "failed":
                continue
            res = self._dir(t) / "result.json"
            res.unlink(missing_ok=True)
            self._lock(t).unlink(missing_ok=True)

    def cleanup(self, stale_s: float = 24 * 3600.0):
        "drop locks older than stale_s (crashed workers) so tasks re-run"
        now = time.time()
        for t in self.tasks:
            lock = self._lock(t)
            try:
                if lock.exists() and now - lock.stat().st_mtime > stale_s:
                    lock.unlink()
            except FileNotFoundError:
                pass


def cli_args(style: str, **config) -> List[str]:
    """a CLI's arguments for `config`: style="argparse" gives ``--k=v``
    flags, style="sacred" ``with k=v``"""
    if style == "argparse":
        return [f"--{k}={v}" for k, v in config.items()]
    if style == "sacred":
        return ["with"] + [f"{k}={v}" for k, v in config.items()]
    raise ValueError(style)


def run_script_task(module: str, log_dir, /, style: str = "argparse",
                    env: Optional[Dict[str, str]] = None, **config):
    """Run one of the port's CLIs, ``python -m <module>``, as a subprocess
    whose working directory is `log_dir` (made if missing): the body of a
    task of the task files (`experiments/tasks/`). The CLIs import the
    package relatively, so the checkout's root is put first on the child's
    ``PYTHONPATH``. Returns `log_dir` as a string; a nonzero exit raises
    SystemError. `module` and `log_dir` are positional only, so a CLI's
    own `log_dir` key can be among the `config` keys.

    `style` is `cli_args`'s: "argparse" for train_sgd, "sacred" for
    train_bnn, eval_bnn and sweep_tempering. `env` adds
    to the environment, e.g. ``{"CUDA_VISIBLE_DEVICES": "1"}`` to pin the
    worker's card."""
    args = cli_args(style, **config)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", module, *args]
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    full_env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in [full_env.get("PYTHONPATH")] if p])
    print(f"[taskqueue] {' '.join(cmd)} (cwd={log_dir})", flush=True)
    complete = subprocess.run(cmd, cwd=log_dir, env=full_env)
    if complete.returncode != 0:
        raise SystemError(f"process returned {complete.returncode}")
    return str(log_dir)
