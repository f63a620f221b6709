"""The port's task queue (`bnn_priors_tpu_torch.exp.taskqueue`) and task
files (`bnn_priors_tpu_torch.experiments.tasks`): the cases of
tests/test_taskqueue.py against the port's queue (at-most-once claiming
across concurrent workers, failure records, barriers, invalidation, stale
locks), task identities equal to the JAX package's, a jugdir that JAX's
queue wrote read by the port's, the two task files' grids, and
`run_script_task` launching the port's CLIs as `python -m` subprocesses.
"""
import importlib
import json
import pathlib
import threading
import time

import pytest

from bnn_priors_tpu.exp import TaskQueue as JaxTaskQueue
from bnn_priors_tpu.exp.taskqueue import _task_hash as jax_task_hash
from bnn_priors_tpu_torch import exp
from bnn_priors_tpu_torch.exp import (BarrierNotReady, Task, TaskQueue,
                                      run_script_task)
from bnn_priors_tpu_torch.experiments.tasks import eval_sweep, sgd_baselines
from bnn_priors_tpu_torch.exp.config import RunDirectory


def make_queue(tmp_path, log, cls=TaskQueue):
    q = cls(tmp_path / "jugdir")

    @q.generator
    def work(i):
        log.append(i)
        return i * 10

    for i in range(20):
        work(i)
    return q


def test_exports():
    assert {"Task", "TaskQueue", "BarrierNotReady",
            "run_script_task"} <= set(exp.__all__)
    assert exp.TaskQueue is TaskQueue and exp.Task is Task


@pytest.mark.parametrize("redeclare", [False, True])
def test_execute_runs_each_task_once(tmp_path, redeclare):
    """every task runs once; executing again, with the same queue or with
    the grid declared anew (the same task records, as jug hashes), runs
    nothing"""
    log = []
    q = make_queue(tmp_path, log)
    assert q.status() == {"waiting": 20, "running": 0, "done": 0, "failed": 0}
    assert q.execute(verbose=False) == 20
    assert sorted(log) == list(range(20))
    assert q.status()["done"] == 20
    log2 = []
    q2 = make_queue(tmp_path, log2) if redeclare else q
    assert q2.status()["done"] == 20
    assert q2.execute(verbose=False) == 0
    assert sorted(log) == list(range(20)) and log2 == []
    assert q2.result(q2.tasks[3]) == 30


def test_two_workers_share_disjointly(tmp_path):
    "two concurrent workers on the same jugdir never run the same task"
    log = []
    qs = [make_queue(tmp_path, log) for _ in range(2)]
    counts = [0, 0]

    def worker(j):
        counts[j] = qs[j].execute(verbose=False)

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(counts) == 20
    assert sorted(log) == list(range(20))  # each exactly once


def test_failure_recorded_and_invalidated(tmp_path):
    q = TaskQueue(tmp_path / "jugdir")
    state = {"fail": True}

    @q.generator
    def flaky():
        if state["fail"]:
            raise ValueError("boom")
        return "ok"

    flaky()
    q.execute(verbose=False)
    assert q.status()["failed"] == 1
    rec = json.loads((q._dir(q.tasks[0]) / "result.json").read_text())
    assert "boom" in rec["error"]
    with pytest.raises(RuntimeError):
        q.barrier()
    with pytest.raises(RuntimeError, match="failed"):
        q.result(q.tasks[0])
    state["fail"] = False
    q.invalidate()
    assert q.status()["waiting"] == 1
    q.execute(verbose=False)
    assert q.status()["done"] == 1
    q.barrier()
    assert q.result(q.tasks[0]) == "ok"


def test_barrier_not_ready(tmp_path):
    q = TaskQueue(tmp_path / "jugdir")

    @q.generator
    def work():
        return 1

    work()
    with pytest.raises(BarrierNotReady):
        q.barrier()
    q.execute(verbose=False)
    q.barrier()


def test_stale_lock_cleanup(tmp_path):
    "a crashed worker's lock is reclaimed by cleanup(stale_s)"
    log = []
    q = make_queue(tmp_path, log)
    t0 = q.tasks[0]
    assert q._claim(t0)  # a worker that died while holding the lock
    assert q.state(t0) == "running"
    assert not q._claim(t0)  # O_CREAT|O_EXCL: a second claim fails
    q.cleanup(stale_s=1e9)  # not stale yet
    assert q.state(t0) == "running"
    time.sleep(0.01)
    q.cleanup(stale_s=0.0)
    assert q.state(t0) == "waiting"
    q.execute(verbose=False)
    assert q.status()["done"] == 20


def test_post_claim_double_check(tmp_path, monkeypatch):
    """a task that gains a durable 'done' record between the state check
    and the claim does not run again"""
    log = []
    q = make_queue(tmp_path, log)
    t0 = q.tasks[0]
    real_state = q.state
    fired = {"n": 0}

    def racy_state(t):
        st = real_state(t)
        if t is t0 and st == "waiting" and fired["n"] == 0:
            # a fast peer claims, finishes and unlocks in between
            fired["n"] = 1
            q._finish(t0, "done", result=999)
        return st

    monkeypatch.setattr(q, "state", racy_state)
    assert q.execute(verbose=False) == 19
    assert sorted(log) == list(range(1, 20))
    assert not q._lock(t0).exists()
    assert q.result(t0) == 999


@pytest.mark.parametrize("record", ["{not json", '{"result": 1}'])
def test_unreadable_result_record_is_no_record(tmp_path, record):
    "a torn or partial result.json reads as no durable record"
    log = []
    q = make_queue(tmp_path, log)
    t0 = q.tasks[0]
    d = q._dir(t0)
    d.mkdir(parents=True, exist_ok=True)
    (d / "result.json").write_text(record)
    assert q.state(t0) == "waiting"
    assert q.execute(verbose=False) == 20  # overwrites the torn record
    assert q.result(t0) == 0


def test_max_tasks_bounds_failures_too(tmp_path):
    "max_tasks time-boxes executions, not merely successes"
    q = TaskQueue(tmp_path / "jugdir")
    calls = []

    @q.generator
    def boom(i):
        calls.append(i)
        raise ValueError(i)

    for i in range(10):
        boom(i)
    assert q.execute(max_tasks=3, verbose=False) == 0
    assert len(calls) == 3
    assert q.status()["failed"] == 3
    q.invalidate(name="other")  # another name's tasks: nothing cleared
    assert q.status()["failed"] == 3


@pytest.mark.parametrize("args,kwargs", [
    ((3,), {}),
    ((0,), {"model": "googleresnet", "data": "cifar10", "lr": 0.05,
            "n_epochs": 600, "seed": 0}),
    (("/runs/1/config.json",), {"eval_data": "svhn", "ood_eval": True,
                                "skip_first": 50}),
    ((pathlib.Path("/runs/1"), [1, 2]), {"b": None, "a": {"x": 1.5}}),
])
def test_task_hash_matches_jax(tmp_path, args, kwargs):
    "a task has the same identity and record names in both packages"
    def work(*a, **k):
        return None
    t = Task(work, *args, **kwargs)
    assert t.hash == jax_task_hash("work", args, kwargs)
    jq = JaxTaskQueue(tmp_path / "j")
    assert jq.add(work, *args, **kwargs).hash == t.hash
    q = TaskQueue(tmp_path / "t")
    assert q._dir(t).name == jq._dir(jq.tasks[0]).name
    assert t.describe() == jq.tasks[0].describe()


def test_jax_jugdir_reads_done_in_the_port(tmp_path):
    "a jugdir whose tasks JAX's queue finished: done, with its results"
    jlog, log = [], []
    jq = make_queue(tmp_path, jlog, cls=JaxTaskQueue)
    assert jq.execute(max_tasks=12, verbose=False) == 12
    q = make_queue(tmp_path, log)
    assert q.status() == {"waiting": 8, "running": 0, "done": 12,
                          "failed": 0}
    assert [q.result(t) for t in q.tasks[:12]] == [10 * i for i in range(12)]
    assert q.execute(verbose=False) == 8
    assert sorted(log) == list(range(12, 20))
    # and back: the port's records read as done in JAX's queue
    assert jq.status()["done"] == 20


def test_task_files_import_without_writing(monkeypatch):
    "importing (or reloading) a task file makes no directory and no file"
    def refuse(*a, **k):
        raise AssertionError("a task file wrote at import")
    monkeypatch.setattr(pathlib.Path, "mkdir", refuse)
    monkeypatch.setattr(pathlib.Path, "touch", refuse)
    importlib.reload(sgd_baselines)
    importlib.reload(eval_sweep)
    monkeypatch.undo()
    assert sgd_baselines.DEFAULT_BASE == (
        pathlib.Path(sgd_baselines.__file__).resolve().parents[3] / "logs"
        / "sgd_baselines")


def _jax_sgd_grid():
    "the JAX task file's 60 declarations, as (args, kwargs)"
    out = []
    common = dict(lr=0.05, momentum=0.9, batch_size=128,
                  sampling_decay="stairs", n_epochs=600)
    for i in range(10):
        for model, data in (("googleresnet", "cifar10_augmented"),
                            ("googleresnet", "cifar10")):
            out.append(((i,), dict(model=model, data=data, **common,
                                   seed=i)))
        for data in ("mnist", "fashion_mnist"):
            for model in ("classificationconvnet", "classificationdensenet"):
                out.append(((i,), dict(model=model, data=data, **common,
                                       seed=i)))
    return out


def test_sgd_baselines_grid(tmp_path):
    q = sgd_baselines.declare(tmp_path)
    assert (tmp_path / "jugdir").is_dir()
    assert len(q.tasks) == 60 and {t.name for t in q.tasks} == {"train_sgd"}
    assert [t.hash for t in q.tasks] == [
        jax_task_hash("train_sgd", a, k) for a, k in _jax_sgd_grid()]
    assert len({t.hash for t in q.tasks}) == 60
    assert q.status() == {"waiting": 60, "running": 0, "done": 0,
                          "failed": 0}


def test_task_files_status(tmp_path, monkeypatch, capsys):
    "`status` prints the counts a state and runs nothing"
    monkeypatch.setattr(sgd_baselines, "DEFAULT_BASE", tmp_path / "sgd")
    waiting = {"waiting": 60, "running": 0, "done": 0, "failed": 0}
    assert sgd_baselines.main(["status"]) == waiting
    assert eval_sweep.main([str(tmp_path / "sgd"), "status"]) == {
        "waiting": 0, "running": 0, "done": 0, "failed": 0}
    out = capsys.readouterr().out.splitlines()
    assert out == [str(waiting), str({"waiting": 0, "running": 0, "done": 0,
                                      "failed": 0})]
    assert sorted(p.name for p in (tmp_path / "sgd").iterdir()) == [
        "eval_jugdir", "jugdir"]


def test_eval_sweep_grid(tmp_path):
    "three tasks a completed run; the queue's and evals' dirs are no runs"
    for i, lr in enumerate([0.01, 0.05]):
        run = RunDirectory(tmp_path, {"lr": lr})
        (run.dir / "metrics.h5").touch()
        run.finish({"acc_ensemble": 0.5 + i})
    RunDirectory(tmp_path, {"lr": 0.1})  # no metrics.h5: in flight
    (tmp_path / "jugdir").mkdir()
    q = eval_sweep.declare(tmp_path)
    assert (tmp_path / "eval_jugdir").is_dir()
    assert len(q.tasks) == 6 and {t.name for t in q.tasks} == {"eval_bnn"}
    expected = []
    for n in (1, 2):
        cfg = str(tmp_path / str(n) / "config.json")
        for kw in ({"skip_first": 50},
                   {"eval_data": "cifar10c-gaussian_blur",
                    "calibration_eval": True, "skip_first": 50},
                   {"eval_data": "svhn", "ood_eval": True,
                    "skip_first": 50}):
            expected.append(jax_task_hash("eval_bnn", (cfg,), kw))
    assert [t.hash for t in q.tasks] == expected
    # declared again over the same dirs: the same tasks
    assert [t.hash for t in eval_sweep.declare(tmp_path).tasks] == expected


def test_run_script_task_refuses(tmp_path):
    with pytest.raises(ValueError):
        run_script_task("bnn_priors_tpu_torch.experiments.train_sgd",
                        tmp_path, style="yaml")
    with pytest.raises(SystemError, match="returned"):
        run_script_task("bnn_priors_tpu_torch.experiments.no_such_cli",
                        tmp_path / "x")


def test_run_script_task_runs_the_clis(tmp_path):
    """train_sgd (argparse flags) and train_bnn then eval_bnn (sacred `with
    k=v`) as `python -m` subprocesses, each in its own working directory,
    on the CPU at the smallest size: COMPLETED runs, and eval_bnn
    reproduces train_bnn's result"""
    sgd_dir = tmp_path / "sgd"
    assert run_script_task(
        "bnn_priors_tpu_torch.experiments.train_sgd", sgd_dir,
        style="argparse", data="random", model="densenet", width=8,
        n_epochs=2, epochs_per_sample=1, skip_first=1, batch_size=256,
        device="cpu") == str(sgd_dir)
    # --log_dir defaults to ".": the run files land in the working dir
    run = json.loads((sgd_dir / "run.json").read_text())
    assert run["status"] == "COMPLETED"
    assert json.loads((sgd_dir / "config.json").read_text())["n_epochs"] == 2
    assert {"config.json", "run.json", "metrics.h5", "samples.pt"} <= {
        p.name for p in sgd_dir.iterdir()}

    runs = tmp_path / "bnn"
    run_script_task(
        "bnn_priors_tpu_torch.experiments.train_bnn", tmp_path / "cwd",
        style="sacred", data="random", model="densenet", width=8, cycles=1,
        warmup=1, n_samples=2, skip_first=0, batch_size=256, device="cpu",
        progressbar=False, log_dir=str(runs))
    trained = json.loads((runs / "1" / "run.json").read_text())
    assert trained["status"] == "COMPLETED"
    run_script_task(
        "bnn_priors_tpu_torch.experiments.eval_bnn", tmp_path / "cwd",
        style="sacred", run_dir=str(runs / "1"), skip_first=0, device="cpu",
        log_dir=str(tmp_path / "evals"))
    evaluated = json.loads((tmp_path / "evals" / "1" / "run.json")
                           .read_text())
    assert evaluated["status"] == "COMPLETED"
    for k, v in trained["result"].items():
        assert evaluated["result"][k] == pytest.approx(v, rel=1e-5), k
