"""Evaluation fan-out over finished training runs; counterpart of
`experiments/tasks/eval_sweep.py` (the reference's
``experiments/jug/0_31_eval.py``): collect the completed runs of a log dir,
then queue the paper's three `eval_bnn` calls a run for any number of
workers.

    python -m bnn_priors_tpu_torch.experiments.tasks.eval_sweep \\
        <base_log_dir> [status]

The tasks and their identities (`Task.hash`) are the JAX task file's. The
evaluations' run dirs go to ``<base_log_dir>/evals`` (the JAX task file
runs eval_bnn there, which writes them to its default log dir instead).
Collecting the runs needs pandas (`notebook_utils.collect_runs`).
"""
import sys
from pathlib import Path

from ...exp import TaskQueue, run_script_task
from ...notebook_utils import collect_runs
from .sgd_baselines import DEFAULT_BASE

MODULE = "bnn_priors_tpu_torch.experiments.eval_bnn"


def declare(base=DEFAULT_BASE) -> TaskQueue:
    """the queue in `base`/eval_jugdir with three tasks a completed run of
    `base`: plain, `cifar10c-gaussian_blur` with calibration_eval and `svhn`
    with ood_eval, all with skip_first=50"""
    base = Path(base)
    q = TaskQueue(base / "eval_jugdir")

    @q.generator
    def eval_bnn(config_file, **config):
        return run_script_task(MODULE, base / "evals", style="sacred",
                               config_file=config_file,
                               log_dir=str(base / "evals"), **config)

    runs_df = collect_runs(base)
    for _, row in runs_df.iterrows():
        cfg = Path(row["the_dir"]) / "config.json"
        eval_bnn(str(cfg), skip_first=50)
        eval_bnn(str(cfg), eval_data="cifar10c-gaussian_blur",
                 calibration_eval=True, skip_first=50)
        eval_bnn(str(cfg), eval_data="svhn", ood_eval=True, skip_first=50)
    return q


def main(argv=None):
    "`<base> status` prints the counts a state; `<base>` claims and runs"
    argv = sys.argv[1:] if argv is None else argv
    q = declare(Path(argv[0]) if argv else DEFAULT_BASE)
    if argv[1:2] == ["status"]:
        status = q.status()
        print(status)
        return status
    q.cleanup()
    n = q.execute()
    print(f"[taskqueue] worker finished {n} tasks; status: {q.status()}")
    return n


if __name__ == "__main__":
    main()
