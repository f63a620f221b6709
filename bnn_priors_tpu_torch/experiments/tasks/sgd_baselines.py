"""SGD-baseline sweep as a shared task queue; counterpart of
`experiments/tasks/sgd_baselines.py` (the reference's jug task file
``experiments/jug/0_31_googleresnet_cifar10_sgd.py``).

Run any number of workers (on any number of hosts sharing the log dir):

    python -m bnn_priors_tpu_torch.experiments.tasks.sgd_baselines
    python -m bnn_priors_tpu_torch.experiments.tasks.sgd_baselines status

Each worker claims tasks atomically from ``logs/sgd_baselines/jugdir`` and
runs the port's `train_sgd` as a subprocess (``python -m``) in a run dir of
its own. The 60 tasks and their identities (`Task.hash`) are the JAX task
file's. That file runs a replicate's six tasks in one directory, r<i>,
where their run files overwrite each other; here each task has its own,
``r<i>-<model>-<data>``, one level under the base dir, where `eval_sweep`
collects it.
"""
import sys
from pathlib import Path

from ...exp import TaskQueue, run_script_task

NAME = "sgd_baselines"
MODULE = "bnn_priors_tpu_torch.experiments.train_sgd"
DEFAULT_BASE = Path(__file__).resolve().parents[3] / "logs" / NAME


def declare(base_dir=DEFAULT_BASE) -> TaskQueue:
    """the queue in `base_dir`/jugdir with the sweep's 60 tasks: 10
    replicates of googleresnet on cifar10_augmented and on cifar10, and of
    the CNN and the FCNN on mnist and fashion_mnist; SGD at lr 0.05,
    momentum 0.9, batch 128, the stairs decay, 600 epochs"""
    base_dir = Path(base_dir)
    q = TaskQueue(base_dir / "jugdir")

    @q.generator
    def train_sgd(replicate, **config):
        run_dir = base_dir / f"r{replicate}-{config['model']}-{config['data']}"
        return run_script_task(MODULE, run_dir, style="argparse", **config)

    for i in range(10):
        train_sgd(i, model="googleresnet", data="cifar10_augmented",
                  lr=0.05, momentum=0.9, batch_size=128,
                  sampling_decay="stairs", n_epochs=150 * 4, seed=i)
        train_sgd(i, model="googleresnet", data="cifar10",
                  lr=0.05, momentum=0.9, batch_size=128,
                  sampling_decay="stairs", n_epochs=150 * 4, seed=i)
        for data in ("mnist", "fashion_mnist"):
            for model in ("classificationconvnet", "classificationdensenet"):
                train_sgd(i, model=model, data=data, lr=0.05, momentum=0.9,
                          batch_size=128, sampling_decay="stairs",
                          n_epochs=150 * 4, seed=i)
    return q


def main(argv=None):
    "`status` prints the counts a state; otherwise claim and run tasks"
    argv = sys.argv[1:] if argv is None else argv
    q = declare(DEFAULT_BASE)
    if argv[:1] == ["status"]:
        status = q.status()
        print(status)
        return status
    q.cleanup()
    n = q.execute()
    print(f"[taskqueue] worker finished {n} tasks; status: {q.status()}")
    return n


if __name__ == "__main__":
    main()
