"""Evaluation script (counterpart of `experiments/eval_bnn.py`): re-load a
training run's samples and evaluate the posterior predictive.

    python -m bnn_priors_tpu_torch.experiments.eval_bnn with \\
        run_dir=logs/1 calibration_eval=True skip_first=0

It evaluates run directories written by either package's `train_bnn` or
`sweep_tempering` (one a chain), classification runs (with `eval_data`,
e.g. `rotated_mnist` or `fashion_mnist` for an MNIST run) and regression
runs (`UCI_<name>`: the ensemble's log-likelihood and squared errors).
The paper's three calls a run (`experiments/run_evaluation.sh`):

    ... eval_bnn with run_dir=logs/1
    ... eval_bnn with run_dir=logs/1 eval_data=cifar10c-gaussian_blur \
        calibration_eval=True
    ... eval_bnn with run_dir=logs/1 eval_data=svhn ood_eval=True

`ood_eval=True` is score-only: AUROC and AUPRC of the training data's test
split (in-distribution) against `eval_data`'s test split, no ensemble
metrics (eval_bnn.py:112-124). `marglik_eval=True` adds the simple
marginal likelihood of the bank's log priors. Post-hoc rejected-sample
resolution (`reject_samples_`) runs before ensembling, like the reference
(eval_bnn.py:104-110). `n_devices=D` (D > 1) splits the sample bank over
the first D devices of this process (`evaluate_model(mesh=)`); asking for
more devices than there are raises, naming both counts, before the run
dir is made (eval_bnn.py:59-66).
"""
import json
from pathlib import Path

from ..exp.config import RunDirectory, parse_cli
from .train_bnn import REPO, check_device, model_of, set_float32

DEFAULTS = dict(
    config_file=None,       # path to the training run's config.json
    run_dir=None,           # alternatively: the run directory itself
    eval_data=None,         # dataset for evaluation (default: training data)
    eval_samples=None,      # override the samples file
    skip_first=50,
    calibration_eval=False,
    ood_eval=False,
    marglik_eval=False,
    device="cuda",          # cuda | cpu
    batch_size=512,
    n_devices=None,        # >1: split the sample bank over devices for eval
    log_dir=str(REPO / "logs_eval"),
)


def sample_mesh(n_devices, device):
    """the `samples` mesh over the first `n_devices` devices (this
    process's: eval runs in one) that splits the sample bank, or None for
    one device; more than there are raises, naming both counts"""
    if int(n_devices or 1) <= 1:
        return None
    from ..parallel.distributed import global_chains_mesh
    return global_chains_mesh(int(n_devices), device, axis="samples")


def main(cfg):
    check_device(cfg["device"])
    mesh = sample_mesh(cfg["n_devices"], cfg["device"])
    set_float32(cfg["device"])

    from .. import exp_utils
    from ..evaluate import (evaluate_marglik, evaluate_model, evaluate_ood,
                            reject_samples_)
    from ..io import load_metrics, load_samples

    if cfg["run_dir"] is not None and cfg["config_file"] is None:
        cfg["config_file"] = str(Path(cfg["run_dir"]) / "config.json")
    assert cfg["config_file"], "config_file or run_dir required"
    with open(cfg["config_file"]) as f:
        train_cfg = json.load(f)
    run_dir = Path(cfg["config_file"]).parent
    samples_file = cfg["eval_samples"] or str(run_dir / "samples.pt")

    run = RunDirectory(cfg["log_dir"], {**train_cfg, **cfg})

    device = cfg["device"]
    if cfg["eval_data"]:
        # pinned to the train seed, so repeated evals score the same points
        data = exp_utils.get_data_seeded(cfg["eval_data"], train_cfg["seed"],
                                         device=device)
    else:
        data = exp_utils.get_data_from_config(train_cfg, device=device)
    x_test, y_test = data.norm.test
    # the model's widths from the evaluation data's training split, as the
    # JAX CLI takes them
    model = model_of(train_cfg, device, train=data.norm.train)

    samples = load_samples(samples_file, keep_steps=True)
    metrics_path = run_dir / "metrics.h5"
    if metrics_path.exists():
        metrics = load_metrics(metrics_path, ("steps", "acceptance/is_sample",
                                              "acceptance/rejected"))
        if "acceptance/rejected" in metrics:
            samples = reject_samples_(samples, metrics)
    samples = {k: v[cfg["skip_first"]:] for k, v in samples.items()}
    n_left = min((v.shape[0] for v in samples.values()), default=0)
    assert n_left > 0, (
        f"skip_first={cfg['skip_first']} leaves no samples to evaluate "
        f"(the bank in {samples_file} is smaller); pass skip_first=0 "
        "or rerun training with more n_samples")

    if cfg["ood_eval"]:
        # score-only, as the reference (eval_bnn.py:120-124): the OOD set's
        # labels need not be class labels; in-distribution is the training
        # data's test split
        ind = exp_utils.get_data_from_config(train_cfg, device=device)
        result = evaluate_ood(model, ind.norm.test, (x_test, y_test), samples,
                              batch_size=cfg["batch_size"], mesh=mesh)
    else:
        result = evaluate_model(
            model, (x_test, y_test), samples, likelihood_eval=True,
            accuracy_eval=True, calibration_eval=cfg["calibration_eval"],
            batch_size=cfg["batch_size"], mesh=mesh)
    if cfg["marglik_eval"]:
        result.update(evaluate_marglik(model, samples, samples))
    run.finish(result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(parse_cli(DEFAULTS))
