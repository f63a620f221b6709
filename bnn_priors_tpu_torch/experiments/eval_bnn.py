"""Evaluation script (counterpart of `experiments/eval_bnn.py`): re-load a
training run's samples and evaluate the posterior predictive.

    python -m bnn_priors_tpu_torch.experiments.eval_bnn with \\
        run_dir=logs/1 calibration_eval=True skip_first=0

It evaluates run directories written by either package's `train_bnn`,
classification runs (with `eval_data`, e.g. `rotated_mnist` or
`fashion_mnist` for an MNIST run) and regression runs (`UCI_<name>`: the
ensemble's log-likelihood and squared errors).
Post-hoc rejected-sample resolution (`reject_samples_`) runs before
ensembling, like the reference (eval_bnn.py:104-110). `ood_eval`,
`marglik_eval` and `n_devices>1` are not ported yet (ROADMAP item 14) and
raise NotImplementedError.
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
    n_devices=None,
    log_dir=str(REPO / "logs_eval"),
)


def main(cfg):
    for key in ("ood_eval", "marglik_eval"):
        if cfg[key]:
            raise NotImplementedError(f"{key}=True is not ported yet "
                                      "(ROADMAP item 14)")
    if cfg["n_devices"] is not None and int(cfg["n_devices"]) > 1:
        raise NotImplementedError(f"n_devices={cfg['n_devices']} is not "
                                  "ported yet (ROADMAP item 14)")
    check_device(cfg["device"])
    set_float32(cfg["device"])

    from .. import exp_utils
    from ..evaluate import evaluate_model, reject_samples_
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

    result = evaluate_model(
        model, (x_test, y_test), samples, likelihood_eval=True,
        accuracy_eval=True, calibration_eval=cfg["calibration_eval"],
        batch_size=cfg["batch_size"])
    run.finish(result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(parse_cli(DEFAULTS))
