"""SGD baseline (counterpart of `experiments/train_sgd.py`, the paper's SGD
ensembles): the same model zoo, flags and run files.

    python -m bnn_priors_tpu_torch.experiments.train_sgd \\
        --model thin_resnet18 --data cifar10_augmented --log_dir logs/sgd

SGD with momentum is SGLD at temperature 0: an `SGLDRunner` with improper
priors (pure maximum likelihood) from a He-uniform init, one cycle of
`n_epochs` with the `sampling_decay` schedule ("stairs": the learning rate
divided by 10 every 150 epochs), and a sample saved every
`epochs_per_sample` epochs. The samples after the first `skip_first` form
the "SGD ensemble" that `evaluate_model` scores at the end. On the card
every step is one launch of the `(T,)` CUDA kernel at noise_std 0.

Run files, written into `log_dir` itself: config.json (the flags and
`temperature: 0.0`), run.json (RUNNING, then FAILED on an error or
COMPLETED with the result), metrics.h5 and samples.pt. The flags and
defaults are the JAX CLI's, but `--device`, which is `cuda` (or `cpu`).
"""
import argparse
import json
from pathlib import Path


def optional_int(s):
    return None if s in ("None", "") else int(s)


def parser():
    p = argparse.ArgumentParser(description="SGD baseline training")
    p.add_argument("--lr", default=0.05, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--model", default="thin_resnet18", type=str)
    p.add_argument("--data", default="cifar10_augmented", type=str)
    p.add_argument("--width", default=64, type=int)
    p.add_argument("--batch_size", default=128, type=optional_int)
    p.add_argument("--sampling_decay", default="stairs", type=str)
    p.add_argument("--n_epochs", default=150 * 3, type=int)
    p.add_argument("--epochs_per_sample", default=50, type=int)
    p.add_argument("--skip_first", default=3, type=int)
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--log_dir", default=".", type=str)
    p.add_argument("--seed", default=0, type=int)
    return p


def _write_status(log_dir, status):
    with open(log_dir / "run.json", "w") as f:
        json.dump(status, f)


def main(argv=None):
    "parse `argv` (default: the command line), train, evaluate; the result"
    args = parser().parse_args(argv)
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with open(log_dir / "config.json", "w") as f:
        json.dump({**vars(args), "temperature": 0.0}, f)
    _write_status(log_dir, {"status": "RUNNING"})
    try:
        result = _train(args, log_dir)
    except BaseException:
        _write_status(log_dir, {"status": "FAILED"})
        raise
    _write_status(log_dir, {"status": "COMPLETED", "result": result})
    print(json.dumps(result))
    return result


def _train(args, log_dir):
    import torch

    from .. import exp_utils
    from ..evaluate import evaluate_model
    from ..inference import SGLDRunner
    from ..io import HDF5Metrics, HDF5ModelSaver
    from .train_bnn import check_device, set_float32

    check_device(args.device)
    set_float32(args.device)
    data = exp_utils.get_data(args.data, device=args.device)
    x_train, y_train = data.norm.train
    x_test, y_test = data.norm.test

    # one host generator for the run's seeds (explicit, never global)
    gen = torch.Generator().manual_seed(args.seed)
    init_seed, he_seed, run_seed = (
        int(torch.randint(0, 2 ** 62, (), generator=gen)) for _ in range(3))
    # improper priors: pure maximum likelihood, from a He-uniform init
    model = exp_utils.get_model(
        args.model, weight_prior="improper", weight_loc=0.0,
        weight_scale=1.0, bias_prior="improper", bias_loc=0.0,
        bias_scale=1.0, batchnorm=True, x_train=x_train, y_train=y_train,
        width=args.width, depth=3, device=args.device, seed=init_seed)
    exp_utils.he_uniform_initialize(model,
                                    torch.Generator().manual_seed(he_seed))

    with HDF5Metrics(log_dir / "metrics.h5") as metrics_saver, \
            HDF5ModelSaver(log_dir / "samples.pt") as model_saver:
        runner = SGLDRunner(
            model, (x_train, y_train), (x_test, y_test),
            epochs_per_cycle=args.n_epochs, warmup_epochs=0,
            sample_epochs=args.n_epochs, skip=args.epochs_per_sample,
            learning_rate=args.lr, temperature=0.0, momentum=args.momentum,
            sampling_decay=args.sampling_decay, cycles=1,
            precond_update=None, metrics_saver=metrics_saver,
            model_saver=model_saver,
            batch_size=args.batch_size or len(x_train),
            augment_fn=getattr(type(data), "augment_fn", None),
            seed=run_seed, device=args.device)
        runner.run(progressbar=True)
        samples = runner.get_samples()

    samples = {k: v[args.skip_first:] for k, v in samples.items()}
    return evaluate_model(model, (x_test, y_test), samples)


if __name__ == "__main__":
    main()
