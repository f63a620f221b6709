"""The paper's command lines: `python -m
bnn_priors_tpu_torch.experiments.train_bnn with ...` and `eval_bnn`."""
