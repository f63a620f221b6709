"""Task files: experiment grids declared on a shared task queue
(`exp.taskqueue`), counterparts of the JAX package's `experiments/tasks/`.
Each runs as `python -m bnn_priors_tpu_torch.experiments.tasks.<name>`."""
