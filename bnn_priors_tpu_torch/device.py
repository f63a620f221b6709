"""Device resolution for the port's entry points: they run on the card
unless the caller asks for the CPU, and never fall back to it quietly.

`local_devices` lists the devices a process offers a mesh: every visible
CUDA device, or as many positions on the one CPU as the environment
variable `BNN_PRIORS_CPU_DEVICES` says (1 when unset; the counterpart of
JAX's `jax_num_cpu_devices`), which is how the tests run a mesh of several
positions on the CPU."""
from __future__ import annotations

import os
from typing import List

import torch

CPU_DEVICES_ENV = "BNN_PRIORS_CPU_DEVICES"


def resolve_device(device="cuda") -> torch.device:
    "torch.device for `device`; raises if a CUDA device is asked for and absent"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def local_devices(device="cuda") -> List[torch.device]:
    """this process's devices of `device`'s kind, in order: `cuda` is every
    visible card (`cuda:i` that one alone), `cpu` is
    `$BNN_PRIORS_CPU_DEVICES` positions on the CPU"""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * int(os.environ.get(CPU_DEVICES_ENV, 1))
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
