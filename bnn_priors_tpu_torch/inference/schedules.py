"""Learning-rate schedules (counterpart of
`bnn_priors_tpu/inference/schedules.py`): plain Python float functions of
the global step index, evaluated on the host."""
from __future__ import annotations

import math


def get_cosine_schedule(steps_per_cycle: int):
    "cosine from 1 → 0 over each cycle, restarting every `steps_per_cycle`"

    def schedule(i):
        progress = (i % steps_per_cycle) / steps_per_cycle
        return 0.5 * (math.cos(math.pi * progress) + 1.0)
    return schedule


def get_stairs_schedule(steps_per_stair: int, gamma: float = 0.1):
    "StepLR: multiply by gamma every `steps_per_stair` steps"

    def schedule(i):
        return gamma ** (i // steps_per_stair)
    return schedule


def get_flat_schedule():
    def schedule(i):
        return 1.0
    return schedule


def make_schedule(sampling_decay, steps_per_cycle: int, steps_per_stair=None):
    """Resolve the reference's `sampling_decay` flag (inference.py:96-108):
    True/'cosine' → cosine cycles; False/'stairs' → StepLR(150 epochs);
    'flat' → constant."""
    if sampling_decay is True or sampling_decay == "cosine":
        return get_cosine_schedule(steps_per_cycle)
    if sampling_decay is False or sampling_decay == "stairs":
        return get_stairs_schedule(steps_per_stair or steps_per_cycle)
    if sampling_decay == "flat":
        return get_flat_schedule()
    raise ValueError(f"sampling_decay={sampling_decay!r}")
