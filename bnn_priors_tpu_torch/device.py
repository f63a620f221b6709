"""Device resolution for the port's entry points: they run on the card
unless the caller asks for the CPU, and never fall back to it quietly."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    "torch.device for `device`; raises if a CUDA device is asked for and absent"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
