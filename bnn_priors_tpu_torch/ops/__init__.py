"Hand-written Hopper kernels of the port, each beside its plain version."
from .fused_update import fused_langevin_update, fused_langevin_update_reference

__all__ = ("fused_langevin_update", "fused_langevin_update_reference")
