"Weight priors as nn.Modules (gaussian only so far)."
from .base import Prior, join
from .loc_scale import LocScale, Normal
from .mixture import get_prior

__all__ = ("Prior", "join", "LocScale", "Normal", "get_prior")
