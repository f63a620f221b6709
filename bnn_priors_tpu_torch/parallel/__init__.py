"""The chain axis: K independent chains stepping together as one bank on a
card, split over the devices and processes of a mesh."""
from . import distributed
from .chains import (ChainMesh, init_chains_diverse, init_chains_from_fn,
                     make_mesh)
from .multichain import MultiChainRunner, MultiChainRunnerReject

__all__ = ("distributed", "ChainMesh", "init_chains_diverse",
           "init_chains_from_fn", "make_mesh", "MultiChainRunner",
           "MultiChainRunnerReject")
