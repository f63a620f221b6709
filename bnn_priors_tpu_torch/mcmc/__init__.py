"SG-MCMC kernels over a packed chain state (flat, segmented or hybrid)."
from .hmc import HMC
from .packing import PACK_ALIGN, Packer
from .segmented import HybridPacker, SegPacker, SegVec
from .sgld import SGLD, SGLDState
from .verlet_sgld import VerletSGLD, VerletSGLDState
from .chains import (HMCChains, SGLDChains, SGLDChainState, VerletSGLDChains,
                     VerletSGLDChainState)

__all__ = ("PACK_ALIGN", "Packer", "SegPacker", "HybridPacker", "SegVec",
           "SGLD", "SGLDState", "VerletSGLD",
           "VerletSGLDState", "VerletSGLDChains", "VerletSGLDChainState",
           "HMC", "SGLDChains", "SGLDChainState", "HMCChains")
