"SG-MCMC kernels over a flat-packed chain state."
from .hmc import HMC
from .packing import PACK_ALIGN, Packer
from .sgld import SGLD, SGLDState
from .verlet_sgld import (VerletSGLD, VerletSGLDChains, VerletSGLDChainState,
                          VerletSGLDState)

__all__ = ("PACK_ALIGN", "Packer", "SGLD", "SGLDState", "VerletSGLD",
           "VerletSGLDState", "VerletSGLDChains", "VerletSGLDChainState",
           "HMC")
