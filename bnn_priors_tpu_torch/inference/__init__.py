"Runners: plain and exact-gradient (reject) SG-MCMC over one chain."
from .reject import (HMCRunnerReject, SGLDRunnerReject,
                     VerletSGLDRunnerReject, exact_potential_and_grad)
from .runner import HMCRunner, SGLDRunner, VerletSGLDRunner
from .schedules import make_schedule

__all__ = ("SGLDRunner", "SGLDRunnerReject", "VerletSGLDRunner",
           "VerletSGLDRunnerReject", "HMCRunner", "HMCRunnerReject",
           "exact_potential_and_grad", "make_schedule")
