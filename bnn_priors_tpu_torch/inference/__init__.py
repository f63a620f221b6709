"Runners: the exact-gradient GGMC reject runner and the pieces it builds on."
from .reject import VerletSGLDRunnerReject, exact_potential_and_grad
from .runner import SGLDRunner, VerletSGLDRunner
from .schedules import make_schedule

__all__ = ("SGLDRunner", "VerletSGLDRunner", "VerletSGLDRunnerReject",
           "exact_potential_and_grad", "make_schedule")
