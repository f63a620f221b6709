"""Experiment glue: sacred-style config, run directories and the task
queue."""
from .config import RunDirectory, cfg_get, cfg_set, coerce, parse_cli
from .taskqueue import BarrierNotReady, Task, TaskQueue, run_script_task

__all__ = ("BarrierNotReady", "RunDirectory", "Task", "TaskQueue", "cfg_get",
           "cfg_set", "coerce", "parse_cli", "run_script_task")
