"""Experiment glue: sacred-style config and run directories."""
from .config import RunDirectory, cfg_get, cfg_set, coerce, parse_cli

__all__ = ("RunDirectory", "cfg_get", "cfg_set", "coerce", "parse_cli")
