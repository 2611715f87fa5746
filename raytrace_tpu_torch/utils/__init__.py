"""Utilities: profiling, run records, debug gates."""

from . import debug, profiling, runrecord
from .profiling import ray_steps_per_sec
from .runrecord import write_run_record

__all__ = ["debug", "profiling", "ray_steps_per_sec", "runrecord",
           "write_run_record"]
