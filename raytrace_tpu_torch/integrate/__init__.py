"""Integration: steppers, event handling, batched solve driver."""

from . import events, steppers
from .events import StopSpec
from .solve import RayCarry, SolverConfig, TraceResult, trace

__all__ = [
    "RayCarry",
    "SolverConfig",
    "StopSpec",
    "TraceResult",
    "events",
    "steppers",
    "trace",
]
