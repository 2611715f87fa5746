"""Parallelism: launch grids and the bucketed rounds tracer (one device)."""

from . import ensemble
from .ensemble import (
    LaunchSpec, build_launch, ensemble_stats, make_rounds_tracer, pad_batch,
)

__all__ = [
    "LaunchSpec",
    "build_launch",
    "ensemble",
    "ensemble_stats",
    "make_rounds_tracer",
    "pad_batch",
]
