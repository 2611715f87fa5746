"""Parallelism: launch grids, the single-program and the bucketed rounds
tracers (one device), and carry checkpoints."""

from . import checkpoint, ensemble
from .ensemble import (
    LaunchSpec, build_launch, build_launch_3d, build_launch_list,
    ensemble_stats, make_ensemble_tracer, make_rounds_tracer, pad_batch,
)

__all__ = [
    "LaunchSpec",
    "build_launch",
    "build_launch_3d",
    "build_launch_list",
    "checkpoint",
    "ensemble",
    "ensemble_stats",
    "make_ensemble_tracer",
    "make_rounds_tracer",
    "pad_batch",
]
