"""Parallelism: launch grids, the single-program and the bucketed rounds
tracers (one device), carry checkpoints, and the scale-out over several
processes and cards (one process a card)."""

from . import checkpoint, distributed, ensemble, mesh
from .ensemble import (
    LaunchSpec, build_launch, build_launch_3d, build_launch_list,
    ensemble_stats, make_ensemble_tracer, make_rounds_tracer, pad_batch,
)
from .mesh import local_device, pad_rays

__all__ = [
    "LaunchSpec",
    "build_launch",
    "build_launch_3d",
    "build_launch_list",
    "checkpoint",
    "distributed",
    "ensemble",
    "ensemble_stats",
    "local_device",
    "make_ensemble_tracer",
    "make_rounds_tracer",
    "mesh",
    "pad_batch",
    "pad_rays",
]
