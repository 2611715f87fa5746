"""Scale-out over several processes and cards (port of
raytrace_tpu/parallel/distributed.py).

The physics keeps the ray batch embarrassingly parallel: no collective
exists in the hot loop. The design is the JAX package's, with one process
per card in place of its per-host processes (parallel/mesh.py):

  1. every process runs the SAME host program (SPMD);
  2. the launch grid is built identically everywhere (numpy, cheap) and
     each process takes its contiguous slice;
  3. within a process, the rays ride the single-card machinery -- the
     bucketed rounds tracer on this process's card (the re-bucketing is
     process-local by construction);
  4. the ONLY communication is the terminal statistics reduction: an
     all_gather of one float64 vector of a few hundred bytes per process,
     once per run.

The process group is gloo's: the one collective moves host statistics,
and gloo also serves several ranks that share one card, which NCCL
refuses. Start the processes with torchrun (`python -m
torch.distributed.run --nproc-per-node K -m raytrace_tpu_torch <preset>
--multihost`), or give ensure_initialized the address, world size and
rank yourself.
"""

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import ensemble as ensemble_mod
from . import mesh as mesh_mod


def rank():
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    """The number of processes (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_initialized(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None):
    """Open the gloo process group of a multi-process run (idempotent).

    With no arguments, reads torchrun's WORLD_SIZE, RANK, MASTER_ADDR and
    MASTER_PORT. coordinator_address is "host:port". A no-op when the
    group is already open or when the job is single-process."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes in (None, 1):
        return  # single-process run: nothing to initialize
    if process_id is None:
        if "RANK" not in env:
            raise ValueError("a multi-process run needs this process's rank "
                             "(process_id, or RANK as torchrun sets it)")
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                "a multi-process run needs the coordinator's host:port "
                "(coordinator_address, or MASTER_ADDR and MASTER_PORT)")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )


def process_slice(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Contiguous [start, stop) of the n-ray global batch owned by this
    process. Every process computes the same arithmetic (SPMD): rays are
    dealt in ceil(n / P)-sized blocks, the last block short or empty."""
    p = rank() if process_index is None else process_index
    cnt = world_size() if process_count is None else process_count
    per = -(-n // cnt)
    start = min(p * per, n)
    stop = min(start + per, n)
    return start, stop


def local_launch(u0, f, valid=None, *, process_index=None,
                 process_count=None, multiple=8):
    """This process's slice of a global launch batch, padded to a multiple
    of `multiple` for its one device.

    (u0, f) are the GLOBAL grid (identical on every process -- build it
    with build_launch everywhere; it is host-side numpy). Returns
    (u0_local, f_local, valid_local) where padding lanes replicate the
    slice's first ray and are masked out of statistics, exactly like
    pad_batch."""
    n = u0.shape[0]
    if valid is None:
        valid = np.ones(n, bool)
    start, stop = process_slice(n, process_index, process_count)
    u0_l, f_l, v_l = u0[start:stop], f[start:stop], valid[start:stop]
    if u0_l.shape[0] == 0:
        # empty tail process: trace one masked pad ray so shapes stay valid
        u0_l, f_l = u0[:1], f[:1]
        v_l = np.zeros(1, bool)
    n_pad = mesh_mod.pad_rays(u0_l.shape[0], 1, multiple)
    if n_pad != u0_l.shape[0]:
        extra = n_pad - u0_l.shape[0]
        u0_l = np.concatenate([u0_l, np.repeat(u0_l[:1], extra, axis=0)])
        f_l = np.concatenate([f_l, np.repeat(f_l[:1], extra)])
        v_l = np.concatenate([v_l, np.zeros(extra, bool)])
    return u0_l, f_l, v_l


def _weighted_median(values, weights):
    """Median of `values` under nonnegative `weights` (the smallest value
    at which the cumulative weight reaches half the total). Zero-weight
    entries never influence the result; all-zero weights return 0.0."""
    values = np.asarray(values, np.float64)
    weights = np.asarray(weights, np.float64)
    order = np.argsort(values)
    v, w = values[order], weights[order]
    cum = np.cumsum(w)
    total = cum[-1] if cum.size else 0.0
    if total <= 0.0:
        return 0.0
    return float(v[np.searchsorted(cum, 0.5 * total)])


def combine_stat_rows(rows) -> dict:
    """Pure combination of per-process ensemble_stats rows into global
    statistics (one dict per process, identical key sets).

    - plain keys (counts, totals) SUM across processes;
    - `mean_*` keys recombine weighted by each process's surface-hit
      count (exact: the per-process means are hit-count-weighted sums);
    - `median_*` keys are NOT sum-combinable -- the global value is the
      hit-weighted median of the per-process medians. That is exact at
      one process and a median-of-medians estimator otherwise (the exact
      global median would need the raw per-ray values, which stay
      process-local by design)."""
    out = {}
    hits = np.asarray(
        [r.get("n_hit_earth", 0.0) for r in rows], np.float64
    )
    total_hits = max(float(hits.sum()), 1.0)
    for k in rows[0]:
        vals = np.asarray([r[k] for r in rows], np.float64)
        if k.startswith("mean_"):
            out[k] = float(np.sum(vals * hits) / total_hits)
        elif k.startswith("median_"):
            out[k] = _weighted_median(vals, hits)
        else:
            out[k] = float(vals.sum())
    return out


def aggregate_stats(stats: dict) -> dict:
    """Combine per-process ensemble_stats dicts into global statistics:
    an all_gather of every process's row as one float64 CPU vector in
    sorted key order when there is more than one process (a
    single-process run skips the collective), then the pure
    `combine_stat_rows`."""
    local = {k: float(v) for k, v in stats.items()}
    if world_size() > 1:
        keys = sorted(local)
        vec = torch.tensor([local[k] for k in keys], dtype=torch.float64)
        allv = [torch.empty_like(vec) for _ in range(world_size())]
        dist.all_gather(allv, vec)
        rows = [dict(zip(keys, row.tolist())) for row in allv]
    else:
        rows = [local]
    return combine_stat_rows(rows)


def trace_ensemble_multihost(env, u0, f, valid=None, *, tracer_kw=None,
                             device=None):
    """End-to-end multi-process ensemble: slice, trace locally, aggregate.

    (u0, f, valid) are the GLOBAL batch (numpy), identical on every
    process. This process's slice runs through make_rounds_tracer(env,
    **tracer_kw) on `device` (mesh.local_device's choice: this rank's
    card unless the caller names a device), in tracer_kw's dtype, else
    u0's. Returns (local TraceResult, local valid mask, global stats
    dict). The statistics are reduced in float64 whatever the run's
    dtype, so a mean recombined across processes equals the one-process
    mean to rounding (a float32 sum over ten thousand rays carries ~1e-7);
    in a float64 run they are the JAX package's arithmetic."""
    tracer_kw = dict(tracer_kw or {})
    u0 = np.asarray(u0)
    tracer_kw.setdefault("dtype", torch.from_numpy(u0[:1]).dtype)
    device = mesh_mod.local_device(device)
    u0_l, f_l, v_l = local_launch(u0, np.asarray(f), valid)
    tracer = ensemble_mod.make_rounds_tracer(env, device=device, **tracer_kw)
    res = tracer(u0_l, f_l, v_l)
    frame = tracer_kw.get("frame", "2d_lat")
    lat_sign, lat_offset = (
        (1.0, 0.0) if frame == "2d_lat" else (-1.0, np.pi / 2)
    )
    stats = ensemble_mod.ensemble_stats(
        res._replace(u=np.asarray(res.u, np.float64)), v_l,
        lat_sign=lat_sign, lat_offset=lat_offset,
    )
    return res, v_l, aggregate_stats(stats)
