"""High-level runner: RunConfig in, traced ensemble out (port of
raytrace_tpu/run.py, the rounds path).

Builds the medium and the launch grid, traces the batch on one device
with the bucketed rounds tracer (each round one step-kernel launch per
pool), and reduces the ensemble statistics on the host.
"""

import json
import os

import numpy as np
import torch

from .config import RunConfig
from .integrate import events
from .parallel.ensemble import (
    build_launch, ensemble_stats, make_rounds_tracer, pad_batch,
)


def _check_supported(config: RunConfig):
    unported = {
        f"frame={config.frame!r} (ROADMAP A7/A10)": config.frame != "2d_lat",
        "use_rounds=False (the single-program tracer)": not config.use_rounds,
        "save_every > 0 (ROADMAP A11)": config.save_every > 0,
        "continue_until_done (ROADMAP A10)": config.continue_until_done,
        "sensitivity_rays > 0 (ROADMAP A13)": config.sensitivity_rays > 0,
        "explicit ray lists (ROADMAP A11)": bool(config.rays),
        "a phis fan (3D only)": tuple(config.phis) != (0.0,),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


def run(config: RunConfig, *, device, out_dir=None):
    """Execute a RunConfig on `device` ("cuda", "cpu", ...) in
    config.dtype. Returns dict(result, stats, valid, paths, rounds,
    stiff): the TraceResult (host numpy arrays), the ensemble statistics,
    the valid-ray mask, written file paths, the per-round diagnostics and
    the per-ray stiff-pool flags."""
    _check_supported(config)
    env = config.medium.build()
    np_dtype = np.float32 if config.dtype == "float32" else np.float64
    dtype = torch.float32 if config.dtype == "float32" else torch.float64
    u0, f = build_launch(config.launch(), np_dtype)
    u0, f, valid = pad_batch(u0, f)

    cfg = config.solver()
    spec = config.stop()
    kw = dict(
        frame=config.frame, cfg=cfg, spec=spec, adaptive=config.adaptive,
        stepper=config.stepper, max_steps=config.max_steps,
        grad_mode=config.grad_mode, root=config.root, want_carry=False,
        base_stepper=config.base_stepper,
    )
    if config.round_steps:
        kw["round_steps"] = tuple(config.round_steps)
    # tiny batches cannot re-bucket profitably: one full-budget round
    if int(valid.sum()) <= 64:
        kw["round_steps"] = (config.max_steps,)
    tracer = make_rounds_tracer(env, device=device, dtype=dtype, **kw)
    result = tracer(u0, f, valid)
    stats = {
        k: np.asarray(v)
        for k, v in ensemble_stats(
            result, valid, lat_sign=spec.lat_sign, lat_offset=spec.lat_offset
        ).items()
    }

    paths = {}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fs_path = os.path.join(out_dir, f"{config.name}_final.npz")
        np.savez(
            fs_path, u=result.u, t=result.t, status=result.status,
            n_accept=result.n_accept, n_reject=result.n_reject, valid=valid,
            f=f,
        )
        paths["final"] = fs_path
        rec_path = os.path.join(out_dir, f"{config.name}_record.json")
        with open(rec_path, "w") as fh:
            json.dump({
                "config": json.loads(config.to_json()),
                "device": str(device),
                "stats": {k: v.item() for k, v in stats.items()},
            }, fh, indent=2)
        paths["record"] = rec_path
    return {"result": result, "stats": stats, "valid": valid,
            "paths": paths, "rounds": tracer.last_rounds,
            "stiff": tracer.last_stiff}


def summarize(result, valid):
    """Human-readable status summary line."""
    status = np.asarray(result.status)[np.asarray(valid)]
    parts = []
    for code, name in enumerate(events.STATUS_NAMES):
        n = int((status == code).sum())
        if n:
            parts.append(f"{name}={n}")
    return " ".join(parts)
