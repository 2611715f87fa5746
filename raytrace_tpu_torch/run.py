"""High-level runner: RunConfig in, traced ensemble out (port of
raytrace_tpu/run.py, the rounds path).

Builds the medium and the launch grid (in the 3D frame optionally put on
the dispersion surface), traces the batch on one device with the bucketed
rounds tracer (each round one step-kernel launch per pool) in the
configured gradient set, with continue_until_done resumes the rays that
ran out of steps, and reduces the ensemble statistics on the host.
"""

import json
import os

import numpy as np
import torch

from .config import RunConfig
from .integrate import events
from .integrate.solve import RayCarry, trace
from .ops.dispersion import consistent_rho_3d
from .parallel.ensemble import (
    _bucket_size, build_launch, build_launch_3d, ensemble_stats,
    make_rounds_tracer, pad_batch,
)


def _check_supported(config: RunConfig):
    unported = {
        "use_rounds=False (the single-program tracer)": not config.use_rounds,
        "save_every > 0 (ROADMAP A11)": config.save_every > 0,
        "sensitivity_rays > 0 (ROADMAP A13)": config.sensitivity_rays > 0,
        "explicit ray lists (ROADMAP A11)": bool(config.rays),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    if config.frame != "3d" and tuple(config.phis) != (0.0,):
        raise ValueError("phis launch fan is 3D-only (the 2D state "
                         "carries no longitude)")


def _build_u0(config: RunConfig, env, np_dtype, device):
    """Launch states (u0, f) of the configured frame, numpy in np_dtype.

    The launch grid gives latitudes in every frame: the colatitude frame's
    state slot 1 is theta = pi/2 - lat, formed in np_dtype as the JAX
    package forms it. In the 3D frame with rho_on_shell, rho0 is a direction and |rho| is
    solved as mu(psi) for every ray in one batched float64 call on
    `device`, from theta and f already rounded to the run dtype, then cast
    to it (what the JAX package computes)."""
    if config.frame in ("2d_lat", "2d_colat"):
        u0, f = build_launch(config.launch(), np_dtype)
        if config.frame == "2d_colat":
            u0[:, 1] = np.pi / 2 - u0[:, 1]
        return u0, f
    u0, f = build_launch_3d(config.r0, config.lats, config.phis,
                            config.chis, config.freqs, config.rho0, np_dtype)
    if config.rho_on_shell:
        as64 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float64), device=device)
        theta = as64(u0[:, 1])
        rho = consistent_rho_3d(
            torch.full_like(theta, config.r0), theta, as64(u0[:, 2]),
            tuple(as64(u0[:, k]) for k in (3, 4, 5)), as64(f), env,
            config.root,
        )
        u0[:, 3:6] = torch.stack(rho, dim=1).cpu().numpy().astype(np_dtype)
    return u0, f


def run(config: RunConfig, *, device="cuda", out_dir=None):
    """Execute a RunConfig on `device` (the card unless the caller asks
    for "cpu") in config.dtype. Returns dict(result, stats, valid, paths,
    rounds, stiff): the TraceResult (host numpy arrays), the ensemble
    statistics, the valid-ray mask, written file paths, the per-round
    diagnostics and the per-ray stiff-pool flags."""
    _check_supported(config)
    env = config.medium.build()
    np_dtype = np.float32 if config.dtype == "float32" else np.float64
    dtype = torch.float32 if config.dtype == "float32" else torch.float64
    u0, f = _build_u0(config, env, np_dtype, torch.device(device))
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
    if config.continue_until_done:
        # the full carry back, to resume from it
        kw["want_carry"] = True
    tracer = make_rounds_tracer(env, device=device, dtype=dtype, **kw)
    result = tracer(u0, f, valid)
    if config.continue_until_done:
        result = _continue(config, env, result, u0, f, valid, cfg, spec,
                           torch.device(device), dtype)
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


def _continue(config: RunConfig, env, result, u0, f, valid, cfg, spec,
              device, dtype):
    """continue_until_done (the JAX package's run.py:195-261): up to
    max_continuations more full budgets for the rays that ended at
    MAX_STEPS. The stragglers are gathered into a bucket of
    _bucket_size(n, B, 256) rays (the rounds tracer's re-bucketing: the
    wall scales with the stragglers, not the batch), the padding lanes
    copy the first straggler with status HIT_EARTH (a terminal status is
    not re-armed, so they retire at once), `trace(carry0=...)` re-arms the
    MAX_STEPS rays, and the rows are scattered back. Under stepper="auto"
    a continuation runs dopri5, as the JAX package's single-program path
    does."""
    stepper = "dopri5" if config.stepper == "auto" else config.stepper
    valid = np.asarray(valid)
    for _ in range(config.max_continuations):
        status = np.asarray(result.status)
        idx = np.nonzero((status == events.MAX_STEPS) & valid)[0]
        if len(idx) == 0:
            break
        b = _bucket_size(len(idx), len(status), 256)
        sel = np.concatenate([idx, np.repeat(idx[:1], b - len(idx))])
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(np.asarray(a)[sel])).to(device)
        carry = RayCarry(**{
            k: as_t(v).to(dtype) if np.asarray(v).dtype.kind == "f"
            else as_t(v) for k, v in result.carry._asdict().items()})
        pad = torch.zeros(b, dtype=torch.bool, device=device)
        pad[len(idx):] = True
        carry = carry._replace(status=torch.where(
            pad, events.HIT_EARTH, carry.status).to(torch.int32))
        sub = trace(env, as_t(u0).to(dtype), as_t(f).to(dtype),
                    frame=config.frame, cfg=cfg, spec=spec,
                    adaptive=config.adaptive, stepper=stepper,
                    max_steps=config.max_steps, carry0=carry,
                    root=config.root, grad_mode=config.grad_mode)

        def scatter(full, part, idx=idx):
            out = np.asarray(full).copy()
            out[idx] = part.cpu().numpy()[: len(idx)]
            return out

        result = result._replace(
            u=scatter(result.u, sub.u), t=scatter(result.t, sub.t),
            status=scatter(result.status, sub.status),
            n_accept=scatter(result.n_accept, sub.n_accept),
            n_reject=scatter(result.n_reject, sub.n_reject),
            carry=RayCarry(*(scatter(a, b) for a, b in
                             zip(result.carry, sub.carry))),
        )
    return result


def summarize(result, valid):
    """Human-readable status summary line."""
    status = np.asarray(result.status)[np.asarray(valid)]
    parts = []
    for code, name in enumerate(events.STATUS_NAMES):
        n = int((status == code).sum())
        if n:
            parts.append(f"{name}={n}")
    return " ".join(parts)
