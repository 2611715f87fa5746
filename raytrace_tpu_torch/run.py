"""High-level runner: RunConfig in, traced ensemble and artifacts out
(port of raytrace_tpu/run.py).

Builds the medium and the launch grid (an explicit 2D ray list, or in the
3D frame optionally put on the dispersion surface), traces the batch on
one device in the configured gradient set -- with the bucketed rounds
tracer (each round one step-kernel launch per pool; continue_until_done
then resumes the rays that ran out of steps), or with use_rounds=False in
one `trace` call -- optionally recording the trajectory channel
(save_every > 0, with the diagnostics when save_diagnostics), reduces the
ensemble statistics on the host, optionally takes the landing
sensitivity of the first valid rays (sensitivity_rays > 0), and writes
the final states, the trajectory and the run record.
"""

import os

import numpy as np
import torch

from .config import RunConfig
from .integrate import events
from .integrate.saving import save_fn_for
from .integrate.solve import RayCarry, trace
from .ops.dispersion import consistent_rho_3d
from .ops.rhs import frame_rhs
from .parallel.ensemble import (
    _bucket_size, build_launch, build_launch_3d, build_launch_list,
    ensemble_stats, make_ensemble_tracer, make_rounds_tracer, pad_batch,
)
from .utils.runrecord import write_run_record


def _check_supported(config: RunConfig):
    if config.frame != "3d" and tuple(config.phis) != (0.0,):
        raise ValueError("phis launch fan is 3D-only (the 2D state "
                         "carries no longitude)")


def _build_u0(config: RunConfig, env, np_dtype, device):
    """Launch states (u0, f) of the configured frame, numpy in np_dtype.

    An explicit ray list (config.rays, 2D only) or the launch grid gives
    latitudes in every frame: the colatitude frame's state slot 1 is
    theta = pi/2 - lat, formed in np_dtype as the JAX package forms it. In
    the 3D frame with rho_on_shell, rho0 is a direction and |rho| is
    solved as mu(psi) for every ray in one batched float64 call on
    `device`, from theta and f already rounded to the run dtype, then cast
    to it (what the JAX package computes)."""
    if config.frame in ("2d_lat", "2d_colat"):
        if config.rays:
            u0, f = build_launch_list(config.rays, r0=config.r0,
                                      dtype=np_dtype)
        else:
            u0, f = build_launch(config.launch(), np_dtype)
        if config.frame == "2d_colat":
            u0[:, 1] = np.pi / 2 - u0[:, 1]
        return u0, f
    if config.rays:
        raise ValueError("explicit ray lists are 2D-only (the 3D state "
                         "needs rho0, which the grid builder supplies)")
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


def run(config: RunConfig, *, device="cuda", out_dir=None, plots=False):
    """Execute a RunConfig on `device` (the card unless the caller asks
    for "cpu") in config.dtype. Returns dict(result, stats, valid, paths,
    rounds, stiff): the TraceResult (host numpy arrays; `traj` the
    trajectory channel's dict when save_every > 0), the ensemble
    statistics, the valid-ray mask, written file paths (`final`, `traj`,
    `record`, and with plots and a trajectory `rays_png`), the per-round
    diagnostics and the per-ray stiff-pool flags (both None on the
    single-program path). With sensitivity_rays = N > 0 the stats (and
    the record) gain sensitivity_amplification and sensitivity_status of
    the first N valid rays (sensitivity.py). plots (with out_dir and
    save_every > 0) renders the ray paths to <name>_rays.png; it needs
    matplotlib, and without it raises ImportError before tracing."""
    _check_supported(config)
    if plots:
        from .viz.plots import _pyplot

        _pyplot()
    env = config.medium.build()
    np_dtype = np.float32 if config.dtype == "float32" else np.float64
    dtype = torch.float32 if config.dtype == "float32" else torch.float64
    device = torch.device(device)
    u0, f = _build_u0(config, env, np_dtype, device)
    u0, f, valid = pad_batch(u0, f)

    cfg = config.solver()
    spec = config.stop()
    # "auto" is a rounds-tracer policy (per-ray switching to the stiff
    # pool); the single-program path runs every ray on one method
    fixed_stepper = "dopri5" if config.stepper == "auto" else config.stepper
    common = dict(
        frame=config.frame, cfg=cfg, spec=spec, adaptive=config.adaptive,
        max_steps=config.max_steps, grad_mode=config.grad_mode,
        root=config.root, device=device, dtype=dtype,
    )
    save_fn = (save_fn_for(config.frame, env)
               if config.save_every > 0 and config.save_diagnostics
               else None)
    tracer = None
    if config.use_rounds:
        kw = dict(common, stepper=config.stepper, want_carry=False,
                  base_stepper=config.base_stepper,
                  save_every=config.save_every, save_fn=save_fn)
        if config.round_steps:
            kw["round_steps"] = tuple(config.round_steps)
        # tiny batches cannot re-bucket profitably: one full-budget round
        if int(valid.sum()) <= 64:
            kw["round_steps"] = (config.max_steps,)
        # continuations resume the final-state run only, as in the JAX
        # package
        cont = config.continue_until_done and config.save_every == 0
        if cont:
            # the full carry back, to resume from it
            kw["want_carry"] = True
        tracer = make_rounds_tracer(env, **kw)
        result = tracer(u0, f, valid)
        if cont:
            result = _continue(config, env, result, u0, f, valid, cfg, spec,
                               device, dtype)
    else:
        res = make_ensemble_tracer(
            env, stepper=fixed_stepper, save_every=config.save_every,
            save_fn=save_fn, **common,
        )(u0, f)
        result = res._replace(
            **{k: getattr(res, k).cpu().numpy()
               for k in ("u", "t", "status", "n_accept", "n_reject")},
            traj=(None if res.traj is None else
                  {k: v.cpu().numpy() for k, v in res.traj.items()}),
            carry=None,
        )
    stats = {
        k: np.asarray(v)
        for k, v in ensemble_stats(
            result, valid, lat_sign=spec.lat_sign, lat_offset=spec.lat_offset
        ).items()
    }
    if config.sensitivity_rays > 0:
        # the landing-sensitivity channel (the JAX package's run.py:
        # 279-293): the event-projected variational Jacobian of the first
        # N valid rays in the run's dtype, on the run's device
        from .sensitivity import landing_sensitivity_batch

        rhs_fn, group_idx = frame_rhs(config.frame, env, config.root,
                                      config.grad_mode)
        idx = np.nonzero(np.asarray(valid))[0][: config.sensitivity_rays]
        sens = landing_sensitivity_batch(
            rhs_fn, u0[idx], f[idx], cfg=cfg, spec=spec,
            group_idx=group_idx, max_steps=config.max_steps, device=device,
            dtype=dtype)
        stats["sensitivity_amplification"] = sens["amplification"]
        stats["sensitivity_status"] = sens["status"]

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
        if result.traj is not None:
            tr_path = os.path.join(out_dir, f"{config.name}_traj.npz")
            np.savez(tr_path, **result.traj)
            paths["traj"] = tr_path
        rec_path = os.path.join(out_dir, f"{config.name}_record.json")
        write_run_record(
            rec_path, env=env, cfg=cfg, spec=spec, launch=config.launch(),
            result=result, stats=stats,
            extra={"config": config.to_json(), "dtype": config.dtype},
            device=device,
        )
        paths["record"] = rec_path
        if plots and result.traj is not None:
            from .viz import plot_ray_paths

            p = os.path.join(out_dir, f"{config.name}_rays.png")
            plot_ray_paths(result.traj["u"], frame=config.frame, path=p)
            paths["rays_png"] = p
    return {"result": result, "stats": stats, "valid": valid,
            "paths": paths,
            "rounds": tracer.last_rounds if tracer else None,
            "stiff": tracer.last_stiff if tracer else None}


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
