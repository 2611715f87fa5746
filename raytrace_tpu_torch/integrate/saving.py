"""Per-step diagnostics and trajectory tools (port of
raytrace_tpu/integrate/saving.py).

The reference records [mu, dmu/dpsi, dip, psi] at every accepted step via
a SavingCallback (RayTrace_lat.jl:318-327). Here the same quantities are
computed by a `save_fn(u, f)` passed to integrate.trace(..., save_every=k,
save_fn=...): batched torch ops over a snapshot, u (..., n) and f (...),
returning (..., 4) on the tensors' device. The JAX package computes them
in XLA outside its Pallas kernel; they are not a kernel here either.
"""

import math

import numpy as np
import torch

from ..models import dipole, medium
from ..ops import analytic, dispersion
from . import events


def make_save_fn_2d_lat(env: medium.EnvParams):
    """save_fn returning (mu, dmudpsi, dip, psi) like the reference's
    save_func (RayTrace_lat.jl:318-324); dmudpsi is the reference's closed
    form, matching what its SavedValues contain."""

    def save_fn(u, f):
        r, lat, chi = u[..., 0], u[..., 1], u[..., 2]
        mu, dmudpsi = analytic.mu_dmudpsi_2d_lat(r, lat, chi, f, env)
        dip = dipole.dip_angle_lat(lat)
        psi = dispersion.psi_lat(lat, chi)
        return torch.stack([mu, dmudpsi, dip, psi], dim=-1)

    return save_fn


def make_save_fn_2d_colat(env: medium.EnvParams):
    """Colatitude-frame SavedValues channel (the RayMain config); dip and
    psi take the colatitude geometry (RayMain.jl:128-131)."""

    def save_fn(u, f):
        r, theta, chi = u[..., 0], u[..., 1], u[..., 2]
        lat = math.pi / 2.0 - theta
        mu, dmudpsi = analytic.mu_dmudpsi_2d_lat(r, lat, chi, f, env)
        dip = dipole.dip_angle_colat(theta)
        psi = dispersion.psi_colat(theta, chi)
        return torch.stack([mu, dmudpsi, dip, psi], dim=-1)

    return save_fn


def make_save_fn_3d(env: medium.EnvParams):
    """3D SavedValues channel (the callback the reference left TODO,
    RayTrace_3D.jl:374-387): (mu, dmudpsi, dip, psi) with psi from the
    B.rho vector geometry (RayTrace_3D.jl:136-141).

    Field-general: |B| comes from the vector field (b_vec, valid for the
    tilted and IGRF fields) and the density is read at the magnetic
    latitude (mlat_3d), on the phi = 0 meridian's parameters, as the JAX
    package reads it. dip is the dipole dip at magnetic latitude."""

    def save_fn(u, f):
        r, theta, phi = u[..., 0], u[..., 1], u[..., 2]
        psi = dispersion.psi_3d(r, theta, phi, u[..., 3], u[..., 4],
                                u[..., 5], env)
        mlat = medium.mlat_3d(r, theta, phi, env)
        ne = medium.ne_total_m3(r, mlat, env)
        br, bt, bp = medium.b_vec(r, theta, phi, env)
        b = torch.sqrt(br * br + bt * bt + bp * bp)
        mu, dmudpsi = analytic.mu_and_dmudpsi(ne, b, f, psi)
        dip = dipole.dip_angle_lat(mlat)
        return torch.stack([mu, dmudpsi, dip, psi], dim=-1)

    return save_fn


def save_fn_for(frame: str, env: medium.EnvParams):
    """Diagnostics save_fn for a frame name ('2d_lat'|'2d_colat'|'3d')."""
    return {
        "2d_lat": make_save_fn_2d_lat,
        "2d_colat": make_save_fn_2d_colat,
        "3d": make_save_fn_3d,
    }[frame](env)


def stream_trajectory(env, u0, f, *, chunk_steps=1024, n_chunks=32,
                      save_every=16, save_fn=None, **trace_kw):
    """Long-trajectory capture with bounded device memory (SURVEY.md 5.7).

    The device holds one chunk of snapshots at a time (chunk_steps /
    save_every rows); each chunk is fetched to the host and the
    integration resumes exactly from the chunk's RayCarry
    (`trace(carry0=...)`). trace_kw: the other keywords of trace (frame,
    cfg, spec, adaptive, stepper, ...). Stops early once no ray is ACTIVE
    or MAX_STEPS.

    Returns (final TraceResult, host dict of concatenated snapshots)."""
    from .solve import trace

    carry = None
    chunks = []
    result = None
    for _ in range(n_chunks):
        result = trace(env, u0, f, max_steps=chunk_steps,
                       save_every=save_every, save_fn=save_fn, carry0=carry,
                       **trace_kw)
        carry = result.carry
        chunks.append({k: v.cpu().numpy() for k, v in result.traj.items()})
        # MAX_STEPS = the chunk's budget ran out, still integrable: the
        # next chunk's trace(carry0=...) resumes those rays
        status = carry.status.cpu().numpy()
        if not np.isin(status, (events.ACTIVE, events.MAX_STEPS)).any():
            break
    traj = {k: np.concatenate([c[k] for c in chunks], axis=0)
            for k in chunks[0]}
    return result, traj


def resample_trajectory(rhs_fn, traj, f, t_query, u0=None):
    """Evaluate a recorded trajectory at arbitrary phase-path points by
    cubic Hermite interpolation: the dense `sol(t)` output of the
    reference's solve (RayMain.jl:387). The endpoint derivatives are the
    right-hand side at every snapshot, evaluated in one batched call, so
    the interpolant is O(h^4) between snapshots.

    rhs_fn: the batched (u (N, n), f (N,)) -> du/dt of the trace
            (ops.rhs.frame_rhs(frame, env)[0]).
    traj:   dict from trace(..., save_every>0): "u" (S, B, n), "t" (S, B),
            tensors or numpy arrays.
    f:      (B,) frequencies.
    t_query: (Q,) shared, or (B, Q) per-ray, phase-path points.
    u0:     optional (B, n) initial states, prepended at t = 0 (the
            snapshots start at attempt save_every).

    Returns a (B, Q, n) numpy array. Queries outside a ray's recorded span
    clamp to its first or last snapshot."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)

    u_s = host(traj["u"])                  # (S, B, n)
    t_s = host(traj["t"])                  # (S, B)
    if u0 is not None:
        u_s = np.concatenate([host(u0)[None].astype(u_s.dtype), u_s], axis=0)
        t_s = np.concatenate([np.zeros((1, t_s.shape[1]), t_s.dtype), t_s])
    S, B, n = u_s.shape
    f = host(f).astype(u_s.dtype)
    with torch.no_grad():
        k_s = rhs_fn(torch.from_numpy(np.ascontiguousarray(
            u_s.reshape(S * B, n))), torch.from_numpy(np.tile(f, S)))
    k_s = k_s.cpu().numpy().reshape(S, B, n)

    t_query = np.asarray(t_query, t_s.dtype)
    if t_query.ndim == 1:
        t_query = np.broadcast_to(t_query, (B, t_query.size))
    out = np.empty((B, t_query.shape[1], n), u_s.dtype)
    for b in range(B):
        tb = t_s[:, b]
        # the frozen-t tail after termination: keep the strictly
        # increasing prefix (+1 so the landing snapshot stays reachable);
        # argmax, not searchsorted: t can fail to advance over one save
        # interval mid-flight and then resume
        non_inc = tb[1:] - tb[:-1] <= 0.0
        last = int(np.argmax(non_inc)) + 1 if non_inc.any() else tb.size
        if last < 2:  # terminated before the first snapshot interval
            out[b] = u_s[0, b]
            continue
        tb = tb[:last]
        tq = np.clip(t_query[b], tb[0], tb[-1])
        j = np.clip(np.searchsorted(tb, tq, side="right") - 1, 0, last - 2)
        t0, t1 = tb[j], tb[j + 1]
        h = np.where(t1 > t0, t1 - t0, 1.0)
        s = np.clip((tq - t0) / h, 0.0, 1.0)[:, None]
        ua, ub = u_s[j, b], u_s[j + 1, b]
        ka, kb = k_s[j, b], k_s[j + 1, b]
        s2, s3 = s * s, s * s * s
        out[b] = (
            (2.0 * s3 - 3.0 * s2 + 1.0) * ua
            + ((s3 - 2.0 * s2 + s) * h[:, None]) * ka
            + (-2.0 * s3 + 3.0 * s2) * ub
            + ((s3 - s2) * h[:, None]) * kb
        )
    return out


def trajectory_xy(traj_u, frame="2d_lat"):
    """(x, y) in RE for plotting, tensors or numpy arrays alike: x = r
    cos(lat), y = r sin(lat) (RayTrace_lat.jl:351-352); the colatitude
    frame uses x = r sin(theta), y = r cos(theta) (RayMain.jl:400-401)."""
    xp = torch if isinstance(traj_u, torch.Tensor) else np
    r = traj_u[..., 0]
    a = traj_u[..., 1]
    if frame == "2d_lat":
        return r * xp.cos(a), r * xp.sin(a)
    return r * xp.sin(a), r * xp.cos(a)
