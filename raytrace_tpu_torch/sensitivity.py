"""Landing-state sensitivity: the adaptive variational (tangent) flow
(port of raytrace_tpu/sensitivity.py).

The state is augmented with k tangent columns V, du/dt = F(u) and
dV/dt = J(u) V, each column by one forward-mode product
(torch.func.jvp; no Jacobian is formed), and the (n + n k)-state system
is integrated by the same adaptive stepper as the ray, so the error
controller resolves the tangents too. The surface-crossing event refines
the augmented state, and the event projection

    Phi_event = (I - f_end e_r^T / f_end[r]) Phi

carries the perturbations to the surface r = r_floor along the flow:
d(landing state)/d(launch state). On the canonical ray (f = 1000 Hz, lat
45 deg) d(lat_land)/d(lat_0) is about -7.2e3 (the JAX package's
docstring gives -7226.4), while finite-difference secants at h >= 1e-7
read ~0.2: the landing map carries microscopic folds. `landing_secant`
measures the macroscopic response.

The variational system runs as torch ops on the tensors' device
(integrate.solve.trace_rhs), as the JAX package runs it through XLA's
trace and not through its step kernel: each attempt is some thousands of
small kernels on a card (PERF.md section 5).
"""

import numpy as np
import torch

from .integrate import events
from .integrate.events import StopSpec
from .integrate.solve import SolverConfig, trace_rhs

# the JAX package's defaults for a landing Jacobian (float64 analysis)
SENS_CFG = SolverConfig(rtol=1e-9, atol=1e-13)


def make_variational_rhs(rhs_fn, n, k=None):
    """The right-hand side of the augmented (u, V) system: ua (..., n + n k)
    holds the state, then the (n, k) tangent columns V row-major; each
    column's derivative is a jvp of rhs_fn(., f) at u, the k of them
    under one torch.func.vmap (the same values as one jvp per column, as
    the JAX package takes them, in about a fifth of the operations)."""
    k = n if k is None else k

    def rhs_aug(ua, f):
        lead = ua.shape[:-1]
        u = ua[..., :n]
        V = ua[..., n:].reshape(*lead, n, k)

        def F(uu):
            return rhs_fn(uu, f)

        def column(v):
            return torch.func.jvp(F, (u,), (v,))[1]

        dV = torch.func.vmap(column, in_dims=-1, out_dims=-1)(V)
        return torch.cat([F(u), dV.reshape(*lead, n * k)], dim=-1)

    return rhs_aug


def _as(x, device, dtype):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(device=device, dtype=dtype)


def _project(rhs_fn, u_land, f, phi):
    """Event projection of the (B, n, k) tangent columns phi at the (B, n)
    landing states: (I - f_end e_r^T / f_end[r]) phi."""
    n = u_land.shape[-1]
    f_end = rhs_fn(u_land, f)
    eye = torch.eye(n, dtype=u_land.dtype, device=u_land.device)
    proj = eye[None] - (f_end[:, :, None] * eye[0][None, None, :]
                        / f_end[:, 0][:, None, None])
    return torch.einsum("bij,bjk->bik", proj, phi)


def landing_sensitivity(rhs_fn, u0, f, *, cfg: SolverConfig = SENS_CFG,
                        spec: StopSpec = StopSpec(), group_idx=3,
                        max_steps=200000, tangents=None, device="cuda",
                        dtype=torch.float64):
    """Event-projected landing Jacobian of one ray, traced on `device` (the
    card unless the caller asks for the CPU) in `dtype` (float64, the
    JAX package's analysis precision).

    u0: (n,) launch state; f: its frequency; tangents: (n, k) initial
    tangent directions (default: the identity, the full Jacobian).
    Returns a dict of numpy values: u_land (landing state), status (the
    stop status; meaningful for HIT_EARTH), jac ((n, k) event-projected
    d(u_land)/d(u_launch)), dlat_dlaunch (its row of state[1]) and
    amplification (|d lat_land / d lat_0|, None unless k == n)."""
    u0 = _as(u0, device, dtype)
    n = u0.shape[0]
    V0 = (torch.eye(n, dtype=dtype, device=u0.device) if tangents is None
          else _as(tangents, u0.device, dtype))
    k = V0.shape[1]
    ua0 = torch.cat([u0, V0.reshape(n * k)])[None]
    fb = _as(f, u0.device, dtype).reshape(1)
    res = trace_rhs(make_variational_rhs(rhs_fn, n, k), ua0, fb, cfg=cfg,
                    spec=spec, group_idx=group_idx, max_steps=max_steps,
                    chunk=256)
    u_land = res.u[:, :n]
    jac = _project(rhs_fn, u_land, fb, res.u[:, n:].reshape(1, n, k))[0]
    return {
        "u_land": u_land[0].cpu().numpy(),
        "status": int(res.status[0]),
        "jac": jac.cpu().numpy(),
        "dlat_dlaunch": jac[1].cpu().numpy(),
        "amplification": float(jac[1, 1].abs()) if k == n else None,
    }


def landing_sensitivity_batch(rhs_fn, u0, f, *, cfg: SolverConfig = SENS_CFG,
                              spec: StopSpec = StopSpec(), group_idx=3,
                              max_steps=200000, device="cuda",
                              dtype=torch.float64):
    """Event-projected landing Jacobians of a fan in one trace: u0 (B, n),
    f (B,); the augmented system of every ray integrated as one (B, n +
    n^2)-state batch. Returns dict(u_land (B, n), status (B,), jac (B, n,
    n), amplification (B,)) of numpy arrays."""
    u0 = _as(u0, device, dtype)
    b, n = u0.shape
    eye = torch.eye(n, dtype=dtype, device=u0.device).reshape(1, n * n)
    ua0 = torch.cat([u0, eye.expand(b, n * n)], dim=1)
    fb = _as(f, u0.device, dtype)
    res = trace_rhs(make_variational_rhs(rhs_fn, n), ua0, fb, cfg=cfg,
                    spec=spec, group_idx=group_idx, max_steps=max_steps,
                    chunk=256)
    u_land = res.u[:, :n]
    jac = _project(rhs_fn, u_land, fb, res.u[:, n:].reshape(b, n, n))
    return {
        "u_land": u_land.cpu().numpy(),
        "status": res.status.cpu().numpy(),
        "jac": jac.cpu().numpy(),
        "amplification": jac[:, 1, 1].abs().cpu().numpy(),
    }


def landing_secant(rhs_fn, u0, f, index=1, h=1e-6, *,
                   cfg: SolverConfig = SolverConfig(rtol=1e-12, atol=1e-15),
                   spec: StopSpec = StopSpec(), group_idx=3,
                   max_steps=200000, device="cuda", dtype=torch.float64):
    """Macroscopic landing response: the central secant of lat_land over
    a launch window h in launch component `index` (the module docstring
    says why it differs from the tangent by orders of magnitude). Raises
    RuntimeError if a perturbed ray does not land."""
    u0 = np.asarray(u0, np.float64)

    def land(delta):
        u = u0.copy()
        u[index] += delta
        r = trace_rhs(rhs_fn, _as(u[None], device, dtype),
                      _as(np.asarray(f).reshape(1), device, dtype), cfg=cfg,
                      spec=spec, group_idx=group_idx, max_steps=max_steps,
                      chunk=256)
        if int(r.status[0]) != events.HIT_EARTH:
            raise RuntimeError(
                f"perturbed ray did not land: status {int(r.status[0])}")
        return float(r.u[0, 1])

    return (land(h) - land(-h)) / (2.0 * h)
