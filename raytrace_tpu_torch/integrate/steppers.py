"""Runge-Kutta and Rosenbrock steppers (port of raytrace_tpu/integrate/steppers.py).

Batched over rays: u, k1 are (B, n), dt is (B,), rhs_fn maps a (B, n)
state to its (B, n) derivative. All are FSAL-structured: the derivative at
the end of the step comes back as k_end. The explicit pairs (bs3, dopri5)
are the plain PyTorch form of what the CUDA step kernel inlines; ros3pr is
the auto mode's stiff pool and runs as torch ops on the device.
"""

from typing import NamedTuple

import torch


class StepOut(NamedTuple):
    u_new: torch.Tensor     # proposed state at t + dt
    k_end: torch.Tensor     # du/dt at (t + dt, u_new)  [FSAL]
    err: torch.Tensor       # (B,) RMS error norm
    incr: torch.Tensor      # the raw increment u_new - u


def _err_norm(err_vec, u, u_new, rtol, atol):
    """RMS of err_vec / scale. The mean is summed in component order, the
    order the step kernel uses, so the two round alike on the card."""
    scale = atol + rtol * torch.maximum(torch.abs(u), torch.abs(u_new))
    sq = torch.square(err_vec / scale)
    total = sq[..., 0]
    for j in range(1, sq.shape[-1]):
        total = total + sq[..., j]
    return torch.sqrt(total / sq.shape[-1])


# Dormand-Prince 5(4) tableau (Hairer, Norsett & Wanner, table II.5.2)
_DP_A = (
    (0.2,),
    (3.0 / 40.0, 9.0 / 40.0),
    (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
    (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
    (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
     -5103.0 / 18656.0),
    (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
     11.0 / 84.0),
)
_DP_B5 = (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0,
          -2187.0 / 6784.0, 11.0 / 84.0, 0.0)
_DP_B4 = (5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
          -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0)


def dopri5_step(rhs_fn, u, k1, dt, rtol, atol):
    """One DP5(4) attempt: proposed state, FSAL k7, RMS error norm."""
    dtc = dt[..., None]
    ks = [k1]
    for row in _DP_A:
        acc = torch.zeros_like(u)
        for a_ij, k_j in zip(row, ks):
            acc = acc + a_ij * k_j
        ks.append(rhs_fn(u + dtc * acc))
    incr = dtc * sum(a_ij * k_j for a_ij, k_j in zip(_DP_A[-1], ks[:-1]))
    u_new = u + incr
    err_vec = dtc * sum(
        (b5 - b4) * k_j for b5, b4, k_j in zip(_DP_B5, _DP_B4, ks)
    )
    return StepOut(u_new, ks[6], _err_norm(err_vec, u, u_new, rtol, atol),
                   incr)


def bs3_step(rhs_fn, u, k1, dt, rtol, atol):
    """One Bogacki-Shampine 3(2) attempt (the ode23 pair): c = (1/2, 3/4,
    1), b = (2/9, 1/3, 4/9), embedded b* = (7/24, 1/4, 1/3, 1/8), with
    k4 = f(u_new) serving as the next attempt's k1."""
    dtc = dt[..., None]
    k2 = rhs_fn(u + (0.5 * dtc) * k1)
    k3 = rhs_fn(u + (0.75 * dtc) * k2)
    incr = dtc * (
        (2.0 / 9.0) * k1 + (1.0 / 3.0) * k2 + (4.0 / 9.0) * k3
    )
    u_new = u + incr
    k4 = rhs_fn(u_new)
    err_vec = dtc * (
        (2.0 / 9.0 - 7.0 / 24.0) * k1 + (1.0 / 3.0 - 0.25) * k2
        + (4.0 / 9.0 - 1.0 / 3.0) * k3 - 0.125 * k4
    )
    return StepOut(u_new, k4, _err_norm(err_vec, u, u_new, rtol, atol), incr)


def _solve4(W, b):
    """Branch-free 4x4 batched solve via the adjugate (cofactor) formula.

    W = I - h gamma J is within O(h) of the identity at accepted step
    sizes, so det(W) ~ 1 and the cofactor solve is well-conditioned."""
    a = W
    s0 = a[..., 0, 0] * a[..., 1, 1] - a[..., 1, 0] * a[..., 0, 1]
    s1 = a[..., 0, 0] * a[..., 1, 2] - a[..., 1, 0] * a[..., 0, 2]
    s2 = a[..., 0, 0] * a[..., 1, 3] - a[..., 1, 0] * a[..., 0, 3]
    s3 = a[..., 0, 1] * a[..., 1, 2] - a[..., 1, 1] * a[..., 0, 2]
    s4 = a[..., 0, 1] * a[..., 1, 3] - a[..., 1, 1] * a[..., 0, 3]
    s5 = a[..., 0, 2] * a[..., 1, 3] - a[..., 1, 2] * a[..., 0, 3]
    c5 = a[..., 2, 2] * a[..., 3, 3] - a[..., 3, 2] * a[..., 2, 3]
    c4 = a[..., 2, 1] * a[..., 3, 3] - a[..., 3, 1] * a[..., 2, 3]
    c3 = a[..., 2, 1] * a[..., 3, 2] - a[..., 3, 1] * a[..., 2, 2]
    c2 = a[..., 2, 0] * a[..., 3, 3] - a[..., 3, 0] * a[..., 2, 3]
    c1 = a[..., 2, 0] * a[..., 3, 2] - a[..., 3, 0] * a[..., 2, 2]
    c0 = a[..., 2, 0] * a[..., 3, 1] - a[..., 3, 0] * a[..., 2, 1]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / det
    rows = (
        (a[..., 1, 1] * c5 - a[..., 1, 2] * c4 + a[..., 1, 3] * c3,
         -a[..., 0, 1] * c5 + a[..., 0, 2] * c4 - a[..., 0, 3] * c3,
         a[..., 3, 1] * s5 - a[..., 3, 2] * s4 + a[..., 3, 3] * s3,
         -a[..., 2, 1] * s5 + a[..., 2, 2] * s4 - a[..., 2, 3] * s3),
        (-a[..., 1, 0] * c5 + a[..., 1, 2] * c2 - a[..., 1, 3] * c1,
         a[..., 0, 0] * c5 - a[..., 0, 2] * c2 + a[..., 0, 3] * c1,
         -a[..., 3, 0] * s5 + a[..., 3, 2] * s2 - a[..., 3, 3] * s1,
         a[..., 2, 0] * s5 - a[..., 2, 2] * s2 + a[..., 2, 3] * s1),
        (a[..., 1, 0] * c4 - a[..., 1, 1] * c2 + a[..., 1, 3] * c0,
         -a[..., 0, 0] * c4 + a[..., 0, 1] * c2 - a[..., 0, 3] * c0,
         a[..., 3, 0] * s4 - a[..., 3, 1] * s2 + a[..., 3, 3] * s0,
         -a[..., 2, 0] * s4 + a[..., 2, 1] * s2 - a[..., 2, 3] * s0),
        (-a[..., 1, 0] * c3 + a[..., 1, 1] * c1 - a[..., 1, 2] * c0,
         a[..., 0, 0] * c3 - a[..., 0, 1] * c1 + a[..., 0, 2] * c0,
         -a[..., 3, 0] * s3 + a[..., 3, 1] * s1 - a[..., 3, 2] * s0,
         a[..., 2, 0] * s3 - a[..., 2, 1] * s1 + a[..., 2, 2] * s0),
    )
    inv = torch.stack(
        [torch.stack(row, dim=-1) for row in rows], dim=-2
    ) * inv_det[..., None, None]
    return _matvec(inv, b)


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def _solve_w(W, b):
    """Linear solve for the Rosenbrock W-matrices (the 4-state frame)."""
    if W.shape[-1] != 4:
        raise NotImplementedError(
            "only the 4-state W-solve is ported (the 7-state frame is "
            "ROADMAP A7)"
        )
    return _solve4(W, b)


# ROS3PR-class coefficients (tools/derive_ros3.py)
_R3_G = 0.43586652150845899942
_R3_A31 = 1.0884445784759989947
_R3_A32 = -0.088444578475998994722
_R3_G21 = 0.77263012766755107092
_R3_G31 = -0.42177791180933232805
_R3_G32 = -0.014088609699126671361
_R3_B = (2.0 / 3.0, -0.10253318817512566608, _R3_G)
_R3_BH = (0.51136529971586299474, -0.17502879700629931581,
          0.66366349729043632107)


def ros3pr_step(rhs_fn, u, k1, dt, rtol, atol, jac_fn):
    """Order-3 stiffly-accurate L-stable Rosenbrock step (the stiff pool).

    jac_fn: u (B, n) -> (B, n, n), the exact per-ray Jacobian of rhs_fn
    (forward-mode autodiff, see integrate/solve.py). One shared
    W = I - h gamma J for all three stages; a non-finite end-derivative
    forces rejection (err = inf)."""
    gamma = _R3_G
    n = u.shape[-1]
    J = jac_fn(u)
    dtc = dt[..., None]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    W = eye - (dt * gamma)[..., None, None] * J
    s1 = _solve_w(W, dtc * k1)
    Js1 = _matvec(J, s1)
    f2 = rhs_fn(u + s1)
    s2 = _solve_w(W, dtc * f2 + (_R3_G21 * dtc) * Js1)
    f3 = rhs_fn(u + _R3_A31 * s1 + _R3_A32 * s2)
    s3 = _solve_w(
        W, dtc * f3 + dtc * (_R3_G31 * Js1 + _R3_G32 * _matvec(J, s2))
    )
    incr = _R3_B[0] * s1 + _R3_B[1] * s2 + _R3_B[2] * s3
    u_new = u + incr
    k_end = rhs_fn(u_new)
    err_vec = (
        (_R3_B[0] - _R3_BH[0]) * s1
        + (_R3_B[1] - _R3_BH[1]) * s2
        + (_R3_B[2] - _R3_BH[2]) * s3
    )
    err = _err_norm(err_vec, u, u_new, rtol, atol)
    err = torch.where(torch.isfinite(k_end).all(dim=-1), err,
                      torch.full_like(err, float("inf")))
    return StepOut(u_new, k_end, err, incr)
