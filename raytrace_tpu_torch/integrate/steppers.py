"""Runge-Kutta and Rosenbrock steppers (port of raytrace_tpu/integrate/steppers.py).

Batched over rays: u, k1 are (B, n), dt is (B,), rhs_fn maps a (B, n)
state to its (B, n) derivative. All are FSAL-structured: the derivative at
the end of the step comes back as k_end. The explicit pairs (bs3, dopri5)
and fixed-step rk4 are the plain PyTorch form of what the CUDA step kernel
inlines. The other adaptive steppers run as torch ops on the device, in the
4-state and the 7-state frames, as the Pallas kernel never runs them: heun2
(the explicit trapezoid 2(1) pair), and the linearly implicit ones, ros3pr
(the auto mode's stiff pool), ros2, and its Richardson extrapolations
ros2x (order 3) and ros4x (order 4). The Rosenbrock steps take jac_fn, u
(B, n) -> (B, n, n), the per-ray Jacobian of rhs_fn (integrate/solve.py).
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


def rk4_step(rhs_fn, u, k1, dt):
    """Classic RK4 step (fixed step: err is 0). k1 = rhs(u) comes from the
    carry; k_end = rhs(u_new) serves as the next step's k1. dt / 6 is a
    quotient by a Python scalar, which on the card is a product with its
    reciprocal; the kernel forms it so."""
    dtc = dt[..., None]
    k2 = rhs_fn(u + 0.5 * dtc * k1)
    k3 = rhs_fn(u + 0.5 * dtc * k2)
    k4 = rhs_fn(u + dtc * k3)
    incr = (dtc / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    u_new = u + incr
    return StepOut(u_new, rhs_fn(u_new), torch.zeros_like(dt), incr)


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


def heun21_step(rhs_fn, u, k1, dt, rtol, atol):
    """One Heun (explicit trapezoid) 2(1) attempt: k2 at the Euler
    predictor, the order-2 trapezoid advance, the Euler predictor as the
    embedded order-1 solution (error dt (k2 - k1)/2), and the FSAL
    end-derivative. A step whose end-derivative is not finite is rejected
    (err = inf): the estimate does not contain it, so such a step would
    otherwise poison the FSAL carry."""
    dtc = dt[..., None]
    k2 = rhs_fn(u + dtc * k1)
    incr = (0.5 * dtc) * (k1 + k2)
    u_new = u + incr
    k_end = rhs_fn(u_new)
    err_vec = (0.5 * dtc) * (k2 - k1)
    err = _err_norm(err_vec, u, u_new, rtol, atol)
    err = torch.where(torch.isfinite(k_end).all(dim=-1), err,
                      torch.full_like(err, float("inf")))
    return StepOut(u_new, k_end, err, incr)


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


def _solve_nopivot(W, b):
    """Branch-free unpivoted Gaussian elimination, unrolled over the
    state dimension: the W-solve of every size but 4 (the 7-state 3D
    frame). No pivoting is safe for the reason the adjugate is (_solve4):
    W is within O(h) of the identity, so every pivot is ~1."""
    n = W.shape[-1]
    rows = [W[..., i, :] for i in range(n)]
    rhs = [b[..., i] for i in range(n)]
    for k in range(n):
        inv = 1.0 / rows[k][..., k]
        for i in range(k + 1, n):
            m = rows[i][..., k] * inv
            rows[i] = rows[i] - m[..., None] * rows[k]
            rhs[i] = rhs[i] - m * rhs[k]
    x = [None] * n
    for k in reversed(range(n)):
        acc = rhs[k]
        for j in range(k + 1, n):
            acc = acc - rows[k][..., j] * x[j]
        x[k] = acc / rows[k][..., k]
    return torch.stack(x, dim=-1)


def _solve_w(W, b):
    """Linear solve for the Rosenbrock W-matrices: the adjugate for the
    4-state frames, elimination for the 7-state frame."""
    if W.shape[-1] == 4:
        return _solve4(W, b)
    return _solve_nopivot(W, b)


# ROS2: gamma = 1 + 1/sqrt(2) makes the 2-stage W-method L-stable
_ROS2_G = 1.0 + 0.7071067811865476


def _ros2_sub(rhs_fn, u, f0, J, dt, gamma):
    """One raw ROS2 advance with a supplied Jacobian J (a W-method: its
    order-2 conditions hold for any matrix in place of the exact
    Jacobian, so J may be shared across sub-steps)."""
    dtc = dt[..., None]
    n = u.shape[-1]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    W = eye - (dt * gamma)[..., None, None] * J
    s1 = _solve_w(W, dtc * f0)
    f2 = rhs_fn(u + s1)
    s2 = _solve_w(W, dtc * f2 - ((2.0 * gamma) * dtc) * _matvec(J, s1))
    return u + 0.5 * (s1 + s2), s1, s2


def ros2_step(rhs_fn, u, k1, dt, rtol, atol, jac_fn):
    """L-stable 2-stage Rosenbrock (ROS2) step: (I - h g J) k1 = h f(u),
    (I - h g J) k2 = h f(u + k1) - 2 g h J k1, u+ = u + (k1 + k2)/2; the
    linearly implicit Euler u + k1 is the embedded order-1 solution, so
    the error estimate is (k2 - k1)/2."""
    J = jac_fn(u)
    u_new, s1, s2 = _ros2_sub(rhs_fn, u, k1, J, dt, _ROS2_G)
    k_end = rhs_fn(u_new)
    err = _err_norm(0.5 * (s2 - s1), u, u_new, rtol, atol)
    return StepOut(u_new, k_end, err, 0.5 * (s1 + s2))


def ros2x_step(rhs_fn, u, k1, dt, rtol, atol, jac_fn):
    """Order-3 L-stable stiff step: one full ROS2 step and two half steps
    off one Jacobian, extrapolated as (4 u_halves - u_full)/3, with
    (u_halves - u_full)/3 as the embedded estimate."""
    J = jac_fn(u)
    h2 = 0.5 * dt
    u_full = _ros2_sub(rhs_fn, u, k1, J, dt, _ROS2_G)[0]
    u_h = _ros2_sub(rhs_fn, u, k1, J, h2, _ROS2_G)[0]
    u_hh = _ros2_sub(rhs_fn, u_h, rhs_fn(u_h), J, h2, _ROS2_G)[0]
    u_new = (4.0 * u_hh - u_full) / 3.0
    k_end = rhs_fn(u_new)
    err = _err_norm((u_hh - u_full) / 3.0, u, u_new, rtol, atol)
    return StepOut(u_new, k_end, err, u_new - u)


def ros4x_step(rhs_fn, u, k1, dt, rtol, atol, jac_fn):
    """Order-4 stiff step: the 1-, 2- and 4-substep ROS2 chains off one
    Jacobian, extrapolated twice (X1 = (4 y2 - y1)/3, X2 = (4 y4 - y2)/3,
    u+ = (8 X2 - X1)/7), with (X2 - X1)/7 as the embedded estimate."""
    J = jac_fn(u)
    h2 = 0.5 * dt
    h4 = 0.25 * dt
    y1 = _ros2_sub(rhs_fn, u, k1, J, dt, _ROS2_G)[0]
    a = _ros2_sub(rhs_fn, u, k1, J, h2, _ROS2_G)[0]
    y2 = _ros2_sub(rhs_fn, a, rhs_fn(a), J, h2, _ROS2_G)[0]
    b = _ros2_sub(rhs_fn, u, k1, J, h4, _ROS2_G)[0]
    for _ in range(3):
        b = _ros2_sub(rhs_fn, b, rhs_fn(b), J, h4, _ROS2_G)[0]
    x1 = (4.0 * y2 - y1) / 3.0
    x2 = (4.0 * b - y2) / 3.0
    u_new = (8.0 * x2 - x1) / 7.0
    k_end = rhs_fn(u_new)
    err = _err_norm((x2 - x1) / 7.0, u, u_new, rtol, atol)
    return StepOut(u_new, k_end, err, u_new - u)


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
