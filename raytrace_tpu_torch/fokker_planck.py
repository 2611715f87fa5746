"""Bounce-averaged pitch-angle Fokker-Planck solver (port of
raytrace_tpu/fokker_planck.py).

    df/dt = (1/G) d/da [ G(a) <D_aa>(a) df/da ],   G(a) = T(a) sin a cos a,

on a cell-centred finite-volume grid in alpha_eq (absorbing at the loss
cone, reflecting at 90 deg), Crank-Nicolson in time, and the precipitation
lifetime 1/lambda_1 by inverse power iteration; the equations and their
validation are the JAX module's.

The tridiagonal solves are Thomas sweeps, sequential in the grid cells
and vectorized over any batch: `thomas_solve` factors (the pivots and
c'_i, which depend only on the matrix) and substitutes. Crank-Nicolson
and the inverse iteration solve one matrix over and over, so they factor
it once and substitute each step, three torch ops a cell (the sweep's
values are the per-step recomputation's). On the card, with
graph=True, one CN step (one inverse iteration) is captured as a CUDA
graph over a static state and replayed: the same kernels in the same
order as the eager loop, so the same values, without the host's cost
of launching ~3 x n_cells small kernels a step one by one.

Device and dtype as in placement.py; the grids are built by numpy and
moved to the device. `eigen_lifetime`'s dense eigensolve runs on the
host (numpy), as in the JAX module.
"""

import math

import numpy as np
import torch

from .diffusion import bounce_nodes, mirror_latitude
from .integrate.graph import GraphLoop
from .placement import device_of, place


def bounce_time_factor(alpha_eq_rad, n_lat=128, device=None):
    """Normalized dipole quarter-bounce time T(a_eq) =
    (1/L RE) int_0^lam_m ds / |cos a(lam)| (the lam = lam_m sin x
    quadrature of diffusion.bounce_averaged). T(90 deg) = pi sqrt(2)/6."""
    (aeq,) = place(alpha_eq_rad, device=device)
    lam_m = mirror_latitude(aeq)
    lam, dlam = bounce_nodes(lam_m, n_lat)
    slat, clat = torch.sin(lam), torch.cos(lam)
    b_ratio = torch.sqrt(1.0 + 3.0 * slat * slat) / clat**6
    s2a = torch.clamp(torch.sin(aeq[..., None]) ** 2 * b_ratio, 0.0, 1.0)
    cosa = torch.sqrt(torch.clamp(1.0 - s2a, min=1.0e-24))
    jarc = clat * torch.sqrt(1.0 + 3.0 * slat * slat)
    return (jarc * dlam / cosa).sum(dim=-1)


def make_grid(alpha_lc_rad, n_cells=192, device=None):
    """Uniform cell-centred grid on [alpha_lc, pi/2] (numpy's linspace,
    moved to the device). Returns (centers, faces, da), da a Python
    float. The loss-cone edge is the absorbing left wall; pi/2 the
    zero-flux right wall."""
    dev = device_of(device=device)
    faces = np.linspace(float(alpha_lc_rad), 0.5 * math.pi, n_cells + 1)
    centers = 0.5 * (faces[:-1] + faces[1:])
    return (torch.as_tensor(centers, device=dev),
            torch.as_tensor(faces, device=dev), float(faces[1] - faces[0]))


def build_operator(d_faces, g_centers, g_faces, da,
                   left_bc="absorbing", right_bc="reflecting", device=None):
    """Tridiagonal FV operator A with (A f)_i ~ (1/G_i) d/da [G D df/da].

    d_faces, g_faces: D and G at the n+1 faces; g_centers: G at the n
    cell centres. Returns (lower, diag, upper), each (..., n) (lower[0]
    and upper[-1] unused). Walls: absorbing = Dirichlet f_wall = 0 half a
    cell out (flux 2 G D f_1 / da); reflecting = zero flux."""
    d_faces, g_centers, g_faces = place(d_faces, g_centers, g_faces,
                                         device=device)
    w = d_faces * g_faces / (da * da)          # face conductances / da^2
    w_in = w[..., 1:-1]                        # interior faces, length n-1

    lower = torch.cat([torch.zeros_like(w[..., :1]), w_in], dim=-1)
    upper = torch.cat([w_in, torch.zeros_like(w[..., :1])], dim=-1)
    diag = -(lower + upper)

    def wall(coeff, bc):
        if bc == "absorbing":
            return 2.0 * coeff          # Dirichlet at half-cell distance
        if bc == "reflecting":
            return torch.zeros_like(coeff)
        raise ValueError(f"unknown bc {bc!r}")

    d0 = diag[..., :1] - wall(w[..., :1], left_bc)
    dn = diag[..., -1:] - wall(w[..., -1:], right_bc)
    diag = torch.cat([d0, diag[..., 1:-1], dn], dim=-1)
    inv_g = 1.0 / g_centers
    return lower * inv_g, diag * inv_g, upper * inv_g


def _factor(lower, diag, upper):
    """The Thomas sweep's forward coefficients of one matrix: pivots
    den_i = d_i - l_i c'_{i-1} and c'_i = u_i / den_i (broadcast to a
    common batch shape), each as its n cells' views."""
    lower, diag, upper = torch.broadcast_tensors(lower, diag, upper)
    den, c = torch.empty_like(diag), torch.empty_like(diag)
    dens, cs = den.unbind(-1), c.unbind(-1)
    c_prev = torch.zeros_like(dens[0])
    for l_i, d_i, u_i, den_i, c_i in zip(lower.unbind(-1), diag.unbind(-1),
                                         upper.unbind(-1), dens, cs):
        torch.sub(d_i, l_i * c_prev, out=den_i)
        torch.div(u_i, den_i, out=c_i)
        c_prev = c_i
    return den.shape, lower.unbind(-1), dens, cs


def _substitute(lu, b):
    """x solving the factored system for right-hand side b: b'_i =
    (b_i - l_i b'_{i-1}) / den_i forward, x_i = b'_i - c'_i x_{i+1}
    back; three torch ops a cell (on views made once: the eager loop is
    bound by the host's cost per op)."""
    shape, lows, dens, cs = lu
    b = b.expand(torch.broadcast_shapes(shape, b.shape))
    bp, x = torch.empty_like(b), torch.empty_like(b)
    bps, xs = bp.unbind(-1), x.unbind(-1)
    prev = torch.zeros_like(bps[0])
    for b_i, l_i, den_i, bp_i in zip(b.unbind(-1), lows, dens, bps):
        torch.div(torch.addcmul(b_i, l_i, prev, value=-1.0), den_i,
                  out=bp_i)
        prev = bp_i
    nxt = torch.zeros_like(prev)
    for bp_i, c_i, x_i in zip(reversed(bps), reversed(cs), reversed(xs)):
        torch.addcmul(bp_i, c_i, nxt, value=-1.0, out=x_i)
        nxt = x_i
    return x


def thomas_solve(lower, diag, upper, b, device=None):
    """Tridiagonal solve by the Thomas sweep, all args (..., n) (batch
    dims broadcast and ride along vectorized). No pivoting: the CN matrix
    I - dt/2 A is strictly diagonally dominant and -A a weakly dominant
    M-matrix (strict in the absorbing-wall row), the no-pivot cases."""
    lower, diag, upper, b = place(lower, diag, upper, b, device=device)
    return _substitute(_factor(lower, diag, upper), b)


def apply_tri(lower, diag, upper, f, device=None):
    """y = T f for a tridiagonal T given as (lower, diag, upper)."""
    lower, diag, upper, f = place(lower, diag, upper, f, device=device)
    fm = torch.cat([torch.zeros_like(f[..., :1]), f[..., :-1]], dim=-1)
    fp_ = torch.cat([f[..., 1:], torch.zeros_like(f[..., :1])], dim=-1)
    return lower * fm + diag * f + upper * fp_


def content(f, g_centers, da, device=None):
    """Particle content N = int f G da (the conserved number)."""
    f, g_centers = place(f, g_centers, device=device)
    return (f * g_centers * da).sum(dim=-1)


def evolve_cn(f0, tri, dt, n_steps, save_every=0, source=None, graph=True,
              device=None):
    """Crank-Nicolson evolution of df/dt = A f + source for n_steps of dt.

    tri = (lower, diag, upper) of A, batch-broadcastable against f0
    (..., n); source: a constant-in-time right-hand side (each CN step
    takes it at full weight dt). Each step solves (I - dt/2 A) f+ =
    (I + dt/2 A) f + dt source; the matrix is factored once. save_every >
    0 also returns the snapshots every that many steps, stacked on a
    leading axis; an n_steps % save_every remainder is still evolved
    (f_end reflects all n_steps). graph: on the card, replay one step as
    a CUDA graph (the same values as graph=False)."""
    lower, diag, upper, f0 = place(*tri, f0, device=device)
    half = 0.5 * dt
    lu = _factor(-half * lower, 1.0 - half * diag, -half * upper)
    b = 0.0 if source is None else dt * place(source, device=f0.device)[0]

    def step(f):
        return _substitute(lu, f + half * apply_tri(lower, diag, upper, f)
                           + b)

    state = torch.broadcast_to(f0, torch.broadcast_shapes(
        f0.shape, lu[0][:-1] + f0.shape[-1:])).clone()
    loop = GraphLoop(step, state, graph)
    if save_every:
        n_out, rem = divmod(n_steps, save_every)
        snaps = state.new_empty((n_out,) + state.shape)
        for k in range(n_out):
            snaps[k] = loop.run(save_every)
        return loop.run(rem).clone(), snaps
    return loop.run(n_steps).clone()


def _g_of(alpha, n_lat=128):
    """G = T(a) sin a cos a at the grid's centres or faces."""
    return bounce_time_factor(alpha, n_lat) * torch.sin(alpha) \
        * torch.cos(alpha)


def precipitation_lifetime(daa_centers, alpha_lc_rad, n_cells=192,
                           n_iter=64, device=None, graph=True):
    """Precipitation lifetime tau = 1/lambda_1 [s] of the lowest decay
    mode, batch-shaped.

    daa_centers: <D_aa>(alpha) [rad^2/s] on the make_grid cell centres,
    (..., n_cells) (every batch row its own profile). The operator has an
    absorbing loss cone and a reflecting 90 deg wall; lambda_1 comes from
    n_iter steps of inverse power iteration x <- (-A)^{-1} x (one
    factorization, a substitution a step), each normalized in the G
    inner product, closed by the G-weighted Rayleigh quotient (-A is
    self-adjoint positive in that product). graph: on the card, replay
    one iteration as a CUDA graph (the same values as graph=False)."""
    (daa,) = place(daa_centers, device=device)
    centers, faces, da = make_grid(alpha_lc_rad, n_cells, daa.device)
    centers, faces = centers.to(daa.dtype), faces.to(daa.dtype)
    g_c = _g_of(centers)
    g_f = torch.clamp(_g_of(faces), min=1.0e-12)   # G(pi/2) = 0: dead wall
    w = g_c * da                                    # G inner-product weight
    d_faces = torch.cat([daa[..., :1], 0.5 * (daa[..., 1:] + daa[..., :-1]),
                         daa[..., -1:]], dim=-1)
    lo, dg, up = build_operator(d_faces, g_c, g_f, da)
    nlo, ndg, nup = -lo, -dg, -up                   # -A: positive definite
    lu = _factor(nlo, ndg, nup)

    def body(x):
        y = _substitute(lu, x)
        return y / torch.sqrt((y * y * w).sum(dim=-1, keepdim=True))

    f0 = torch.sin(centers - centers[0] + 0.5 * da)
    x = GraphLoop(body, f0.expand(daa.shape).clone(), graph).run(n_iter)
    lam = (x * apply_tri(nlo, ndg, nup, x) * w).sum(dim=-1) \
        / (x * x * w).sum(dim=-1)
    return 1.0 / lam


def eigen_lifetime(daa_centers, alpha_lc_rad, n_cells=192, device=None):
    """Dense-eigensolve cross-check: tau = 1/min Re eig(-A) over the real
    eigenvalues (a Python float). The operator is assembled as
    precipitation_lifetime's, on the device; numpy.linalg.eigvals solves
    it on the host."""
    (daa,) = place(daa_centers, device=device)
    centers, faces, da = make_grid(alpha_lc_rad, n_cells, daa.device)
    g_c = _g_of(centers.to(daa.dtype))
    g_f = torch.clamp(_g_of(faces.to(daa.dtype)), min=1.0e-12)
    d_faces = torch.cat([daa[..., :1], 0.5 * (daa[..., 1:] + daa[..., :-1]),
                         daa[..., -1:]], dim=-1)
    lower, diag, upper = (t.cpu().numpy().astype(np.float64) for t in
                          build_operator(d_faces, g_c, g_f, da))
    a = np.diag(diag) + np.diag(lower[1:], -1) + np.diag(upper[:-1], 1)
    ev = np.linalg.eigvals(-a)
    ev = ev[np.abs(ev.imag) < 1.0e-9 * np.abs(ev.real).max()].real
    return float(1.0 / ev[ev > 0.0].min())
