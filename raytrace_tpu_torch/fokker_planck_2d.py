"""Bounce-averaged 2D pitch-angle + momentum Fokker-Planck solver (port of
raytrace_tpu/fokker_planck_2d.py).

    df/dt = (1/G) [ d/da ( G (D_aa df/da + D_ap df/dp) )
                  + d/dp ( G (D_ap df/da + D_pp df/dp) ) ],
    G(a, p) = p^2 T(a) sin a cos a,

on the (alpha_eq, p) grid, p in m_e c, Crank-Nicolson in time with an
absorbing (or reflecting) loss-cone wall; the equations, the split of
the tensor into a diagonal remainder and a rank-1 part, and their
validation are the JAX module's.

The operator. The JAX module defines A f as the gradient of the
quadratic energy a(f, f)/2 (face terms k_a, k_p, the loss-cone wall
k_lc, and the rank-1 part as a perfect square at each cell's four
corners with face gradients padded by zero walls), which makes A
symmetric positive semidefinite by construction. Here A f is that
gradient written out by hand as D^T W D: the face fluxes

    F_a[i] = k_a d_a[i] + G_a[i] / da,
    G_a[i] = (r_a[i-1] + r_a[i])/2 ga[i] + (r_x[i-1] S_p[i-1]
             + r_x[i] S_p[i]) / 4

(ga = d_a / da the face gradients, S_p = gp_lo + gp_hi a cell's two
p-face gradients; the same along p), and (A f)_c = F[lo] - F[hi] summed
over both axes plus k_lc f at the wall. The face coefficients are formed
once per operator (_Stencil), so A f is ~40 forward torch ops with no
division, safe to capture in a CUDA graph. The tests hold it to autograd
of a torch copy of the energy and to the JAX module at 1e-12, and the
dense matrix to symmetry at 1e-13.

Crank-Nicolson: each step solves (M + dt/2 A) f+ = (M - dt/2 A) f by
Jacobi-preconditioned CG warm-started from f, stopping at the first
iterate with |r| <= tol max(|b|, 1e-300) or at cg_maxiter, as the JAX
module's while_loop does.

- On CUDA tensors `evolve_cn_2d` launches the hand-written kernel of
  csrc/cn_pcg_2d.cu (ops/cn_pcg_2d.py): every CN step and CG iteration
  of the evolution in one launch. There is no fallback.
- On CPU tensors it runs `evolve_cn_2d_reference`, the plain version:
  the CG iterations masked (once the stop test holds, x, r, p, rz and k
  are frozen by torch.where, so extra passes change nothing), run
  through integrate/graph.py::GraphLoop -- on the card, as CUDA graphs:
  one for a step's set-up and one for `unroll` masked iterations,
  replayed until the stop test holds (one host sync each).

`evolve_cn_2d.cg_iterations` holds the CG iteration count of each step
of the last evolution (either path), for checks and timing; no public
function returns it.

Device and dtype as in placement.py (the operator's tensors carry
them); the grid is numpy, as in the JAX module.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .constants import C_LIGHT, M_E, Q_E
from .fokker_planck import bounce_time_factor, make_grid
from .integrate.graph import GraphLoop
from .placement import device_of, dtype_of, tensor

_MC2_KEV = M_E * C_LIGHT * C_LIGHT / Q_E / 1.0e3   # electron rest energy, keV


@dataclass(frozen=True)
class Grid2D:
    """Tensor grid: uniform alpha in [a_lc, pi/2] x (optionally log) p
    (numpy float64, as the JAX module's)."""

    alpha_c: np.ndarray          # (n_a,) cell centers
    alpha_f: np.ndarray          # (n_a+1,) faces
    da: float
    p_c: np.ndarray              # (n_p,) cell centers  [m_e c]
    p_f: np.ndarray              # (n_p+1,) faces
    dp: np.ndarray               # (n_p,) cell widths
    dpc: np.ndarray              # (n_p-1,) center-to-center distances


def make_grid_2d(alpha_lc_rad, n_alpha, p_min_mc, p_max_mc, n_p,
                 log_p=True):
    """Build the (alpha_eq, p) grid. p in units of m_e c."""
    a_c, a_f, da = make_grid(alpha_lc_rad, n_alpha, device="cpu")
    if log_p:
        p_f = np.geomspace(p_min_mc, p_max_mc, n_p + 1)
    else:
        p_f = np.linspace(p_min_mc, p_max_mc, n_p + 1)
    p_c = 0.5 * (p_f[:-1] + p_f[1:])
    return Grid2D(a_c.numpy(), a_f.numpy(), float(da), p_c, p_f,
                  np.diff(p_f), np.diff(p_c))


def energy_from_p(p_mc):
    """Kinetic energy [keV] from momentum in m_e c units."""
    return (np.sqrt(1.0 + np.asarray(p_mc) ** 2) - 1.0) * _MC2_KEV


def p_from_energy(e_kev):
    """Momentum [m_e c] from kinetic energy [keV]."""
    gamma = 1.0 + np.asarray(e_kev) / _MC2_KEV
    return np.sqrt(gamma * gamma - 1.0)


def tensor_from_bounce(ba):
    """Convert diffusion.bounce_averaged output (SI) to solver units:
    (daa [rad^2/s], dap [rad (m_e c)/s], dpp [(m_e c)^2/s]), tensors kept
    on their device."""
    s = M_E * C_LIGHT
    return ba["daa"], ba["dap"] / s, ba["dpp"] / (s * s)


def _avg_a(x):
    """Cell-center -> interior-alpha-face arithmetic average (axis -2)."""
    return 0.5 * (x[..., 1:, :] + x[..., :-1, :])


def _avg_p(x):
    """Cell-center -> interior-p-face arithmetic average (axis -1)."""
    return 0.5 * (x[..., 1:] + x[..., :-1])


@dataclass(frozen=True)
class _Op2D:
    """Assembled conductances, tensors on one device in one dtype (the
    JAX module's _Op2D field for field; see its docstring for the split
    of the tensor into a diagonal remainder on the faces and a rank-1
    perfect square at the cell corners)."""

    k_a: torch.Tensor     # (n_a-1, n_p) interior alpha-face conductance
    k_lc: torch.Tensor    # (n_p,) loss-cone wall conductance (0 if reflect)
    k_p: torch.Tensor     # (n_a, n_p-1) interior p-face conductance
    r_a: torch.Tensor     # (n_a, n_p) rank-1 cell weight G V |c| s
    r_x: torch.Tensor     # (n_a, n_p) rank-1 cell weight G V c (signed)
    r_p: torch.Tensor     # (n_a, n_p) rank-1 cell weight G V |c| / s
    mass: torch.Tensor    # (n_a, n_p) G_c * da * dp
    diag: torch.Tensor    # (n_a, n_p) diagonal of A (preconditioner)
    da: float
    dpc: torch.Tensor     # (n_p-1,)
    n_a: int
    n_p: int


def make_operator_2d(grid: Grid2D, daa, dap, dpp, loss_cone="absorbing",
                     g_centers=None, device=None):
    """Assemble the 2D operator from the cell-centered tensor.

    daa/dap/dpp: (n_a, n_p) at grid cell centers, solver units (p in m_e
    c; see tensor_from_bounce). G(a,p) = p^2 T(a) sin a cos a is
    evaluated exactly at the faces (T by fokker_planck.
    bounce_time_factor, in float64 on the device, then cast); face D
    values are arithmetic center averages. g_centers overrides G (tests
    use G = 1); an overridden G is averaged to faces. The operator takes
    daa's device and dtype (placement.py)."""
    n_a, n_p = grid.alpha_c.size, grid.p_c.size
    dev = device_of(daa, dap, dpp, g_centers, device=device)
    dt = dtype_of(daa, dap, dpp)
    daa, dap, dpp = (tensor(x, dev, dt) for x in (daa, dap, dpp))

    def host(x):
        return tensor(x, dev, dt)

    da = grid.da
    dp = host(grid.dp)
    dpc = host(grid.dpc)

    if g_centers is None:
        a_c = torch.as_tensor(grid.alpha_c, device=dev)
        a_f = torch.as_tensor(grid.alpha_f, device=dev)
        t_c = bounce_time_factor(a_c)
        t_f = bounce_time_factor(a_f)
        ga_c = torch.clamp(t_c * torch.sin(a_c) * torch.cos(a_c), min=1e-12)
        ga_f = torch.clamp(t_f * torch.sin(a_f) * torch.cos(a_f), min=1e-12)
        p_c = torch.as_tensor(grid.p_c, device=dev)
        p_f = torch.as_tensor(grid.p_f, device=dev)
        g_c = (ga_c[:, None] * p_c[None, :] ** 2).to(dt)
        g_af = (ga_f[1:-1, None] * p_c[None, :] ** 2).to(dt)
        g_pf = (ga_c[:, None] * p_f[None, 1:-1] ** 2).to(dt)
        g_wall = (ga_f[0] * p_c ** 2).to(dt)
    else:
        g_c = host(g_centers)
        g_af = _avg_a(g_c)
        g_pf = _avg_p(g_c)
        g_wall = g_c[0, :]

    # the PSD split: rank-1 magnitudes per cell, guarded at the 0/0 limits
    absc = torch.abs(dap)
    tiny = torch.finfo(dt).tiny * 1e4
    s = torch.sqrt(torch.clamp(daa, min=tiny) / torch.clamp(dpp, min=tiny))
    c_on = (absc > 0.0) & (daa > 0.0) & (dpp > 0.0)
    zero = torch.zeros((), device=dev, dtype=dt)
    rank_a = torch.where(c_on, absc * s, zero)
    rank_p = torch.where(c_on, absc / s, zero)
    c_eff = torch.where(c_on, dap, zero)
    daa_rem = torch.clamp(daa - rank_a, min=0.0)
    dpp_rem = torch.clamp(dpp - rank_p, min=0.0)

    # face conductances K = (G D)_face * (transverse width) / (normal dist)
    k_a = _avg_a(daa_rem) * g_af * dp[None, :] / da
    k_p = _avg_p(dpp_rem) * g_pf * da / dpc[None, :]

    if loss_cone == "absorbing":
        # Dirichlet f = 0 at the wall, half a cell out; the wall flux
        # carries the full D_aa
        k_lc = daa[0, :] * g_wall * dp / (0.5 * da)
    elif loss_cone == "reflecting":
        k_lc = torch.zeros((n_p,), device=dev, dtype=dt)
    else:
        raise ValueError(f"unknown loss_cone {loss_cone!r}")

    vol = g_c * da * dp[None, :]
    r_a = rank_a * vol
    r_x = c_eff * vol
    r_p = rank_p * vol

    # the Jacobi preconditioner: the faces' K on both adjacent cells, the
    # wall term, and the rank-1 corner quadrature's face self-terms (the
    # JAX module's diag, term for term)
    zrow = torch.zeros((1, n_p), device=dev, dtype=dt)
    zcol = torch.zeros((n_a, 1), device=dev, dtype=dt)
    diag = torch.cat([k_a, zrow], 0) + torch.cat([zrow, k_a], 0)
    diag = torch.cat([diag[:1] + k_lc, diag[1:]], 0)
    diag = diag + (torch.cat([k_p, zcol], 1) + torch.cat([zcol, k_p], 1))
    ra_face = 0.5 * (r_a[1:, :] + r_a[:-1, :]) / (da * da)
    diag = diag + (torch.cat([ra_face, zrow], 0)
                   + torch.cat([zrow, ra_face], 0))
    rp_face = 0.5 * (r_p[:, 1:] + r_p[:, :-1]) / (dpc[None, :] ** 2)
    diag = diag + (torch.cat([rp_face, zcol], 1)
                   + torch.cat([zcol, rp_face], 1))
    return _Op2D(k_a=k_a, k_lc=k_lc, k_p=k_p, r_a=r_a, r_x=r_x, r_p=r_p,
                 mass=vol, diag=diag, da=float(da), dpc=dpc, n_a=n_a,
                 n_p=n_p)


def _pad_a(x):
    """(..., n_a-1, n_p) interior alpha-face values -> (..., n_a+1, n_p),
    zero at both walls."""
    z = x.new_zeros(x.shape[:-2] + (1, x.shape[-1]))
    return torch.cat([z, x, z], dim=-2)


def _pad_p(x):
    """(..., n_a, n_p-1) interior p-face values -> (..., n_a, n_p+1),
    zero at both walls."""
    z = x.new_zeros(x.shape[:-1] + (1,))
    return torch.cat([z, x, z], dim=-1)


@dataclass(frozen=True)
class _Stencil:
    """The face coefficients of A f, formed once per operator (the
    kernel's wrapper passes these same tensors to csrc/cn_pcg_2d.cu):
    with ga = d_a / da and the rank-1 face term written out,

        F_a[i] = k_a d_a + G_a / da
               = ka d_a + qa (w[i-1] + w[i]),   w = r_x S_p,
        ka = k_a + (r_a[i-1] + r_a[i]) / (2 da^2),   qa = 1 / (4 da),

    and the same along p with kp, qp = 1 / (4 dpc), v = r_x S_a."""

    inv_da: float
    qa: float
    inv_dpc: torch.Tensor   # (n_p-1,)
    qp: torch.Tensor        # (n_p-1,)
    ka: torch.Tensor        # (n_a-1, n_p)
    kp: torch.Tensor        # (n_a, n_p-1)


def _stencil(op: _Op2D):
    inv_da = 1.0 / op.da
    inv_dpc = 1.0 / op.dpc
    ka = op.k_a + 0.5 * (op.r_a[:-1, :] + op.r_a[1:, :]) * (inv_da * inv_da)
    kp = op.k_p + 0.5 * (op.r_p[:, :-1] + op.r_p[:, 1:]) * (inv_dpc
                                                            * inv_dpc)
    return _Stencil(inv_da=inv_da, qa=0.25 * inv_da, inv_dpc=inv_dpc,
                    qp=0.25 * inv_dpc, ka=ka, kp=kp)


def _apply_a(f, op: _Op2D, st: _Stencil = None):
    """A f as the adjoint stencil D^T W D of the JAX module's energy (see
    the module docstring and _Stencil): each cell's face-gradient sums
    S_a, S_p, then the face fluxes, then their divergence, with the
    loss-cone wall term on the first alpha row. csrc/cn_pcg_2d.cu
    computes each cell's value with the same expressions in the same
    order."""
    st = _stencil(op) if st is None else st
    d_a = f[..., 1:, :] - f[..., :-1, :]          # interior alpha faces
    d_p = f[..., :, 1:] - f[..., :, :-1]          # interior p faces
    ga = _pad_a(d_a * st.inv_da)                   # face gradients, walls 0
    gp = _pad_p(d_p * st.inv_dpc)
    v = op.r_x * (ga[..., :-1, :] + ga[..., 1:, :])   # r_x S_a
    w = op.r_x * (gp[..., :-1] + gp[..., 1:])         # r_x S_p
    flux_a = _pad_a(st.ka * d_a + st.qa * (w[..., :-1, :] + w[..., 1:, :]))
    flux_p = _pad_p(st.kp * d_p + st.qp * (v[..., :-1] + v[..., 1:]))
    out = ((flux_a[..., :-1, :] - flux_a[..., 1:, :])
           + (flux_p[..., :-1] - flux_p[..., 1:]))
    return torch.cat([out[..., :1, :] + op.k_lc * f[..., :1, :],
                      out[..., 1:, :]], dim=-2)


def _energy(f, op: _Op2D):
    """0.5 a(f, f), the JAX module's energy as torch ops: the tests hold
    _apply_a to its autograd gradient."""
    ea = 0.5 * (op.k_a * (f[1:, :] - f[:-1, :]) ** 2).sum()
    elc = 0.5 * (op.k_lc * f[0, :] ** 2).sum()
    ep = 0.5 * (op.k_p * (f[:, 1:] - f[:, :-1]) ** 2).sum()
    ga_f = _pad_a((f[1:, :] - f[:-1, :]) / op.da)
    gp_f = _pad_p((f[:, 1:] - f[:, :-1]) / op.dpc[None, :])
    quad = 0.0
    for ga in (ga_f[:-1, :], ga_f[1:, :]):
        for gp in (gp_f[:, :-1], gp_f[:, 1:]):
            quad = quad + (op.r_a * ga * ga + 2.0 * op.r_x * ga * gp
                           + op.r_p * gp * gp).sum()
    return ea + elc + ep + 0.125 * quad


def apply_operator_2d(op: _Op2D, f):
    """A f. df/dt = -(1/mass) A f is the semi-discrete equation. f: a
    tensor on the operator's device (numpy goes there, in its dtype)."""
    return _apply_a(tensor(f, op.mass.device, op.mass.dtype), op)


def content_2d(op: _Op2D, f):
    """Particle number N = sum f G dV (conserved under zero-flux walls)."""
    return (tensor(f, op.mass.device, op.mass.dtype) * op.mass).sum()


def default_cg_tol(dtype):
    """cg_tol's default by dtype: 1e-10 in float64, 3e-6 in float32 (a
    tighter tol than float32 residuals reach would burn cg_maxiter
    iterations a step)."""
    return 1.0e-10 if dtype == torch.float64 else 3.0e-6


def _tiny(dtype):
    """The CG denominators' guard: 1e-37 in float32, 1e-300 in float64."""
    return 1.0e-37 if dtype == torch.float32 else 1.0e-300


def _cg_bodies(op, half, m_inv, tol, maxiter, unroll):
    """(setup, iterate): GraphLoop bodies over the state (x, r, p, rz,
    eps, k, done). setup starts a CN step from f = x: b = M f - dt/2 A f,
    r = b - H x, p = z = m_inv r, eps = tol max(|b|, 1e-300), k = 0.
    iterate runs `unroll` CG iterations, each masked by the stop test
    |r| > eps and k < maxiter taken before it (JAX's while_loop
    condition), and sets done once the test fails."""
    dt = op.mass.dtype
    st = _stencil(op)
    tiny = torch.tensor(_tiny(dt), device=op.mass.device, dtype=dt)
    floor = torch.tensor(1.0e-300, device=op.mass.device, dtype=dt)

    def going(r, eps, k):
        return (torch.sqrt((r * r).sum()) > eps) & (k < maxiter)

    def setup(s):
        x, _, _, _, _, k, _ = s
        af = _apply_a(x, op, st)
        b = op.mass * x - half * af
        r = b - (op.mass * x + half * af)
        z = m_inv * r
        rz = (r * z).sum()
        eps = tol * torch.maximum(torch.sqrt((b * b).sum()), floor)
        k0 = torch.zeros_like(k)
        return x, r, z, rz, eps, k0, ~going(r, eps, k0)

    def iterate(s):
        x, r, p, rz, eps, k, _ = s
        for _ in range(unroll):
            on = going(r, eps, k)
            hp = op.mass * p + half * _apply_a(p, op, st)
            alpha = rz / torch.maximum((p * hp).sum(), tiny)
            r1 = r - alpha * hp
            z = m_inv * r1
            rz1 = (r1 * z).sum()
            p1 = z + (rz1 / torch.maximum(rz, tiny)) * p
            x = torch.where(on, x + alpha * p, x)
            r = torch.where(on, r1, r)
            p = torch.where(on, p1, p)
            rz = torch.where(on, rz1, rz)
            k = k + on.to(k.dtype)
        return x, r, p, rz, eps, k, ~going(r, eps, k)

    return setup, iterate


def evolve_cn_2d_reference(f0, op: _Op2D, dt, n_steps, save_every=0,
                           cg_tol=None, cg_maxiter=500, graph=True,
                           unroll=None):
    """The plain PyTorch version of evolve_cn_2d (same arguments and
    returns). graph: on the card, the step's set-up and `unroll` masked
    CG iterations are each replayed as a CUDA graph (the same kernels in
    the same order as graph=False, so the same values). unroll defaults
    to 1 on the CPU (the stop test costs nothing there) and 8 on the
    card. Sets evolve_cn_2d.cg_iterations."""
    x = tensor(f0, op.mass.device, op.mass.dtype).clone()
    dtype, dev = x.dtype, x.device
    if cg_tol is None:
        cg_tol = default_cg_tol(dtype)
    if unroll is None:
        unroll = 1 if dev.type == "cpu" else 8
    half = 0.5 * dt
    m_inv = 1.0 / (op.mass + half * op.diag)
    setup, iterate = _cg_bodies(op, half, m_inv, cg_tol, cg_maxiter, unroll)
    zero = torch.zeros((), device=dev, dtype=dtype)
    state = (x, torch.zeros_like(x), torch.zeros_like(x), zero.clone(),
             zero.clone(), torch.zeros((), device=dev, dtype=torch.int64),
             torch.zeros((), device=dev, dtype=torch.bool))
    start = GraphLoop(setup, state, graph)
    cg = GraphLoop(iterate, state, graph)
    passes = -(-cg_maxiter // unroll)
    iters = torch.empty((n_steps,), device=dev, dtype=torch.int32)

    snaps = []
    for i in range(n_steps):
        start.run(1)
        cg.run(passes, until=lambda s: s[6])
        iters[i] = state[5]
        if save_every and (i + 1) % save_every == 0:
            snaps.append(x.clone())
    evolve_cn_2d.cg_iterations = iters
    if save_every:
        return x, (torch.stack(snaps) if snaps
                   else x.new_empty((0,) + x.shape))
    return x


def evolve_cn_2d(f0, op: _Op2D, dt, n_steps, save_every=0, cg_tol=None,
                 cg_maxiter=500):
    """Crank-Nicolson evolution of M df/dt = -A f for n_steps of dt.

    Each step solves the SPD system (M + dt/2 A) f+ = (M - dt/2 A) f by
    Jacobi-preconditioned CG, warm-started from the previous f.
    save_every > 0 also returns snapshots stacked on a leading axis; an
    n_steps % save_every remainder is still evolved (f_end always
    reflects the full n_steps). cg_tol defaults by dtype: 1e-10 in
    float64, 3e-6 in float32. f0 goes to the operator's device and dtype.

    On the card the whole evolution is one launch of the kernel of
    csrc/cn_pcg_2d.cu; on the CPU it is evolve_cn_2d_reference."""
    if op.mass.device.type == "cuda":
        from .ops import cn_pcg_2d

        f_end, snaps, iters = cn_pcg_2d.cn_pcg_2d(
            tensor(f0, op.mass.device, op.mass.dtype), op, dt, n_steps,
            save_every, default_cg_tol(op.mass.dtype) if cg_tol is None
            else cg_tol, cg_maxiter)
        evolve_cn_2d.cg_iterations = iters
        return (f_end, snaps) if save_every else f_end
    return evolve_cn_2d_reference(f0, op, dt, n_steps, save_every, cg_tol,
                                  cg_maxiter)


evolve_cn_2d.cg_iterations = None
