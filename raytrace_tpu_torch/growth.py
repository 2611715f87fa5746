"""Whistler and EMIC growth/damping along rays (port of
raytrace_tpu/growth.py).

The Kennel-Petschek weak-growth rate of a hot anisotropic bi-Maxwellian
fraction on the framework's cold dispersion: `gamma_whistler` and
`gamma_emic` (quasi-longitudinal, the cyclotron resonance only),
`gamma_oblique` (the exact cold oblique root and polarization, the
cyclotron and Landau harmonics), the path gain along traced
trajectories (`path_gain`), the parallel group velocity, the
single-transit gain and the equatorial gain spectrum. The physics and
its derivations are the JAX module's (tools/derive_growth.py,
tools/derive_growth_oblique.py); this module computes the same formulas
as torch ops, in the order the JAX module writes them.

Device and dtype (placement.py): tensors stay on their device and dtype;
numpy arrays and scalars become float64 on the card unless the caller
names a device. Every function returns tensors, but `transit_gain_db`
for one frequency, which returns a Python float as the JAX module does.

The Bessel weights of `gamma_oblique` are this module's own (J0, J1, J2
by the power series below |x| = 1 and Miller's backward recurrence
above, within ~1e-15 of scipy's jv): torch.special.bessel_j0/j1 are off
by up to ~5e-7 for 5 < |x| < 8, where the oblique arguments live.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from .constants import C_LIGHT, FCE_E, FCE_P, FPE2_E, FPE2_P, M_E, M_P, Q_E
from .constants import RE as _RE_M
from .models import medium
from .ops import dispersion
from .placement import place

_TWO_PI = 2.0 * math.pi
_NEPER_DB = 20.0 / math.log(10.0)    # 1 neper = 8.6859 dB (amplitude)


@dataclass(frozen=True)
class HotElectrons:
    """A hot anisotropic electron fraction riding on the cold density.

    eta: n_hot / n_e; t_par_ev: parallel temperature in eV (apar =
    sqrt(2 T / m_e)); anisotropy: A = Tperp/Tpar - 1 (0 = isotropic)."""

    eta: float = 1.0e-3
    t_par_ev: float = 10.0e3
    anisotropy: float = 1.0


@dataclass(frozen=True)
class HotProtons:
    """A hot anisotropic proton fraction (EMIC growth, gamma_emic); apar
    uses the proton mass."""

    eta: float = 1.0e-3
    t_par_ev: float = 30.0e3
    anisotropy: float = 1.0


def _dstix_dw(w, ne_m3, bmag, mode, eta_he=0.0, eta_o=0.0):
    """Closed-form d/dw of the cold Stix R (mode='whistler') or L
    (mode='emic') in angular units: each species adds
    wps^2 (2w + sig) / (w (w + sig))^2, sig = -+ wc (flipped for L)."""
    n_cm3 = ne_m3 * 1.0e-6
    flip = -1.0 if mode == "emic" else 1.0
    out = 0.0
    species = [(FPE2_E, -FCE_E)]
    for fpe2_i, fce_i in dispersion.ion_species(eta_he, eta_o):
        species.append((fpe2_i, fce_i))
    for fpe2_s, fce_signed in species:
        wps2 = _TWO_PI**2 * fpe2_s * n_cm3
        sig = flip * _TWO_PI * fce_signed * bmag
        den = w * (w + sig)
        out = out + wps2 * (2.0 * w + sig) / (den * den)
    return out


def _dr_dw(w, ne_m3, bmag, eta_he=0.0, eta_o=0.0):
    return _dstix_dw(w, ne_m3, bmag, "whistler", eta_he, eta_o)


def gamma_whistler(f, bmag, ne_m3, hot: HotElectrons, psi=0.0,
                   eta_he=0.0, eta_o=0.0, device=None):
    """Local temporal growth rate gamma [rad/s] of the whistler amplitude
    (positive = growth). f [Hz], bmag [T], ne_m3 [m^-3], psi [rad]
    broadcast. The quasi-longitudinal index (Stix R at the effective
    field B |cos psi|) with kpar = k |cos psi| in the resonance;
    evanescent points return 0."""
    return _gamma_cyclotron(f, bmag, ne_m3, hot, psi, "whistler", eta_he,
                            eta_o, device)


def gamma_emic(f, bmag, ne_m3, hot: HotProtons, psi=0.0,
               eta_he=0.0, eta_o=0.0, device=None):
    """Local growth rate gamma [rad/s] of the EMIC (L-mode) amplitude,
    driven by a hot anisotropic proton fraction; the counterpart of
    gamma_whistler on the cold L index."""
    return _gamma_cyclotron(f, bmag, ne_m3, hot, psi, "emic", eta_he,
                            eta_o, device)


def _gamma_cyclotron(f, bmag, ne_m3, hot, psi, mode, eta_he, eta_o,
                     device=None):
    f, bmag, ne_m3, psi = place(f, bmag, ne_m3, psi, device=device)
    w = _TWO_PI * f
    n_cm3 = ne_m3 * 1.0e-6
    if mode == "whistler":
        wc = _TWO_PI * FCE_E * bmag
        wp2_hot = hot.eta * _TWO_PI**2 * FPE2_E * n_cm3
        apar = math.sqrt(2.0 * Q_E * hot.t_par_ev / M_E)
        rlp_idx = 0          # cold R carries the QL whistler branch
    elif mode == "emic":
        wc = _TWO_PI * FCE_P * bmag
        wp2_hot = hot.eta * _TWO_PI**2 * FPE2_P * n_cm3
        apar = math.sqrt(2.0 * Q_E * hot.t_par_ev / M_P)
        rlp_idx = 1          # cold L carries the QL EMIC branch
    else:
        raise ValueError(f"unknown mode {mode!r}")

    cpsi = torch.abs(torch.cos(psi))
    b_eff = bmag * cpsi
    mu2_ql = dispersion.stix_rlp(ne_m3, b_eff, f, eta_he, eta_o)[rlp_idx]
    propagating = mu2_ql > 0.0
    mu2s = torch.where(propagating, mu2_ql, 1.0)
    k = (w / C_LIGHT) * torch.sqrt(mu2s)
    kpar = torch.clamp(k * cpsi, min=1.0e-30)

    # the resonance uses the true gyrofrequency; only the cold index takes
    # the QL Y cos psi substitution
    tr = hot.anisotropy + 1.0
    zeta = (w - wc) / (kpar * apar)
    q = (wp2_hot / (w * w)) * (
        zeta * (tr - 1.0) + w / (kpar * apar)
    )
    im_chi = math.sqrt(math.pi) * torch.exp(
        -torch.clamp(zeta * zeta, max=700.0)) * q

    ddw = _dstix_dw(w, ne_m3, b_eff, mode, eta_he, eta_o) + 2.0 * mu2s / w
    gamma = -im_chi / ddw
    return torch.where(propagating, gamma, 0.0)


def _dp_dw(w, ne_m3, eta_he=0.0, eta_o=0.0):
    """Closed-form d/dw of the cold Stix P = 1 - sum_s wps^2/w^2."""
    n_cm3 = ne_m3 * 1.0e-6
    fpe2_tot = FPE2_E + sum(
        fpe2_i for fpe2_i, _ in dispersion.ion_species(eta_he, eta_o)
    )
    return 2.0 * _TWO_PI**2 * fpe2_tot * n_cm3 / w**3


def _cross(a, b):
    """a x b over the last axis, component by component as numpy's
    cross writes it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def cold_mode_oblique(f, bmag, ne_m3, psi, eta_he=0.0, eta_o=0.0,
                      device=None):
    """Physical whistler-branch cold root and polarization at oblique psi.

    The Stix quartic A mu^4 - B mu^2 + C = 0 (stable quadratic), the
    positive root (the larger where both propagate); the polarization is
    the null vector of the dispersion tensor (k in the x-z plane, B0 = z)
    from the cross product of its two most independent rows. Returns
    dict: mu2, propagating (bool), e ((..., 3) complex unit
    polarization), lam_p (d/dw [e* . D . e] at fixed k), S, D, P."""
    f, bmag, ne_m3, psi = place(f, bmag, ne_m3, psi, device=device)
    w = _TWO_PI * f

    r_, l_, p_ = dispersion.stix_rlp(ne_m3, bmag, f, eta_he, eta_o)
    s_, d_ = (r_ + l_) / 2.0, (r_ - l_) / 2.0
    sn, cs = torch.abs(torch.sin(psi)), torch.abs(torch.cos(psi))
    sn2, cs2 = sn * sn, cs * cs

    qa = s_ * sn2 + p_ * cs2
    qb = r_ * l_ * sn2 + p_ * s_ * (1.0 + cs2)
    qc = p_ * r_ * l_
    disc = qb * qb - 4.0 * qa * qc
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    # stable quadratic: the (B + sign(B) sq) form avoids cancellation
    qden = qb + torch.where(qb >= 0.0, sq, -sq)
    qden = torch.where(qden == 0.0, 1.0, qden)
    root1 = qden / (2.0 * torch.where(qa == 0.0, torch.finfo(qa.dtype).tiny,
                                      qa))
    root2 = 2.0 * qc / qden
    both = torch.stack([root1, root2], dim=-1)
    pos = both > 0.0
    # whistler branch: the positive root; if both positive, the larger
    mu2 = torch.where(
        pos.any(dim=-1),
        torch.where(pos.all(dim=-1), both.amax(dim=-1),
                    torch.where(pos[..., 0], both[..., 0], both[..., 1])),
        1.0,
    )
    propagating = ok & pos.any(dim=-1)
    n2 = torch.where(propagating, mu2, 1.0)

    # dispersion-tensor rows (complex); null vector from row crosses
    zero = torch.zeros_like(n2)

    def cplx(re, im=None):
        return torch.complex(re, zero if im is None else im)

    row0 = torch.stack([cplx(s_ - n2 * cs2), cplx(zero, -d_),
                        cplx(n2 * cs * sn)], dim=-1)
    row1 = torch.stack([cplx(zero, d_), cplx(s_ - n2), cplx(zero)], dim=-1)
    row2 = torch.stack([cplx(n2 * cs * sn), cplx(zero),
                        cplx(p_ - n2 * sn2)], dim=-1)
    stackc = torch.stack([_cross(row0, row1), _cross(row0, row2),
                          _cross(row1, row2)], dim=0)
    stackn = (torch.abs(stackc) ** 2).sum(dim=-1)
    pick = torch.argmax(stackn, dim=0)          # first maximum, as numpy
    idx = pick[None, ..., None].expand((1,) + pick.shape + (3,))
    e = torch.gather(stackc, 0, idx)[0]
    en = torch.sqrt((torch.abs(e) ** 2).sum(dim=-1, keepdim=True))
    e = e / torch.where(en == 0.0, 1.0, en)

    # lam_p = d/dw [e* . D . e] at fixed k:
    #   e* . d(eps)/dw . e + (-2/w) n^2 (|kap.e|^2 - 1)
    dr = _dstix_dw(w, ne_m3, bmag, "whistler", eta_he, eta_o)
    dl = _dstix_dw(w, ne_m3, bmag, "emic", eta_he, eta_o)
    ds_, dd_ = (dr + dl) / 2.0, (dr - dl) / 2.0
    dp_ = _dp_dw(w, ne_m3, eta_he, eta_o)
    e0, e1, e2 = e[..., 0], e[..., 1], e[..., 2]
    deps = (ds_ * (torch.abs(e0) ** 2 + torch.abs(e1) ** 2)
            + dp_ * torch.abs(e2) ** 2
            + 2.0 * dd_ * torch.imag(torch.conj(e0) * e1))
    kap_e = sn * e0 + cs * e2
    lam_p = deps + (-2.0 / w) * n2 * (torch.abs(kap_e) ** 2 - 1.0)
    return {"mu2": n2, "propagating": propagating, "e": e,
            "lam_p": lam_p, "S": s_, "D": d_, "P": p_}


# Bessel J_0 ... J_n of gamma_oblique: the power series below |x| = 1 (12
# terms: exact to rounding there), Miller's backward recurrence above,
# normalized by J0 + 2 sum J_2k = 1 and rescaled by 2^-830 every 8 steps
_SERIES_X = 1.0
_SERIES_TERMS = 12
_MILLER_BIG = 2.0 ** 830


def _bessel_series(x, n):
    """J_n(x) = (x/2)^n sum_k (-x^2/4)^k / (k! (k+n)!), Horner form."""
    q = 0.25 * x * x
    coef = [1.0 / (math.factorial(k) * math.factorial(k + n))
            for k in range(_SERIES_TERMS)]
    s = torch.full_like(x, coef[-1])
    for c in reversed(coef[:-1]):
        s = c - q * s
    return (0.5 * x) ** n * s


def _bessel_orders(x, n_max=2):
    """[J_0, ..., J_n_max] of a real tensor x, within ~1e-15 absolute of
    scipy's jv for |x| up to hundreds (J_n(-x) = (-1)^n J_n(x)): the
    orders Miller's recurrence passes on its way down to J_0."""
    ax = torch.abs(x)
    small = ax < _SERIES_X
    xs = torch.where(small, ax, 0.0)
    series = [_bessel_series(xs, n) for n in range(n_max + 1)]

    xm = torch.where(small, 1.0, ax)
    xmax = float(xm.max()) if xm.numel() else 1.0
    m = 2 * int((xmax + 30.0 + 6.0 * math.sqrt(xmax)) // 2 + 1)
    m = max(m, 2 * ((n_max + 31) // 2))
    tox = 2.0 / xm
    bjp, bj = torch.zeros_like(xm), torch.ones_like(xm)
    s = torch.zeros_like(xm)
    kept = [None] * (n_max + 1)
    for j in range(m, 0, -1):
        bjp, bj = bj, (j * tox) * bj - bjp       # bj = J_{j-1}, unscaled
        if j % 2 == 1:
            s = s + bj
        if j - 1 <= n_max:
            kept[j - 1] = bj
        if j % 8 == 0:
            scale = torch.ones_like(bj).masked_fill_(
                torch.abs(bj) > _MILLER_BIG, 1.0 / _MILLER_BIG)
            bj, bjp, s = bj * scale, bjp * scale, s * scale
            kept = [k if k is None else k * scale for k in kept]
    norm = 2.0 * s - bj
    odd = torch.ones_like(x).masked_fill_(x < 0.0, -1.0)
    return [torch.where(small, a, b / norm) * (odd if n % 2 else 1.0)
            for n, (a, b) in enumerate(zip(series, kept))]


def _bessel_jn(js, n):
    """J_n from [J_0, ..., J_N] for |n| <= N: J_-n = (-1)^n J_n."""
    if abs(n) >= len(js):
        raise ValueError(f"Bessel order {n} asked of orders up to "
                         f"{len(js) - 1}")
    out = js[abs(n)]
    return -out if n < 0 and n % 2 else out


def gamma_oblique(f, bmag, ne_m3, hot: HotElectrons, psi,
                  harmonics=(-1, 0, 1), n_quad=96,
                  eta_he=0.0, eta_o=0.0, return_parts=False, device=None):
    """Fully oblique kinetic growth/damping rate gamma [rad/s] of the
    whistler branch: cyclotron (m = -+1) and Landau (m = 0) resonances
    with the hot bi-Maxwellian electron fraction at the exact cold
    oblique root and polarization,

      gamma = -(e* . A . e) / (d/dw [e* . D . e]),
      e* A e = -(pi wph^2)/(w kpar) sum_m 2pi Int dvperp U_m |T_m . e|^2,

    the vperp integral Gauss-Legendre on vperp/aperp in [0, 8] (n_quad
    nodes from numpy, moved to the device). harmonics: which m to sum, any
    integers (the Bessel orders up to max|m| + 1 from one recurrence).
    Evanescent points and psi at or beyond the resonance cone return 0."""
    f, bmag, ne_m3, psi = torch.broadcast_tensors(
        *place(f, bmag, ne_m3, psi, device=device))
    dev, dt = f.device, f.dtype

    cold = cold_mode_oblique(f, bmag, ne_m3, psi, eta_he, eta_o)
    w = _TWO_PI * f
    mu = torch.sqrt(cold["mu2"])
    sn, cs = torch.abs(torch.sin(psi)), torch.abs(torch.cos(psi))
    k = (w / C_LIGHT) * mu
    kpar = torch.clamp(k * cs, min=1.0e-30)
    kperp = k * sn

    wce = _TWO_PI * FCE_E * bmag
    omega_e = -wce                        # signed electron gyrofrequency
    n_cm3 = ne_m3 * 1.0e-6
    wp2_hot = hot.eta * _TWO_PI**2 * FPE2_E * n_cm3
    apar = math.sqrt(2.0 * Q_E * hot.t_par_ev / M_E)
    tr = hot.anisotropy + 1.0
    aperp = apar * math.sqrt(tr)

    # Gauss-Legendre on x = vperp/aperp in [0, 8], the Gaussian weight
    # explicit in the integrand (the JAX module's nodes, from numpy)
    xg, wg = np.polynomial.legendre.leggauss(int(n_quad))
    x_hi = 8.0
    xq = 0.5 * x_hi * (xg + 1.0)
    wq = torch.as_tensor(0.5 * x_hi * wg * np.exp(-xq * xq),
                         device=dev).to(dt)
    vperp = torch.as_tensor(aperp * xq, device=dev).to(dt)   # (nq,)
    a_arg = kperp[..., None] * vperp / omega_e[..., None]
    js = _bessel_orders(
        a_arg, max((abs(int(m)) for m in harmonics), default=0) + 1)
    e = cold["e"]
    er, ei = e.real, e.imag
    e0r, e1r, e2r = (er[..., i, None] for i in range(3))
    e0i, e1i, e2i = (ei[..., i, None] for i in range(3))

    c0 = 1.0 / (math.pi**1.5 * apar * aperp**2)   # f0 / e^{-x^2-zeta^2}
    contraction = torch.zeros_like(f)
    parts = {}
    for m in harmonics:
        m = int(m)
        vres = (w - m * omega_e) / kpar
        gauss_par = torch.exp(-torch.clamp((vres / apar) ** 2, max=700.0))
        u_coef = -(2.0 * c0 * gauss_par / w) * (
            m * omega_e / aperp**2 + kpar * vres / apar**2
        )
        jm = _bessel_jn(js, m)
        jm1, jp1 = _bessel_jn(js, m - 1), _bessel_jn(js, m + 1)
        # conj(T) . e with T_y = -i vperp Jm' (real and imaginary parts
        # as numpy's complex products round them)
        a = vperp * (jm1 + jp1) / 2.0
        y = vperp * (jm1 - jp1) / 2.0
        z = vres[..., None] * jm
        t_re = a * e0r - y * e1i + z * e2r
        t_im = a * e0i + y * e1r + z * e2i
        g = u_coef[..., None] * vperp * torch.hypot(t_re, t_im) ** 2
        i_m = aperp * (wq * g).sum(dim=-1)
        part = -(math.pi * wp2_hot / (w * kpar)) * 2.0 * math.pi * i_m
        contraction = contraction + part
        if return_parts:
            parts[m] = part

    live = cold["propagating"] & (cs > 1.0e-12)
    gamma = torch.where(live, -contraction / cold["lam_p"], 0.0)
    if return_parts:
        gamma_m = {m: torch.where(live, -p / cold["lam_p"], 0.0)
                   for m, p in parts.items()}
        return gamma, {"gamma_m": gamma_m, "mu2": cold["mu2"],
                       "e": e, "lam_p": cold["lam_p"]}
    return gamma


def path_gain(traj_u, f, env, hot: HotElectrons, frame="2d_lat",
              psi_mode="local", kinetics="ql", device=None):
    """Growth-rate profile and integrated amplitude gain along
    trajectories.

    traj_u: (S, B, n) saved snapshots (or (S, n) for one ray) in the
    given frame ("2d_lat" | "2d_colat" | "3d"); f: Hz, scalar or (B,).
    gain(s) = Int gamma dT [nepers] on the ray's own group-delay channel
    (u[..., 3] in 2D, u[..., 6] in 3D), snapshots whose T does not
    advance (post-termination padding) masked out. The 3D frame takes
    |B| from the vector field and the density at the magnetic latitude.
    psi_mode: "local" or "parallel" (psi = 0); kinetics: "ql"
    (gamma_whistler) or "oblique" (gamma_oblique).

    Returns dict: gamma (S, B) [rad/s], gain_neper (S, B) cumulative,
    gain_db (S, B), t (S, B) group time [s]."""
    u, f = place(traj_u, f, device=device)
    squeeze = u.dim() == 2
    if squeeze:
        u = u[:, None, :]
    r = u[..., 0]
    if frame == "2d_lat":
        lat = u[..., 1]
        psi = dispersion.psi_lat(u[..., 1], u[..., 2])
        bm = medium.b_mag(r, lat, env)
        ne = medium.ne_total_m3(r, lat, env)
        t_idx = 3
    elif frame == "2d_colat":
        lat = math.pi / 2 - u[..., 1]
        psi = dispersion.psi_colat(u[..., 1], u[..., 2])
        bm = medium.b_mag(r, lat, env)
        ne = medium.ne_total_m3(r, lat, env)
        t_idx = 3
    elif frame == "3d":
        theta, phi = u[..., 1], u[..., 2]
        psi = dispersion.psi_3d(r, theta, phi, u[..., 3], u[..., 4],
                                u[..., 5], env)
        mlat = medium.mlat_3d(r, theta, phi, env)
        br, bt, bp = medium.b_vec(r, theta, phi, env)
        bm = torch.sqrt(br**2 + bt**2 + bp**2)
        ne = medium.ne_total_m3(r, mlat, env)
        t_idx = 6
    else:
        raise ValueError(f"unsupported frame {frame!r}")
    if psi_mode == "parallel":
        psi = torch.zeros_like(psi)
    elif psi_mode != "local":
        raise ValueError(f"unknown psi_mode {psi_mode!r}")
    f_b = f.expand(bm.shape)
    if kinetics == "ql":
        gam = gamma_whistler(f_b, bm, ne, hot, psi=psi,
                             eta_he=float(env.eta_he),
                             eta_o=float(env.eta_o))
    elif kinetics == "oblique":
        gam = gamma_oblique(f_b, bm, ne, hot, psi,
                            eta_he=float(env.eta_he),
                            eta_o=float(env.eta_o))
    else:
        raise ValueError(f"unknown kinetics {kinetics!r}")

    # the T state is already in seconds (ops/rhs.py folds RE_OVER_C in)
    t = u[..., t_idx]
    dtt = torch.diff(t, dim=0)
    dtt = torch.where(dtt > 0.0, dtt, 0.0)
    mid = 0.5 * (gam[1:] + gam[:-1])
    gain = torch.cat([torch.zeros_like(gam[:1]),
                      torch.cumsum(mid * dtt, dim=0)], dim=0)
    out = {
        "gamma": gam,
        "gain_neper": gain,
        "gain_db": gain * _NEPER_DB,
        "t": t,
    }
    if squeeze:
        out = {kk: v[:, 0] for kk, v in out.items()}
    return out


def group_velocity_parallel(f, bmag, ne_m3, mode="whistler",
                            eta_he=0.0, eta_o=0.0, device=None):
    """Parallel group velocity [m/s] of the R-mode whistler (or L-mode
    EMIC): v_g = c / (mu + w dmu/dw), dmu/dw = (dR/dw)/(2 mu) from
    _dstix_dw; 0 where the mode is evanescent."""
    f, bmag, ne_m3 = place(f, bmag, ne_m3, device=device)
    w = _TWO_PI * f
    idx = 0 if mode == "whistler" else 1
    mu2 = dispersion.stix_rlp(ne_m3, bmag, f, eta_he, eta_o)[idx]
    ok = mu2 > 0.0
    mu = torch.sqrt(torch.where(ok, mu2, 1.0))
    dmudw = _dstix_dw(w, ne_m3, bmag, mode, eta_he, eta_o) / (2.0 * mu)
    vg = C_LIGHT / (mu + w * dmudw)
    return torch.where(ok, vg, 0.0)


def transit_gain_db(l_shell, f, env, hot, mode="whistler",
                    lat_max_deg=45.0, n_lat=301, device=None):
    """Single-transit Kennel-Petschek gain [dB] of a field-aligned packet
    crossing the equatorial region of the dipole line L once:
    G = Int gamma / v_g ds (ds = L cos(lat) sqrt(1 + 3 sin^2 lat) dlat)
    x 8.686, trapezoidal over n_lat latitudes (from numpy's linspace).
    mode="emic" takes HotProtons and the L mode. Returns a tensor over
    f, or a Python float for one frequency."""
    l_shell, f = place(l_shell, f, device=device)
    lat = torch.as_tensor(np.radians(np.linspace(-lat_max_deg, lat_max_deg,
                                                 n_lat)),
                          device=f.device).to(f.dtype)
    r = l_shell * torch.cos(lat) ** 2
    bm = medium.b_mag(r, torch.abs(lat), env)
    ne = medium.ne_total_m3(r, torch.abs(lat), env)
    ds = (l_shell * torch.cos(lat)
          * torch.sqrt(1.0 + 3.0 * torch.sin(lat) ** 2)) * _RE_M

    f = torch.atleast_1d(f)
    eh, eo = float(env.eta_he), float(env.eta_o)
    fb = f[:, None].expand(f.shape[0], n_lat)
    gam = _gamma_cyclotron(fb, bm, ne, hot, 0.0, mode, eh, eo)
    vg = group_velocity_parallel(fb, bm, ne, mode, eh, eo)
    integrand = torch.where(vg > 0.0, gam / torch.clamp(vg, min=1.0), 0.0)
    gain = torch.trapezoid(integrand * ds, lat, dim=-1) * _NEPER_DB
    return gain if gain.numel() > 1 else float(gain[0])


def equatorial_gain_profile(l_shell, f, env, hot: HotElectrons, psi=0.0,
                            device=None):
    """gamma(f) at the equator of an L-shell: the classic KP
    amplification spectrum. Returns dict: gamma [rad/s], fce [Hz],
    f_cutoff = fce A/(1 + A) [Hz]."""
    r, f = place(l_shell, f, device=device)
    lat = torch.zeros_like(r)
    bm = medium.b_mag(r, lat, env)
    ne = medium.ne_total_m3(r, lat, env)
    bm_b, f_b = torch.broadcast_tensors(bm, f)
    ne_b = ne.expand(bm_b.shape)
    gam = gamma_whistler(f_b, bm_b, ne_b, hot, psi=psi,
                         eta_he=float(env.eta_he), eta_o=float(env.eta_o))
    fce = FCE_E * bm_b
    return {
        "gamma": gam,
        "fce": fce,
        "f_cutoff": fce * hot.anisotropy / (1.0 + hot.anisotropy),
    }
