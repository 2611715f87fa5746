"""Quasi-linear pitch-angle and momentum diffusion coefficients (port of
raytrace_tpu/diffusion.py).

D_aa, D_ap, D_pp of electrons resonating with field-aligned whistler
(n = +1) or EMIC (anomalous n = -1) waves of a truncated-Gaussian band,
locally (`local_coefficients`) and bounce-averaged over the framework's
dipole + plasmasphere medium (`bounce_averaged`), with the weak-diffusion
lifetime `loss_cone_lifetime_s`; the physics is the JAX module's
(tools/derive_diffusion.py).

The JAX module computes this chain twice: a numpy float64 oracle
(`local_coefficients`, `mirror_latitude`, `bounce_averaged`) and a
jittable mirror for the chip (`local_coefficients_jax`,
`mirror_latitude_jnp`, `bounce_averaged_jax`). This module is ONE
implementation of both, as torch ops on the device (placement.py: the
card unless the caller names another, float64 unless the caller's
tensors say otherwise): `local_coefficients` takes the mirror's
`momentum_units` ('si': kg m/s, the oracle's; 'mc': m_e c units, which
float32 needs -- p_SI^2 ~ 1e-44 underflows it in D_pp). The root search
always runs all max_roots x n_bisect steps: the oracle's early exit when
no batch row has a j-th root would cost a device sync per root, and the
absent roots are masked either way. The lattices (the band's n_grid
frequencies, the bounce quadrature's nodes) are built by numpy and
moved to the device, so they equal the oracle's to the bit.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from .constants import C_LIGHT, FCE_E, M_E, Q_E
from .constants import RE as _RE_M
from .growth import group_velocity_parallel
from .models import medium
from .ops import dispersion
from .placement import device_of, dtype_of, place, tensor

_TWO_PI = 2.0 * math.pi
_MC2_EV = M_E * C_LIGHT * C_LIGHT / Q_E      # electron rest energy, eV


@dataclass(frozen=True)
class WaveSpectrum:
    """Truncated-Gaussian wave magnetic power spectrum in frequency:
    |Bw|^2 as exp(-((f - f_m)/df)^2) between [f_lc, f_uc], normalized so
    the band integral of the spectral density is bw_t^2 (bw_t in T).
    directions: 'both' (power split evenly between the two directions
    along B0), 'forward' or 'backward'."""

    bw_t: float = 100.0e-12          # 100 pT
    f_m: float = 600.0               # Hz
    df: float = 300.0                # Hz
    f_lc: float = 100.0              # Hz
    f_uc: float = 2000.0             # Hz
    directions: str = "both"

    def _norm_w(self):
        """int exp(-((w - w_m)/dw)^2) dw over the band (rad/s)."""
        wm, dw = _TWO_PI * self.f_m, _TWO_PI * self.df
        lo = (_TWO_PI * self.f_lc - wm) / dw
        hi = (_TWO_PI * self.f_uc - wm) / dw
        return dw * (math.sqrt(math.pi) / 2.0) * (math.erf(hi) - math.erf(lo))

    def power_density(self, w, device=None):
        """W(w): T^2 per (rad/s); zero outside [w_lc, w_uc]."""
        (w,) = place(w, device=device)
        wm, dw = _TWO_PI * self.f_m, _TWO_PI * self.df
        inband = (w >= _TWO_PI * self.f_lc) & (w <= _TWO_PI * self.f_uc)
        g = torch.exp(-(((w - wm) / dw) ** 2))
        return torch.where(inband, self.bw_t**2 * g / self._norm_w(), 0.0)

    def direction_signs(self):
        if self.directions == "both":
            return ((1.0, 0.5), (-1.0, 0.5))
        if self.directions == "forward":
            return ((1.0, 1.0),)
        if self.directions == "backward":
            return ((-1.0, 1.0),)
        raise ValueError(f"unknown directions={self.directions!r}")


def spectrum_from_rays(f_hz, bw_t, df_floor_frac=0.05, band_pad=1.0,
                       directions="both", device=None):
    """Moment-matched WaveSpectrum from per-ray frequencies and (gain-
    weighted) amplitudes: bw_total^2 = sum bw_i^2, f_m and df the power-
    weighted mean and std (df floored at df_floor_frac f_m), the band
    [min f - band_pad df, max f + band_pad df] floored at df/10.
    Zero-amplitude rays are ignored; raises if there is no power."""
    f_hz, bw_t = place(f_hz, bw_t, device=device)
    f_hz = torch.atleast_1d(f_hz)
    bw_t = bw_t.expand(f_hz.shape)
    p = bw_t * bw_t
    p_tot = float(p.sum())
    if not p_tot > 0.0:
        raise ValueError("spectrum_from_rays: no wave power in the ray set")
    f_m = float((p * f_hz).sum() / p_tot)
    var = float((p * (f_hz - f_m) ** 2).sum() / p_tot)
    df = max(math.sqrt(var), df_floor_frac * f_m)
    sel = f_hz[p > 0.0]
    f_lc = max(float(sel.min()) - band_pad * df, 0.1 * df)
    f_uc = float(sel.max()) + band_pad * df
    return WaveSpectrum(bw_t=math.sqrt(p_tot), f_m=f_m, df=df, f_lc=f_lc,
                        f_uc=f_uc, directions=directions)


def _mu_r(f, bmag, ne_m3, eta_he=0.0, eta_o=0.0, mode="whistler"):
    """Cold parallel index mu(f) of the mode (the physical R branch, or
    L for 'emic') and its propagation mask."""
    idx = 0 if mode == "whistler" else 1
    m2 = dispersion.stix_rlp(ne_m3, bmag, f, eta_he, eta_o)[idx]
    ok = m2 > 0.0
    return torch.sqrt(torch.where(ok, m2, 1.0)), ok


def kinematics(e_kev, device=None):
    """Relativistic (gamma, v [m/s], p [kg m/s]) for kinetic energy E."""
    (e_kev,) = place(e_kev, device=device)
    gamma = 1.0 + e_kev * 1.0e3 / _MC2_EV
    beta = torch.sqrt(1.0 - 1.0 / (gamma * gamma))
    v = beta * C_LIGHT
    return gamma, v, gamma * M_E * v


def _lattice(values, like):
    """A numpy lattice as a tensor of like's device and dtype."""
    return torch.as_tensor(np.asarray(values, np.float64),
                           device=like.device).to(like.dtype)


def resonant_roots(e_kev, alpha_rad, bmag, ne_m3, spec: WaveSpectrum,
                   eta_he=0.0, eta_o=0.0, n_grid=512, n_bisect=30,
                   max_roots=3, mode="whistler", device=None):
    """Resonant frequencies of g(w) = w - k(w) vpar -+ wc/gamma = 0
    (mode 'whistler': n = +1 on the R branch; 'emic': n = -1 on the L
    branch), k(w) = s (w/c) mu(w) for each propagation direction s, over
    the band [w_lc, w_uc] only: sign changes on an n_grid lattice (both
    ends propagating), then n_bisect bisections per root. Inputs
    broadcast to a common shape S; returns a dict of tensors shaped
    (n_dir, max_roots) + S: w (NaN where absent), k (signed parallel
    wavenumber), weight (direction power fraction), valid (bool)."""
    e_kev, alpha_rad, bmag, ne_m3 = torch.broadcast_tensors(
        *place(e_kev, alpha_rad, bmag, ne_m3, device=device))
    shape = e_kev.shape
    gamma, v, _ = kinematics(e_kev)
    vpar = v * torch.cos(alpha_rad)
    res_sign = 1.0 if mode == "whistler" else -1.0   # n = +1 vs n = -1
    wc_rel = res_sign * _TWO_PI * FCE_E * bmag / gamma   # +-wc/gamma

    wgrid = _lattice(np.linspace(_TWO_PI * spec.f_lc, _TWO_PI * spec.f_uc,
                                 n_grid), e_kev)

    def g_of(w, sign):
        mu, ok = _mu_r(w / _TWO_PI, bmag, ne_m3, eta_he, eta_o, mode)
        k = sign * (w / C_LIGHT) * mu
        return w - k * vpar - wc_rel, ok

    dirs = spec.direction_signs()
    w_out, k_out, wt_out, ok_out = [], [], [], []
    wg = wgrid.reshape((n_grid,) + (1,) * len(shape))
    for sign, wt in dirs:
        gg, pk = g_of(wg, sign)                       # (n_grid,) + S
        # sign changes on segments where both endpoints propagate
        seg = (gg[:-1] * gg[1:] < 0.0) & pk[:-1] & pk[1:]
        rank = torch.cumsum(seg, dim=0) - 1
        for j in range(max_roots):
            sel = seg & (rank == j)
            has = sel.any(dim=0)
            idx = torch.argmax(sel.to(torch.uint8), dim=0)   # first True
            lo = wgrid[idx]
            hi = wgrid[torch.clamp(idx + 1, max=n_grid - 1)]
            glo, _ = g_of(lo, sign)
            for _ in range(n_bisect):
                mid = 0.5 * (lo + hi)
                gmid, _ = g_of(mid, sign)
                left = (glo * gmid) <= 0.0
                hi = torch.where(left, mid, hi)
                lo = torch.where(left, lo, mid)
                glo = torch.where(left, glo, gmid)
            wj = 0.5 * (lo + hi)
            mu_j, ok_j = _mu_r(wj / _TWO_PI, bmag, ne_m3, eta_he, eta_o,
                               mode)
            valid = has & ok_j
            w_out.append(torch.where(valid, wj, math.nan))
            k_out.append(torch.where(valid, sign * (wj / C_LIGHT) * mu_j,
                                     0.0))
            wt_out.append(valid.to(e_kev.dtype) * wt)
            ok_out.append(valid)

    def stack(xs):
        return torch.stack(xs).reshape((len(dirs), max_roots) + shape)

    return {"w": stack(w_out), "k": stack(k_out), "weight": stack(wt_out),
            "valid": stack(ok_out)}


def local_coefficients(e_kev, alpha_rad, bmag, ne_m3, spec: WaveSpectrum,
                       eta_he=0.0, eta_o=0.0, jac_floor=1.0e-3,
                       mode="whistler", momentum_units="si", device=None,
                       **root_kw):
    """Local quasi-linear D_aa [rad^2/s], D_ap and D_pp at one point of the
    medium; arrays broadcast. The JAX package's local_coefficients (the
    numpy oracle) and local_coefficients_jax (the chip path) in one.

    mode: 'whistler' (R mode, n = +1) or 'emic' (L mode, anomalous
    n = -1). jac_floor clamps |1 - vpar/vg| (the tangent resonance).
    momentum_units: 'si' (D_ap in rad kg m/s /s, D_pp in (kg m/s)^2 /s,
    the oracle's) or 'mc' (per m_e c: D_ap in rad/s, D_pp in 1/s; use it
    in float32). root_kw: n_grid, n_bisect, max_roots of resonant_roots.
    Returns dict daa, dap, dpp, n_roots (int64), shaped S."""
    if momentum_units not in ("si", "mc"):
        raise ValueError(f"unknown momentum_units={momentum_units!r}")
    e_kev, alpha_rad, bmag, ne_m3 = torch.broadcast_tensors(
        *place(e_kev, alpha_rad, bmag, ne_m3, device=device))
    gamma, v, p = kinematics(e_kev)
    if momentum_units == "mc":
        p = gamma * (v / C_LIGHT)
    vpar = v * torch.cos(alpha_rad)
    sina = torch.sin(alpha_rad)
    roots = resonant_roots(e_kev, alpha_rad, bmag, ne_m3, spec,
                           eta_he, eta_o, mode=mode, **root_kw)
    wj, kj, wt, ok = (roots[x] for x in ("w", "k", "weight", "valid"))
    wj_safe = torch.where(ok, wj, 1.0)
    kj_safe = torch.where(ok, kj, 1.0)

    vg = group_velocity_parallel(wj_safe / _TWO_PI, bmag, ne_m3,
                                 mode, eta_he, eta_o)
    vg_signed = torch.sign(kj_safe) * vg
    jac = torch.abs(1.0 - vpar / torch.where(vg_signed == 0.0, math.inf,
                                             vg_signed))
    jac = torch.clamp(jac, min=jac_floor)

    phase = wj_safe / (kj_safe * v)                  # w/(k v), signed
    amp = 1.0 - phase * torch.cos(alpha_rad)
    pref = (math.pi / 2.0) * (Q_E / (gamma * M_E)) ** 2
    daa_j = torch.where(
        ok, pref * wt * spec.power_density(wj_safe) * amp * amp / jac, 0.0)
    qj = torch.where(
        ok, phase * sina / torch.where(amp == 0.0, math.inf, amp), 0.0)

    daa = daa_j.sum(dim=(0, 1))
    dap = (-qj * daa_j).sum(dim=(0, 1)) * p
    dpp = (qj * qj * daa_j).sum(dim=(0, 1)) * p * p
    return {"daa": daa, "dap": dap, "dpp": dpp,
            "n_roots": ok.sum(dim=(0, 1))}


def daa_local(e_kev, alpha_rad, bmag, ne_m3, spec: WaveSpectrum, **kw):
    """Local pitch-angle diffusion coefficient D_aa [rad^2/s]."""
    return local_coefficients(e_kev, alpha_rad, bmag, ne_m3, spec, **kw)["daa"]


# ---------------------------------------------------------------------------
# bounce averaging over the framework's dipole + plasmasphere medium
# ---------------------------------------------------------------------------

def mirror_latitude(alpha_eq_rad, n_bisect=60, device=None):
    """Dipole mirror latitude: sin^2 a_eq sqrt(1+3 sin^2 l) = cos^6 l, by
    bisection on [0, pi/2 - 1e-6]."""
    (a,) = place(alpha_eq_rad, device=device)
    s2 = torch.sin(a) ** 2
    lo = torch.zeros_like(s2)
    hi = torch.full_like(s2, 0.5 * math.pi - 1.0e-6)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        up = (s2 * torch.sqrt(1.0 + 3.0 * torch.sin(mid) ** 2)
              - torch.cos(mid) ** 6) >= 0.0
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid)
    return 0.5 * (lo + hi)


def bounce_nodes(lam_m, n_lat):
    """The bounce quadrature: lam = lam_m sin(x) at the n_lat midpoints x
    of [0, pi/2] (the substitution kills the mirror point's inverse
    square root). Returns (lam, dlam), shaped lam_m.shape + (n_lat,)."""
    x = (np.arange(n_lat) + 0.5) * (0.5 * math.pi / n_lat)
    lam = lam_m[..., None] * _lattice(np.sin(x), lam_m)
    dlam = lam_m[..., None] * _lattice(np.cos(x), lam_m) \
        * (0.5 * math.pi / n_lat)
    return lam, dlam


def bounce_averaged(e_kev, alpha_eq_rad, l_shell, env, spec: WaveSpectrum,
                    lat_cut_deg=None, n_lat=96, device=None, **kw):
    """Bounce-averaged <D_aa_eq>, <D_ap>, <D_pp> at equatorial pitch angle
    alpha_eq on the dipole line L, with B and ne from models.medium on
    the same EnvParams the tracer integrates:

        <D> = (1/S) int_0^lam_m D(lam) J(lam) dlam / (v |cos a(lam)|),

    J = L cos(lam) sqrt(1+3 sin^2 lam), D_aa mapped to the equatorial
    pitch angle by (tan a_eq / tan a)^2 (D_ap by its square root). The JAX
    package's bounce_averaged (the oracle) and bounce_averaged_jax (the
    chip path) in one. lat_cut_deg confines the wave power to
    |lam| <= cut. kw passes to local_coefficients (jac_floor, mode,
    momentum_units, n_grid, n_bisect, max_roots).

    Returns dict daa, dap, dpp, tau_b [s] (full bounce period),
    mirror_lat_rad, shaped as e_kev and alpha_eq broadcast, and n_roots:
    the resonant roots summed over the n_lat nodes in the wave region (a
    count the JAX functions do not return)."""
    e_kev, alpha_eq = torch.broadcast_tensors(
        *place(e_kev, alpha_eq_rad, device=device))
    gamma, v, _ = kinematics(e_kev)
    lam_m = mirror_latitude(alpha_eq)
    lam, dlam = bounce_nodes(lam_m, n_lat)

    slat, clat = torch.sin(lam), torch.cos(lam)
    b_ratio = torch.sqrt(1.0 + 3.0 * slat * slat) / clat**6
    s2a = torch.clamp(torch.sin(alpha_eq[..., None]) ** 2 * b_ratio, 0.0,
                      1.0)
    sina = torch.sqrt(s2a)
    cosa = torch.sqrt(torch.clamp(1.0 - s2a, min=0.0))

    l_shell = tensor(l_shell, e_kev.device, e_kev.dtype)
    r = l_shell * clat * clat
    bm = medium.b_mag(r, torch.abs(lam), env)
    ne = medium.ne_total_m3(r, torch.abs(lam), env)

    jarc = l_shell * clat * torch.sqrt(1.0 + 3.0 * slat * slat) * _RE_M

    alpha_loc = torch.arcsin(torch.clamp(sina, 0.0, 1.0))
    coeff = local_coefficients(
        e_kev[..., None].expand(lam.shape), alpha_loc, bm, ne, spec,
        eta_he=float(getattr(env, "eta_he", 0.0)),
        eta_o=float(getattr(env, "eta_o", 0.0)), **kw)

    if lat_cut_deg is not None:
        inwave = torch.rad2deg(torch.abs(lam)) <= float(lat_cut_deg)
    else:
        inwave = torch.ones_like(lam, dtype=torch.bool)

    cosa_safe = torch.clamp(cosa, min=1.0e-12)
    wline = jarc * dlam / cosa_safe                   # ds / |cos a|
    s_norm = wline.sum(dim=-1)

    tana_eq = torch.tan(torch.clamp(alpha_eq, 1.0e-9, math.pi / 2 - 1.0e-9))
    tana = sina / cosa_safe
    chain = (tana_eq[..., None] / torch.clamp(tana, min=1.0e-12)) ** 2

    out = {}
    for key, mapfac in (("daa", chain), ("dap", torch.sqrt(chain)),
                        ("dpp", torch.ones_like(chain))):
        d = torch.where(inwave, coeff[key], 0.0)
        out[key] = (d * mapfac * wline).sum(dim=-1) / s_norm
    # full bounce = 4 quarter-bounces; v constant along the line
    out["tau_b"] = 4.0 * s_norm / v
    out["mirror_lat_rad"] = lam_m
    out["n_roots"] = torch.where(inwave, coeff["n_roots"], 0).sum(dim=-1)
    return out


def loss_cone_lifetime_s(e_kev, l_shell, env, spec: WaveSpectrum,
                         r_loss=1.0, device=None, **kw):
    """Weak-diffusion electron lifetime tau ~ 1/<D_aa>(a_LC), a_LC the
    dipole loss cone for mirror radius r_loss [RE]: sin^2 a_LC =
    (r_loss/L)^3 / sqrt(4 - 3 r_loss/L). inf where no resonance on the
    bounce path (the wave model sets no lifetime)."""
    dev = device_of(e_kev, l_shell, device=device)
    dt = dtype_of(e_kev, l_shell)
    l_shell = tensor(l_shell, dev, dt)
    rl = r_loss / l_shell
    s2 = rl**3 / torch.sqrt(4.0 - 3.0 * rl)
    a_lc = torch.arcsin(torch.sqrt(torch.clamp(s2, 0.0, 1.0)))
    ba = bounce_averaged(tensor(e_kev, dev, dt), a_lc, l_shell, env, spec,
                         **kw)
    daa = ba["daa"]
    pos = daa > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, daa, 1.0), math.inf)
