"""Whistler observables: dispersion analysis of traced ensembles (port of
raytrace_tpu/analysis.py, NumPy out).

What whistler receivers measure is the frequency-time curve of the
arriving signal. For ducted or field-aligned propagation below the nose
frequency the group delay follows the Eckersley law T(f) ~ D0 / sqrt(f),
with the dispersion D0 = T sqrt(f) (s Hz^1/2) about constant over the low
band. This module turns the tracer's multi-frequency ensembles into those
observables (`dispersion_measure`, `fit_eckersley`, `hop_delays`), the
footprint of a fan (`landing_footprint`, `count_equator_crossings`,
`footprint_spreading`), and the medium's resonance surfaces along a path
(`f_lhr`, `cyclotron_resonance_energy_ev`, `kp_critical_anisotropy`,
`resonance_profile_2d_lat`, `count_lat_reversals`).

Everything is NumPy in float64 on the host, as in the JAX package; the
two functions that read the medium (`f_lhr`, `resonance_profile_2d_lat`)
evaluate the port's models.medium density and |B| as float64 torch ops
on the device the caller names (the card unless the caller asks for the
CPU) and bring the values back.
"""

import numpy as np
import torch

from .constants import C_LIGHT, FCE_E, FCE_P, M_E, Q_E
from .integrate import events
from .models import medium
from .ops.dispersion import stix_rlp


def _medium_values(r, lat, env, phi=None, device="cuda"):
    """(ne [m^-3], |B| [T]) at (r, lat[, phi]) as float64 numpy arrays,
    evaluated by models.medium on `device`."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    ne = medium.ne_total_m3(t(r), t(lat), env,
                            phi=None if phi is None else t(phi))
    bm = medium.b_mag(t(r), t(lat), env)
    return ne.cpu().numpy(), bm.cpu().numpy()


def dispersion_measure(T, f):
    """Eckersley dispersion D = T sqrt(f) (s Hz^1/2) per ray."""
    return np.asarray(T) * np.sqrt(np.asarray(f))


def fit_eckersley(T, f, status=None):
    """Least-squares Eckersley fit over a frequency sweep.

    Model T(f) = D0 / sqrt(f). Returns dict with
      d0           -- fitted dispersion (s Hz^1/2),
      rms_rel      -- rms relative residual of T (how well the band obeys
                      the law; < ~0.1 in the classic low-band regime),
      n_used       -- rays in the fit (surface hits only when status
                      given).
    """
    T = np.asarray(T, np.float64)
    f = np.asarray(f, np.float64)
    keep = np.isfinite(T) & (T > 0)
    if status is not None:
        keep &= np.asarray(status) == events.HIT_EARTH
    T, f = T[keep], f[keep]
    if T.size == 0:
        return {"d0": np.nan, "rms_rel": np.nan, "n_used": 0}
    w = 1.0 / np.sqrt(f)
    # min over d0 of sum (T - d0 w)^2  ->  d0 = (w.T) / (w.w)
    d0 = float(np.dot(w, T) / np.dot(w, w))
    resid = T - d0 * w
    return {
        "d0": d0,
        "rms_rel": float(np.sqrt(np.mean((resid / T) ** 2))),
        "n_used": int(T.size),
    }


def cyclotron_resonance_energy_ev(f, bmag, ne_m3, eta_he=0.0, eta_o=0.0,
                                  relativistic=False):
    """Minimum electron energy (eV) in first-order cyclotron resonance
    with a parallel whistler: v_R = c (fce/f - 1) / mu_parallel, with
    mu_parallel = sqrt(R) taken from THIS framework's own cold
    dispersion (no high-density approximation). This is the energy of
    the electrons a whistler can scatter/amplify -- the quantity
    radiation-belt wave models evaluate along the ray. In the
    dense-plasma limit it reduces to the textbook
    E_B (fce/f)(1 - f/fce)^3 with E_B = B^2/(2 mu0 ne).

    relativistic=True solves the exact minimum-energy (v_perp = 0)
    relativistic resonance  w - k v = wce/gamma  instead: with
    x = v/c and n = mu_parallel, squaring gives the quadratic
        (n^2 + Y^2) x^2 - 2 n x + (1 - Y^2) = 0,   Y = fce/f > 1,
    whose |x| < 1 branch is x = (n - sqrt(n^2 - (1+Y^2)(1-Y^2)... )) --
    written below via the numerically stable form. E = (gamma - 1) m c^2.
    The nonrelativistic expression overestimates E_res once it
    approaches m_e c^2 = 511 keV (the classic correction for outer-belt
    electrons); below ~50 keV the two agree to < 5%."""
    f = np.asarray(f, np.float64)
    bmag = np.asarray(bmag, np.float64)
    ne_m3 = np.asarray(ne_m3, np.float64)
    r, _, _ = stix_rlp(ne_m3, bmag, f, eta_he, eta_o)
    mu2 = np.maximum(np.asarray(r, np.float64), 1.0e-30)
    fce = FCE_E * bmag
    if not relativistic:
        v_r2 = C_LIGHT * C_LIGHT * (fce / f - 1.0) ** 2 / mu2
        return 0.5 * M_E * v_r2 / Q_E
    # exact (v_perp = 0): (n^2 + Y^2) x^2 - 2 n x + (1 - Y^2) = 0.
    # For Y > 1 the product of roots (1 - Y^2)/(n^2 + Y^2) < 0; the
    # physical counter-streaming root has |x| < 1 and is obtained
    # stably as c_term / (quadratic-formula big root):
    n = np.sqrt(mu2)
    y = fce / f
    a_q = n * n + y * y
    c_q = 1.0 - y * y
    disc = np.maximum(n * n - a_q * c_q, 0.0)
    big = n + np.sqrt(disc)                 # > 0 always
    x = c_q / big                           # Vieta: x1 x2 = c_q/a_q
    x = np.clip(np.abs(x), 0.0, 1.0 - 1e-15)
    gamma_rel = 1.0 / np.sqrt(1.0 - x * x)
    return (gamma_rel - 1.0) * M_E * C_LIGHT * C_LIGHT / Q_E


def kp_critical_anisotropy(f, bmag):
    """Kennel-Petschek critical temperature anisotropy A_c = f/(fce - f):
    a parallel whistler at f grows only where the resonant electrons'
    anisotropy A = T_perp/T_par - 1 exceeds A_c (Kennel & Petschek 1966).
    Exact threshold, no distribution model needed."""
    fce = FCE_E * np.asarray(bmag, np.float64)
    return np.asarray(f, np.float64) / (fce - f)


def f_lhr(r, lat, env, iters=52, phi=None, device="cuda"):
    """Lower-hybrid resonance frequency at (r, lat): the S = 0 root of
    the framework's own Stix coefficients (S = (R + L)/2) above every
    ion gyrofrequency. For an MLT-resolved medium (ps_mlt=True), pass
    phi (the medium longitude: magnetic longitude for non-dipole
    fields, see medium.mlon_3d) to evaluate the surface in that
    local-time sector; phi=None uses the phi = 0 anchor meridian.

    This is the surface unducted whistlers magnetospherically reflect
    from (Kimura 1966; Bortnik's thesis -- the lineage the reference's
    3D script cites at RayTrace_3D.jl:5): where the wave's frequency
    drops to the local f_LHR the refractive-index surface closes and the
    ray mirrors instead of precipitating. The reference never computes
    it; here it is derived from the SAME stix_rlp the tracer integrates
    (multi-ion general -- He+/O+ fractions shift the root), by log-space
    bisection on [1.5 f_cH+, 1.2 sqrt(f_ce f_cH+ + f_cH+^2)], a bracket
    that contains exactly the LH root (all ion-ion hybrid roots lie
    below the proton gyrofrequency). Vectorizes over r/lat; float64
    recommended. In the proton-only dense limit this reduces to the
    textbook f_LHR ~ sqrt(f_ce f_cH+). The medium is evaluated on
    `device`."""
    ne, bm = _medium_values(r, lat, env, phi, device)
    eta_he, eta_o = float(env.eta_he), float(env.eta_o)

    def s_of(f):
        rr, ll, _ = stix_rlp(ne, bm, f, eta_he, eta_o)
        return np.asarray(0.5 * (rr + ll))

    fcp = FCE_P * bm
    fce = FCE_E * bm
    lo = np.log(1.5 * fcp)                      # S < 0 (proton pole side)
    hi = np.log(1.2 * np.sqrt(fce * fcp + fcp * fcp))   # S > 0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = s_of(np.exp(mid)) < 0.0
        lo = np.where(neg, mid, lo)
        hi = np.where(neg, hi, mid)
    return np.exp(0.5 * (lo + hi))


def count_lat_reversals(traj_u, r_min=1.05):
    """Latitude turning points of recorded trajectories while airborne.

    traj_u: (S, B, state) snapshots ((S, state) for one ray). Returns
    (n_reversals (B,), indices list per ray) counting sign changes of
    d(lat)/d(step) at snapshots with r > r_min -- the mirror-bounce
    count of a magnetospherically reflecting whistler. Latitude is
    state 1 in the lat frame (pass colatitude trajectories as-is: a
    colat turning point is a latitude turning point)."""
    u = np.asarray(traj_u, np.float64)
    squeeze = u.ndim == 2
    if squeeze:
        u = u[:, None, :]
    n_rev, idx_all = [], []
    for b in range(u.shape[1]):
        lat, r = u[:, b, 1], u[:, b, 0]
        dl = np.diff(lat)
        sgn = np.sign(dl)
        sgn[sgn == 0.0] = 1.0
        rev = np.nonzero(np.abs(np.diff(sgn)) > 1.0)[0] + 1
        rev = rev[r[rev] > r_min]
        n_rev.append(len(rev))
        idx_all.append(rev)
    if squeeze:
        return n_rev[0], idx_all[0]
    return np.asarray(n_rev), idx_all


def resonance_profile_2d_lat(traj_u, f, env, device="cuda"):
    """(E_res [eV], A_c, fce [Hz]) along recorded 2D-lat trajectories.

    traj_u: (S, B, 4) snapshots (or (S, 4) for one ray); f scalar or
    (B,). Evaluates the local medium at every snapshot -- where E_res
    dips (usually the equator crossing, the |B| minimum of the path) is
    where the wave exchanges energy with the softest electrons and where
    the KP threshold is lowest. The medium is evaluated on `device`."""
    u = np.asarray(traj_u, np.float64)
    squeeze = u.ndim == 2
    if squeeze:
        u = u[:, None, :]
    ne, bm = _medium_values(u[..., 0], u[..., 1], env, device=device)
    f = np.broadcast_to(np.asarray(f, np.float64), bm.shape)
    e_res = cyclotron_resonance_energy_ev(f, bm, ne, float(env.eta_he),
                                          float(env.eta_o))
    a_c = kp_critical_anisotropy(f, bm)
    out = {"e_res_ev": e_res, "a_crit": a_c, "fce_hz": FCE_E * bm}
    if squeeze:
        out = {k: v[:, 0] for k, v in out.items()}
    return out


def hop_delays(result, f, valid=None, group_idx=-1):
    """One-hop travel times of the surface-hitting rays.

    Returns (f_hit, T_hit): the frequency and group delay of every valid
    ray that reached the conjugate surface -- the one-hop whistler; the
    n-hop echo train arrives at odd multiples (1, 3, 5, ...) x T for a
    source-side receiver and even multiples for the conjugate side.
    group_idx: index of the group-delay channel in the state (default:
    last)."""
    u = np.asarray(result.u)
    status = np.asarray(result.status)
    f = np.asarray(f)
    keep = status == events.HIT_EARTH
    if valid is not None:
        keep &= np.asarray(valid)
    return f[keep], u[keep, group_idx]


def landing_footprint(u0, f, result, valid=None, frame="2d_lat"):
    """Conjugate-point table: launch -> landing mapping per ray.

    The observable a ground-based whistler receiver network works with
    (the reference plots single trajectories; ensembles make the
    footprint a first-class product): for every valid ray,

      launch_lat  magnetic latitude at launch (rad)
      freq_hz     wave frequency
      status      terminal events.* code
      hit         True where the ray reached the surface
      landing_lat magnetic latitude of the surface intercept (rad; only
                  meaningful where hit)
      landing_l   dipole L of the landing field line r/cos^2(lat)
      group_delay one-hop travel time (s; only meaningful where hit)
      conjugate   True where the ray landed in the opposite hemisphere
                  (canonical mid-latitude whistlers land near the
                  equator on either side; the flag plus
                  count_equator_crossings' parity classifies the path
                  topology)

    frame: '2d_lat' | '2d_colat' | '3d' (colatitude frames convert
    state[1] via lat = pi/2 - theta; the 3D frame reports geographic
    latitude -- for tilted/IGRF media convert with medium.mlat_3d)."""
    u0 = np.asarray(u0)
    uf = np.asarray(result.u)
    status = np.asarray(result.status)
    f = np.asarray(f)
    n = u0.shape[0]
    keep = np.ones(n, bool) if valid is None else np.asarray(valid)
    sign, off = (1.0, 0.0) if frame == "2d_lat" else (-1.0, np.pi / 2)
    lat0 = sign * u0[:, 1] + off
    lat1 = sign * uf[:, 1] + off
    hit = (status == events.HIT_EARTH) & keep
    g_idx = 6 if frame == "3d" else 3
    return {
        "launch_lat": lat0[keep],
        "freq_hz": np.broadcast_to(f, (n,))[keep],
        "status": status[keep],
        "hit": hit[keep],
        "landing_lat": lat1[keep],
        "landing_l": uf[keep, 0] / np.cos(lat1[keep]) ** 2,
        "group_delay_s": uf[keep, g_idx],
        "conjugate": (np.sign(lat1) != np.sign(lat0))[keep],
    }


def count_equator_crossings(traj_u, frame="2d_lat"):
    """Magnetic-equator crossings per ray from recorded snapshots.

    The magnetospherically-reflected (MR) whistler diagnostic. Parity
    invariant: the count is odd iff the ray lands in the conjugate
    hemisphere; even counts mean it turned back into its launch
    hemisphere (the canonical 45-deg ray reflects southward past the
    equator and returns -- 2 crossings, landing at +2.7 deg). Counts
    sign changes of latitude along the snapshot axis; the frozen post-
    termination tail contributes none (the state stops changing).

    traj_u: (S, B, n) (or (S, n) for one ray). Snapshot cadence bounds
    resolution: crossings closer than one save interval merge."""
    u = np.asarray(traj_u)
    squeeze = u.ndim == 2
    if squeeze:
        u = u[:, None, :]
    sign, off = (1.0, 0.0) if frame == "2d_lat" else (-1.0, np.pi / 2)
    lat = sign * u[..., 1] + off
    s = np.sign(lat)
    # a snapshot exactly at 0 inherits the previous side (no double count)
    for i in range(1, s.shape[0]):
        z = s[i] == 0.0
        s[i][z] = s[i - 1][z]
    crossings = (s[1:] * s[:-1] < 0).sum(axis=0)
    return crossings[0] if squeeze else crossings


def footprint_spreading(fp, param, r_land=1.0):
    """Macroscopic ray-tube spreading along a 1-D launch fan.

    Adjacent rays of a fan bound a ray tube; with power conserved in the
    tube, the landing amplitude scales as 1/sqrt(spreading), where
    spreading is the landing-arc growth per unit launch parameter. This
    is the geometric (focusing/defocusing) part of the whistler
    amplitude budget -- the part that is pure ray geometry and needs no
    hot-plasma model (growth/damping along the path is out of scope;
    see ROADMAP).

    Deliberately a FINITE-WINDOW secant over adjacent fan rays, not the
    variational tangent: the landing map carries microscopic folds that
    make the infinitesimal tangent ~1e4 x larger than the macroscopic
    tube response (sensitivity.py module docstring) -- a receiver
    integrates over the macroscopic tube, so the fan secant is the
    physical number here.

    fp:     landing_footprint() dict of a fan ORDERED along the fan axis
            (e.g. a chi scan at fixed launch lat and frequency).
    param:  (B,) launch parameter per ray, same order (rad for chi/lat
            fans).
    r_land: landing radius in RE (r_floor; 1.0 for surface hits).

    Returns a dict over adjacent pairs where BOTH rays hit:
      param_mid      midpoint of the launch parameter
      spreading      |d(landing arc)/d(param)| = r_land |dlat_land/dp|
      rel_amplitude  1/sqrt(spreading), normalized to its fan maximum
    (2D meridional tube; a full 3D amplitude adds the azimuthal
    spreading factor of the frame.)"""
    param = np.asarray(param, float)
    lat1 = np.asarray(fp["landing_lat"], float)
    hit = np.asarray(fp["hit"], bool)
    if param.shape != lat1.shape:
        raise ValueError("param must align with the footprint rays")
    ok = hit[1:] & hit[:-1]
    dp = np.abs(np.diff(param))[ok]
    if np.any(dp == 0.0):
        raise ValueError("duplicate launch parameters in the fan")
    spreading = r_land * np.abs(np.diff(lat1))[ok] / dp
    rel = 1.0 / np.sqrt(np.maximum(spreading, 1e-300))
    rel_max = rel.max() if rel.size else 1.0
    return {
        "param_mid": (0.5 * (param[1:] + param[:-1]))[ok],
        "spreading": spreading,
        "rel_amplitude": rel / rel_max,
    }
