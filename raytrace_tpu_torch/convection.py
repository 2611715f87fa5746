"""Magnetospheric convection: the E x B drift of cold plasma, the derived
plasmapause and the energy-dependent Alfven layers (port of
raytrace_tpu/convection.py).

The cold-plasma E x B drift in the corotation + Volland-Stern
(Maynard-Chen) potential has its last closed equipotential through the
dusk stagnation point: the plasmapause teardrop. `plasmapause` finds
that contour, `lppi_derived` its MLT mean (a drop-in for the empirical
plasmasphere.lppi_from_kp as models/storm.py's lppi_fn), `lppi_at_mlt`
its radius at a local time, and `mlt_shape_fourier` fits its radius over
magnetic local time with a few Fourier harmonics, normalized to 1 at the
medium's base MLT, which models/medium.py multiplies the empirical
plasmapause by (make_env(ps_mlt=True)). `exb_drift`, `trace_drift_path`
and `erosion_times` integrate the drift itself; `electron_hamiltonian`
and `alfven_layer` add the gradient-curvature drift of equatorially
mirroring electrons at a fixed first invariant. The model and its
validation are the JAX module's.

Host-side NumPy float64 on grids of ~10^2 points, as in the JAX module:
these are once-per-run boundary solves, not loops for the card.

MLT angle convention: eastward from noon, so dusk = +pi/2 and dawn =
-pi/2.
"""

import math

import numpy as np

from .constants import B0_3D, C_LIGHT, M_E, Q_E, RE

# Earth's sidereal rotation rate [rad/s].
OMEGA_EARTH = 7.2921159e-5

# Corotation potential constant C_cor = Omega B0 RE^2 [V] (~92.4 kV).
C_COROTATION_V = OMEGA_EARTH * B0_3D * RE * RE

_MC2_J = M_E * C_LIGHT * C_LIGHT


def maynard_chen_a(kp):
    """Volland-Stern amplitude A(Kp) [V/RE^2] (Maynard & Chen 1975):
    A = 45 / (1 - 0.159 Kp + 0.0093 Kp^2)^3."""
    kp = np.asarray(kp, np.float64)
    denom = 1.0 - 0.159 * kp + 0.0093 * kp * kp
    return 45.0 / denom**3


def potential(l_shell, mlt_rad, kp, gamma_shield=2.0, corotation=True):
    """Total equatorial electric potential Phi [V] at (L, MLT angle):
    -A L^gamma sin(mlt) - C_cor / L (the corotation term optional)."""
    l = np.asarray(l_shell, np.float64)  # noqa: E741
    phi = np.asarray(mlt_rad, np.float64)
    a = maynard_chen_a(kp)
    v = -a * l**gamma_shield * np.sin(phi)
    if corotation:
        v = v - C_COROTATION_V / l
    return v


def exb_drift(l_shell, mlt_rad, kp, gamma_shield=2.0):
    """Cold-plasma E x B drift in the equatorial plane.

    Returns a dict with dl_dt [RE/s] and dphi_dt [rad/s] computed from
    v_E = (z_hat x grad Phi)/B with B = B0/L^3 northward:

      dphi/dt = (1/(L RE)) * (dPhi/dr) / B
      dL/dt   = -(1/(L RE)) * (dPhi/dphi) / (B RE)   [per RE]

    The corotation term alone gives dphi/dt = Omega_E exactly (tested);
    signs make eastward positive."""
    l = np.asarray(l_shell, np.float64)  # noqa: E741
    phi = np.asarray(mlt_rad, np.float64)
    a = maynard_chen_a(kp)
    b_t = B0_3D / l**3
    # dPhi/dr [V/m]: d/dr(-C/L) = C/(L^2 RE); convection term
    dphi_dr = (C_COROTATION_V / (l * l)
               - gamma_shield * a * l ** (gamma_shield - 1.0)
               * np.sin(phi)) / RE
    # dPhi/dphi [V/rad]
    dphi_dphi = -a * l**gamma_shield * np.cos(phi)
    return {
        "dphi_dt": dphi_dr / (l * RE * b_t),
        "dl_dt": -dphi_dphi / (l * RE * RE * b_t),
    }


def stagnation_point(kp, gamma_shield=2.0):
    """Dusk stagnation point of the cold-plasma flow, in closed form:
    L_s = (C_cor / (gamma A))^(1/(gamma+1)). Returns (L_s, Phi_s)."""
    a = maynard_chen_a(kp)
    l_s = (C_COROTATION_V / (gamma_shield * a)) ** (1.0 /
                                                    (gamma_shield + 1.0))
    phi_s = potential(l_s, 0.5 * math.pi, kp, gamma_shield)
    return float(l_s), float(phi_s)


def _contour_radius(value_fn, target, mlt, l_lo, l_hi, n_bisect=70):
    """Innermost radius where the monotone-bracketed value_fn(L, mlt)
    crosses target, per MLT (vectorized bisection)."""
    lo = np.full_like(mlt, l_lo, np.float64)
    hi = np.full_like(mlt, l_hi, np.float64)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        below = value_fn(mid, mlt) < target
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def plasmapause(kp, n_mlt=96, gamma_shield=2.0):
    """The last closed equipotential (the Phi = Phi_stag contour), one
    radius per cell-centered MLT angle. Returns dict(mlt_rad, l_pp,
    l_stag, l_mean). Along every meridian Phi rises monotonically up to
    L_s, so bisection on [0.05, L_s] finds the one root."""
    l_s, phi_s = stagnation_point(kp, gamma_shield)
    mlt = (np.arange(n_mlt) + 0.5) * (2.0 * math.pi / n_mlt) - math.pi

    def val(l, m):  # noqa: E741
        return potential(l, m, kp, gamma_shield)

    l_pp = _contour_radius(val, phi_s, mlt, 0.05, l_s)
    return {
        "mlt_rad": mlt,
        "l_pp": l_pp,
        "l_stag": l_s,
        "l_mean": float(l_pp.mean()),
    }


def mlt_shape_fourier(kp, mlt0_hours, n_harm=2, n_mlt=192,
                      gamma_shield=2.0):
    """Least-squares Fourier fit (n_harm harmonics) of the derived
    plasmapause radius over MLT, normalized to exactly 1 at the base MLT
    mlt0_hours, so the phi = 0 meridian of the traced medium is the
    axisymmetric medium.

    Returns (a0, coeffs): a0 the base angle (eastward from noon, rad;
    ang(phi) = a0 + phi along a ray), coeffs the (1 + 2 n_harm)-tuple
    (c0, c1, s1, c2, s2, ...) of
    S(ang) = c0 + sum_k [c_{2k-1} cos(k ang) + c_{2k} sin(k ang)]."""
    pp = plasmapause(kp, n_mlt=n_mlt, gamma_shield=gamma_shield)
    ang = pp["mlt_rad"]
    cols = [np.ones_like(ang)]
    for k in range(1, n_harm + 1):
        cols += [np.cos(k * ang), np.sin(k * ang)]
    a_mat = np.stack(cols, axis=1)
    c, *_ = np.linalg.lstsq(a_mat, pp["l_pp"], rcond=None)
    a0 = (float(mlt0_hours) - 12.0) * (math.pi / 12.0)
    base = c[0] + sum(
        c[2 * k - 1] * math.cos(k * a0) + c[2 * k] * math.sin(k * a0)
        for k in range(1, n_harm + 1)
    )
    c = c / base
    return a0, tuple(float(x) for x in c)


def lppi_derived(kp, n_mlt=64, gamma_shield=2.0):
    """MLT-mean last-closed-equipotential radius vs Kp: a drop-in,
    first-principles replacement for the empirical
    models/plasmasphere.lppi_from_kp (5.6 - 0.46 Kp). Accepts scalar or
    array Kp; pass as lppi_fn= to models/storm.py's history functions
    (plasmapause_history, refill_history, storm_sequence) to drive the
    storm-time plasmapause from drift physics instead of the CA1992
    fit (they agree to ~12% over Kp in [2, 6] -- tested)."""
    kp = np.asarray(kp, np.float64)
    flat = np.atleast_1d(kp).ravel()
    out = np.array([plasmapause(float(k), n_mlt=n_mlt,
                                gamma_shield=gamma_shield)["l_mean"]
                    for k in flat])
    return float(out[0]) if kp.ndim == 0 else out.reshape(kp.shape)


def lppi_at_mlt(kp, mlt_hours, n_mlt=96, gamma_shield=2.0):
    """Derived plasmapause radius at a specific magnetic local time.

    The CA1992 fit (and hence the traced medium's knee) is MLT-
    independent, but the real boundary is the teardrop: roughly
    1.5-1.7x farther out at dusk than dawn (the derived LCE gives
    dusk/dawn ~ 1.66 at Kp=3; the contour SHAPE is Kp-independent).
    mlt_hours uses the framework's convention
    (hours, 12 = noon, 18 = dusk; plasmasphere.jl:46 uses mlt=2).
    Scalar or array mlt_hours; returns the LCE radius there, so an
    MLT-local env can pin its knee via
    make_env(kp_max=(5.6 - L)/0.46) exactly as models/storm.py does."""
    pp = plasmapause(kp, n_mlt=n_mlt, gamma_shield=gamma_shield)
    ang = (np.asarray(mlt_hours, np.float64) - 12.0) * (math.pi / 12.0)
    ang = np.mod(ang + math.pi, 2.0 * math.pi) - math.pi
    # periodic interpolation on the cell-centered mlt grid
    grid = np.concatenate([pp["mlt_rad"] - 2.0 * math.pi, pp["mlt_rad"],
                           pp["mlt_rad"] + 2.0 * math.pi])
    vals = np.tile(pp["l_pp"], 3)
    out = np.interp(ang, grid, vals)
    return float(out) if np.ndim(mlt_hours) == 0 else out


def _gamma_rel(m_inv, b_t):
    """Relativistic gamma of an equatorially-mirroring particle with
    first invariant M = p_perp^2/(2 m B) in field B: p^2 = 2 m M B,
    gamma = sqrt(1 + p^2 c^2 / (m c^2)^2)."""
    p2c2 = 2.0 * M_E * m_inv * b_t * C_LIGHT * C_LIGHT
    return np.sqrt(1.0 + p2c2 / (_MC2_J * _MC2_J))


def electron_hamiltonian(l_shell, mlt_rad, m_inv, kp, gamma_shield=2.0):
    """Drift Hamiltonian H = gamma_rel m c^2 - e_signed Phi [J] for
    equatorially mirroring electrons (q = -e) at fixed first invariant
    m_inv [J/T]. Level sets are drift paths; M -> 0 reduces to the
    cold-plasma equipotentials (up to the constant rest energy)."""
    l = np.asarray(l_shell, np.float64)  # noqa: E741
    b_t = B0_3D / l**3
    phi_v = potential(l, mlt_rad, kp, gamma_shield)
    return _gamma_rel(m_inv, b_t) * _MC2_J + (-Q_E) * phi_v


def alfven_layer(e_kev, kp, gamma_shield=2.0, n_mlt=96, n_iter=40):
    """Energy-dependent last closed drift shell for equatorial electrons.

    e_kev is the particle kinetic energy AT the dusk stagnation point of
    its own layer (the natural label: M is then fixed self-consistently
    by M = p_perp^2(E)/(2 m B(L_s)), with L_s itself depending on M --
    solved by fixed-point iteration, which contracts because L_s grows
    slowly with M). Returns per energy (broadcast over e_kev):
      l_stag   -- dusk stagnation radius of the layer
      l_mean   -- MLT-averaged layer radius
      l_dawn   -- radius at dawn (the tightest constriction)
      m_inv    -- the converged first invariant [J/T]

    Electrons' gradient drift is eastward (with corotation), so the
    saddle stays at dusk and moves outward with energy; e_kev -> 0
    reproduces plasmapause() (tested)."""
    e_kev = np.atleast_1d(np.asarray(e_kev, np.float64))
    a = maynard_chen_a(kp)

    def p2_of_e(e_kev_arr):
        g = 1.0 + e_kev_arr * 1.0e3 * Q_E / _MC2_J
        return (g * g - 1.0) * _MC2_J * M_E  # p^2 = (gamma^2-1) m^2 c^2

    # dusk saddle: dH/dL = 0 with H(L) = gamma(M,B)mc^2 + e*A*L^g + e*C/L
    # dgamma/dL = (M/(gamma mc^2)) dB/dL = -3 M B /(gamma mc^2 L)
    def dusk_saddle(m_inv):
        # solve f(L) = dH/dL = -3 M B(L)/(gamma L) + e g A L^(g-1)
        #                      - e C/L^2 = 0
        # by bisection: f < 0 inside (H decreasing: eastward-trapped),
        # f > 0 outside. The hi bracket is deliberately far beyond any
        # physical magnetopause: the saddle scales like
        # L_s^2 ~ 3 E_kin/(2 e A), so a 100 keV electron at Kp=3 sits at
        # L_s ~ 27 -- a layer beyond ~10 RE simply means "trapped at
        # every local L" (only ~keV ring-current/plasma-sheet energies
        # have Alfven layers inside the magnetosphere).
        lo = np.full_like(m_inv, 1.5)
        hi = np.full_like(m_inv, 1.0e4)
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            b_t = B0_3D / mid**3
            g_rel = _gamma_rel(m_inv, b_t)
            f = (-3.0 * m_inv * b_t / (g_rel * mid)
                 + Q_E * gamma_shield * a * mid ** (gamma_shield - 1.0)
                 - Q_E * C_COROTATION_V / mid**2) / RE
            lo = np.where(f < 0.0, mid, lo)
            hi = np.where(f < 0.0, hi, mid)
        return 0.5 * (lo + hi)

    # fixed point: M from E at the current L_s, L_s from M
    l_s = np.full(e_kev.shape, stagnation_point(kp, gamma_shield)[0])
    m_inv = np.zeros_like(e_kev)
    for _ in range(n_iter):
        b_s = B0_3D / l_s**3
        m_inv = p2_of_e(e_kev) / (2.0 * M_E * b_s)
        l_s = dusk_saddle(m_inv)

    mlt = (np.arange(n_mlt) + 0.5) * (2.0 * math.pi / n_mlt) - math.pi
    h_sep = electron_hamiltonian(l_s, 0.5 * math.pi, m_inv, kp,
                                 gamma_shield)

    # H decreases inward along each meridian? H = gamma mc^2 - e Phi...
    # moving inward: gamma grows (B grows) and -e*Phi with Phi -> -inf
    # gives -e*Phi -> +inf... both INCREASE inward, so H > H_sep inside
    # and the contour is bracketed by H - H_sep crossing zero from
    # above: bisect on (H(L) - H_sep) decreasing in L near the root.
    l_layer = np.empty(e_kev.shape + mlt.shape)
    for i in np.ndindex(e_kev.shape):
        def val(l, m, _i=i):
            return -electron_hamiltonian(l, m, m_inv[_i], kp,
                                         gamma_shield)
        l_layer[i] = _contour_radius(val, -h_sep[i], mlt, 0.05,
                                     float(l_s[i]))

    dawn_idx = int(np.argmin(np.abs(mlt + 0.5 * math.pi)))
    return {
        "e_kev": e_kev,
        "l_stag": l_s,
        "l_mean": l_layer.mean(axis=-1),
        "l_dawn": l_layer[..., dawn_idx],
        "l_layer": l_layer,
        "mlt_rad": mlt,
        "m_inv": m_inv,
    }


def erosion_times(kp_quiet, kp_storm, n_mlt=24, l_escape=10.0,
                  t_max_s=48.0 * 3600.0, n_steps=6000,
                  gamma_shield=2.0):
    """Drift-kinematic plasmasphere stripping times after a Kp step.

    models/storm.py ASSUMES a fast-erosion relaxation time tau_erode
    ~ 3 h; this derives the same timescale from the drift physics.
    Parcels are seeded on the quiet-time plasmapause (the material
    boundary) at n_mlt local times; after Kp jumps to kp_storm they lie
    outside the new last closed equipotential, so the enhanced
    convection carries them sunward and out. The stripping time is the
    drift time to l_escape (a stand-in magnetopause) under the storm
    field. Nightside parcels must first corotate around to the dayside
    outflow path, so the MEDIAN time is a fraction of a corotation day
    -- hours, which is exactly the tau_erode scale storm.py quotes
    (tested: the derived median falls in the 1-12 h bracket and shrinks
    with storm strength).

    Parcels still inside the new LCE (weak steps) never escape and
    report +inf. A parcel whose trajectory goes non-finite (integrator
    blow-up, not physics) reports NaN in t_strip_s and is counted in
    n_diverged rather than folded into the stripped set. Returns dict:
    mlt_rad, t_strip_s, t_median_s, frac_stripped, n_diverged.

    All seeds advance together through one vectorized RK4 on the E x B
    field (exb_drift broadcasts over the parcel axis); escapers are
    frozen where they crossed and stamped with the crossing time."""
    pp_q = plasmapause(kp_quiet, n_mlt=n_mlt, gamma_shield=gamma_shield)
    t_strip = np.full(n_mlt, np.inf)
    dt = float(t_max_s) / n_steps
    l = pp_q["l_pp"].copy()  # noqa: E741
    phi = pp_q["mlt_rad"].copy()
    alive = np.ones(n_mlt, bool)

    def f(lv, pv):
        d = exb_drift(np.clip(lv, 1.0, l_escape + 1.0), pv, kp_storm,
                      gamma_shield)
        return d["dl_dt"], d["dphi_dt"]

    for i in range(n_steps):
        if not alive.any():
            break
        k1l, k1p = f(l, phi)
        k2l, k2p = f(l + 0.5 * dt * k1l, phi + 0.5 * dt * k1p)
        k3l, k3p = f(l + 0.5 * dt * k2l, phi + 0.5 * dt * k2p)
        k4l, k4p = f(l + dt * k3l, phi + dt * k3p)
        l = np.where(alive, l + (dt / 6.0) * (k1l + 2 * k2l + 2 * k3l
                                              + k4l), l)
        phi = np.where(alive, phi + (dt / 6.0) * (k1p + 2 * k2p + 2 * k3p
                                                  + k4p), phi)
        diverged = alive & ~np.isfinite(l)
        t_strip[diverged] = np.nan
        alive &= ~diverged
        crossed = alive & (l > l_escape)
        t_strip[crossed] = (i + 1) * dt
        alive &= ~crossed
    stripped = np.isfinite(t_strip)
    return {
        "mlt_rad": pp_q["mlt_rad"],
        "t_strip_s": t_strip,
        "t_median_s": (float(np.median(t_strip[stripped]))
                       if stripped.any() else math.inf),
        "frac_stripped": float(stripped.mean()),
        "n_diverged": int(np.isnan(t_strip).sum()),
    }


def trace_drift_path(l0, mlt0_rad, kp, t_span_s, n_steps=4000,
                     gamma_shield=2.0, l_escape=15.0):
    """Integrate one cold-plasma drift path (RK4, host-side).

    Returns dict of l, mlt_rad, t_s arrays plus escaped (bool) and
    n_valid. Paths inside the plasmapause close on themselves (tested:
    return to start); paths outside leave sunward -- once L exceeds
    l_escape (a stand-in for the magnetopause, where the dipole +
    Volland-Stern model has no authority anyway) the trajectory is
    frozen at its last value and escaped=True. Useful for plasmaspheric
    plume / erosion visualisation."""
    dt = float(t_span_s) / n_steps

    def rhs(y):
        d = exb_drift(y[0], y[1], kp, gamma_shield)
        return np.array([d["dl_dt"], d["dphi_dt"]], np.float64)

    y = np.array([float(l0), float(mlt0_rad)], np.float64)
    out = np.empty((n_steps + 1, 2))
    out[0] = y
    escaped = False
    n_valid = n_steps + 1
    for i in range(n_steps):
        k1 = rhs(y)
        k2 = rhs(y + 0.5 * dt * k1)
        k3 = rhs(y + 0.5 * dt * k2)
        k4 = rhs(y + dt * k3)
        y = y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        if not np.isfinite(y).all() or y[0] > l_escape or y[0] < 1.0:
            out[i + 1:] = out[i]
            escaped = True
            n_valid = i + 1
            break
        out[i + 1] = y
    t = np.arange(n_steps + 1) * dt
    return {"l": out[:, 0], "mlt_rad": out[:, 1], "t_s": t,
            "escaped": escaped, "n_valid": n_valid}
