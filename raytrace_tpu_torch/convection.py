"""The derived plasmapause shape (port of the part of
raytrace_tpu/convection.py that the MLT-resolved medium needs).

The cold-plasma E x B drift in the corotation + Volland-Stern
(Maynard-Chen) potential has its last closed equipotential through the
dusk stagnation point: the plasmapause teardrop. `mlt_shape_fourier`
fits that contour's radius over magnetic local time with a few Fourier
harmonics, normalized to 1 at the medium's base MLT, and
models/medium.py multiplies the empirical plasmapause by it
(make_env(ps_mlt=True)). Host-side NumPy float64, once per medium.

MLT angle convention: eastward from noon, so dusk = +pi/2 and dawn =
-pi/2. The drift paths, Alfven layers and the other convection
solvers of the JAX package are not ported (ROADMAP A14).
"""

import math

import numpy as np

from .constants import B0_3D, RE

# Earth's sidereal rotation rate [rad/s].
OMEGA_EARTH = 7.2921159e-5

# Corotation potential constant C_cor = Omega B0 RE^2 [V] (~92.4 kV).
C_COROTATION_V = OMEGA_EARTH * B0_3D * RE * RE


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
