"""Composite propagation medium: geomagnetic field + electron density.

Port of raytrace_tpu/models/medium.py: the centered dipole (the 2D
frames' |B| and the 3D frame's vector field), the tilted dipole and the
degree-3 IGRF truncation of the 3D frame (with the magnetic latitude and
longitude of their tilted frame, which organize the density models) and
the whole density medium -- the ionosphere (one fit, or
the day/night blend), the CA1992 plasmasphere (hard or sigmoid-smoothed
plasmapause, optional trough refill) or the simplified GCPM, the
field-aligned duct, the optional diffusive-equilibrium factor, and the
MLT-resolved plasmasphere of the 3D frame (the plasmapause follows the
drift-derived teardrop and the trough a day-night modulation in
longitude), and the ion composition (He+ and O+ fractions of the
electron density, the protons carrying the rest). `EnvParams` keeps every
field of the JAX package's NamedTuple (so a JAX `EnvParams._asdict()`
converts field for field, see interop.py).

The scalars are Python floats. A tensor op with a Python float operand
computes in the tensor's dtype, which is what the JAX package's cast_env
does for float32 runs.
"""

import math
from typing import NamedTuple

import torch

from ..constants import B0_2D, B0_3D
from . import dipole, ionosphere, plasmasphere


class EnvParams(NamedTuple):
    """All-scalar medium parameters (field names as in the JAX package)."""

    b0: float                        # equatorial surface field, T
    iono_n0: float                   # ionosphere fit amplitude, cm^-3
    iono_decay: float                # ionosphere fit decay, 1/RE
    iono_r0: float                   # ionosphere fit offset, RE
    ps_weight: float                 # plasmasphere weight: 1.0 on, 0.0 off
    lppi: float                      # plasmapause inner limit, L
    lppo: float                      # plasmapause outer limit, L
    ne_lppi: float                   # branch-1 density at Lppi, cm^-3
    ps_season: float                 # CA1992 seasonal/solar coefficient
    ps_trough: float                 # 5800 + 300 mlt
    de_weight: float                 # diffusive-equilibrium weight (1.0 on)
    ps_smooth: float = 0.0           # > 0: sigmoid plasmapause width, L
    iono_n0_b: float = 0.0           # nightside fit amplitude, cm^-3
    iono_decay_b: float = 0.0        # nightside fit decay, 1/RE
    iono_mix: float = 1.0            # dayside weight; 1.0 = one fit
    ps_model: str = "ca1992"         # "ca1992" | "gcpm"
    gcpm_ne0: float = 0.0            # GCPM density at L = 2, cm^-3
    gcpm_lscale: float = 0.0         # GCPM e-folding scale in L
    gcpm_bpow: float = 0.0           # GCPM mirror-ratio exponent
    gcpm_knee: float = 0.0           # GCPM plasmapause blend width, L
    b_model: str = "dipole"
    b_tilt: float = 0.0
    b_tilt_phi: float = 0.0
    duct_amp: float = 0.0            # duct crest (> 0) / trough (< 0)
    duct_l0: float = 0.0             # duct center, L
    duct_w: float = 0.0              # duct Gaussian width, L
    igrf_coeffs: tuple = ()
    eta_he: float = 0.0
    eta_o: float = 0.0
    ps_refill: float = 0.0           # trough refill weight in [0, 1]
    ps_refill_q: float = 0.0         # tau(L) ~ L^q; 0 = global weight
    ps_refill_lref: float = 4.0      # shell where ps_refill applies
    ps_mlt: float = 0.0              # 1.0 = MLT-resolved plasmasphere
    ps_mlt_a0: float = 0.0           # base angle (mlt0 - 12) pi/12, rad
    ps_mlt_c: tuple = ()             # Fourier shape (c0, c1, s1, ...)
    ps_mlt_tamp: float = 0.0         # trough day-night half-amplitude
    ps_mlt_c3: float = 0.0           # log10 trough density at the base knee


def make_env(
    b0=B0_3D,
    iono_fit=ionosphere.TRACED_FIT,
    plasmasphere_on=True,
    kp_max=3.0,
    day=0.0,
    rbar=90.0,
    mlt=2.0,
    de_correction=False,
    ps_smooth=0.0,
    iono_mlt=False,
    ps_model="ca1992",
    gcpm_bpow=1.0,
    gcpm_knee=plasmasphere.GCPM_KNEE,
    b_model="dipole",
    b_tilt=0.0,
    b_tilt_phi=0.0,
    igrf_coeffs=None,
    duct_amp=0.0,
    duct_l0=3.0,
    duct_w=0.1,
    eta_he=0.0,
    eta_o=0.0,
    ps_refill=0.0,
    ps_refill_q=0.0,
    ps_refill_lref=4.0,
    ps_mlt=False,
    ps_mlt_harmonics=3,
    ps_mlt_tamp=1800.0,
):
    """Build EnvParams; runs the host-side plasmapause pre-solve.

    Defaults reproduce the canonical reference run (plasmasphere.jl:42-46):
    Kp_max=3 (Lppi=4.22), d=0, Rbar=90, mlt=2. The switches and their
    refusals are the JAX package's:
      - iono_mlt=True blends the IRI dayside and nightside fits by the
        smooth MLT weight of `mlt`;
      - ps_model="gcpm" selects the simplified GCPM (exponential decay in
        L times the mirror ratio to the power gcpm_bpow, joined to the
        CA1992 trough at Lppo by a sigmoid of width gcpm_knee);
      - ps_smooth > 0 smooths the CA1992 plasmapause, ps_refill refills
        its trough (per L with ps_refill_q > 0), duct_amp != 0 adds a
        Gaussian duct at duct_l0 of width duct_w;
      - ps_mlt=True makes the plasmasphere MLT-resolved in the 3D frame:
        the plasmapause rides a ps_mlt_harmonics-harmonic Fourier fit of
        the drift-derived teardrop (convection.mlt_shape_fourier),
        anchored at this env's mlt, and the trough a day-night
        modulation of half-amplitude ps_mlt_tamp; the 2D frames trace its
        phi = 0 meridian, the axisymmetric medium;
      - b_model="tilted" tilts the dipole moment by b_tilt (rad) from -z
        toward geographic longitude b_tilt_phi; b_model="igrf" takes the
        degree-3 IGRF truncation (igrf_coeffs, 15 Schmidt coefficients in
        nT, IGRF-13 epoch 2020 by default), whose degree-1 part replaces
        b0 and sets b_tilt and b_tilt_phi. Both are 3D-frame-only; the
        density models and the MLT axis ride the tilted frame's magnetic
        latitude and longitude (mlat_3d, mlon_3d);
      - eta_he, eta_o are the He+ and O+ fractions of the electron
        density (>= 0, their sum < 1; the protons carry the rest), which
        the Stix sums of ops/dispersion.py and ops/fused.py take."""
    lppi = plasmasphere.lppi_from_kp(kp_max)
    lppo, ne_lppi = plasmasphere.initialize_plasmasphere(lppi, day, rbar, mlt)
    if iono_mlt:
        day_fit = ionosphere.IRI_DAYSIDE_FIT
        night_fit = ionosphere.IRI_NIGHTSIDE_FIT
        iono_kw = dict(
            iono_n0=day_fit[0], iono_decay=day_fit[1], iono_r0=day_fit[2],
            iono_n0_b=night_fit[0], iono_decay_b=night_fit[1],
            iono_mix=float(ionosphere.day_weight(mlt)),
        )
    else:
        iono_kw = dict(
            iono_n0=iono_fit[0], iono_decay=iono_fit[1], iono_r0=iono_fit[2],
        )
    if ps_model not in ("ca1992", "gcpm"):
        raise ValueError(f"unknown ps_model {ps_model!r}")
    if duct_amp != 0.0:
        if not plasmasphere_on:
            raise ValueError("a density duct needs the plasmasphere on")
        if not duct_w > 0.0:
            raise ValueError("duct_w must be > 0 when duct_amp != 0")
        if duct_amp <= -1.0:
            raise ValueError("duct_amp <= -1 makes the density negative")
    if eta_he < 0.0 or eta_o < 0.0 or eta_he + eta_o >= 1.0:
        raise ValueError(
            "ion fractions must satisfy 0 <= eta_he, eta_o and "
            "eta_he + eta_o < 1 (protons carry the rest)"
        )
    if not 0.0 <= ps_refill <= 1.0:
        raise ValueError("ps_refill must lie in [0, 1]")
    if ps_refill != 0.0 and ps_model != "ca1992":
        raise ValueError("ps_refill blends the CA1992 trough only")
    if ps_refill_q < 0.0 or ps_refill_lref <= 0.0:
        raise ValueError(
            "ps_refill_q must be >= 0 and ps_refill_lref > 0"
        )
    if b_model not in ("dipole", "tilted", "igrf"):
        raise ValueError(f"unknown b_model {b_model!r}")
    mlt_kw = {}
    if ps_mlt:
        if not plasmasphere_on:
            raise ValueError(
                "ps_mlt modulates the plasmapause; it needs "
                "plasmasphere_on=True"
            )
        from .. import convection

        a0, coeffs = convection.mlt_shape_fourier(
            kp_max, mlt, n_harm=int(ps_mlt_harmonics)
        )
        if ps_model == "ca1992":
            # base-knee trough log-density: the branch-2/branch-3 crossing
            # log10 ne3(lppo) = g1(lppi) - (lppo - lppi)/0.1 with (lppi,
            # lppo) from the pre-solve, so that lppo(phi = 0) == lppo
            g1_lppi = float(plasmasphere._branch1_log10(
                float(lppi), plasmasphere.season_coeff(day, rbar)))
            c3 = float(g1_lppi - 10.0 * (lppo - lppi))
        else:
            # GCPM scales its knee directly: no continuity constant
            c3 = 0.0
        mlt_kw = dict(
            ps_mlt=1.0,
            ps_mlt_a0=float(a0),
            ps_mlt_c=coeffs,
            ps_mlt_tamp=float(ps_mlt_tamp),
            ps_mlt_c3=c3,
        )
    if b_model == "tilted":
        b_kw = dict(b_model="tilted", b_tilt=float(b_tilt),
                    b_tilt_phi=float(b_tilt_phi))
    elif b_model == "igrf":
        coeffs = tuple(
            float(c) for c in
            (dipole.IGRF13_2020 if igrf_coeffs is None else igrf_coeffs)
        )
        if len(coeffs) != 15:
            raise ValueError("igrf_coeffs must hold 15 Schmidt coefficients")
        # the degree-1 part is a tilted centered dipole: it gives b0 and
        # the magnetic-latitude organization of the density models
        b0, tilt, phi0 = dipole.igrf_dipole(coeffs)
        b_kw = dict(b_model="igrf", b_tilt=tilt, b_tilt_phi=phi0,
                    igrf_coeffs=coeffs)
    else:
        b_kw = {}
    gcpm_kw = (
        dict(
            ps_model="gcpm",
            gcpm_ne0=plasmasphere.GCPM_NE0,
            gcpm_lscale=plasmasphere.GCPM_LSCALE,
            gcpm_bpow=float(gcpm_bpow),
            gcpm_knee=float(gcpm_knee),
        )
        if ps_model == "gcpm"
        else {}
    )
    env = EnvParams(
        b0=float(b0),
        ps_weight=1.0 if plasmasphere_on else 0.0,
        lppi=lppi,
        lppo=lppo,
        ne_lppi=ne_lppi,
        ps_season=plasmasphere.season_coeff(day, rbar),
        ps_trough=5800.0 + 300.0 * mlt,
        de_weight=1.0 if de_correction else 0.0,
        ps_smooth=float(ps_smooth),
        **{k: float(v) for k, v in iono_kw.items()},
        **gcpm_kw,
        **b_kw,
        duct_amp=float(duct_amp),
        duct_l0=float(duct_l0),
        duct_w=float(duct_w),
        eta_he=float(eta_he),
        eta_o=float(eta_o),
        ps_refill=float(ps_refill),
        ps_refill_q=float(ps_refill_q),
        ps_refill_lref=float(ps_refill_lref),
        **mlt_kw,
    )
    return env


def make_env_raymain():
    """Medium of RayMain.jl: legacy B0, ionosphere only (RayMain.jl:150-154)."""
    return make_env(b0=B0_2D, plasmasphere_on=False)


def make_env_lat():
    """Medium of RayTrace_lat.jl: legacy B0, ionosphere + CA1992."""
    return make_env(b0=B0_2D, plasmasphere_on=True)


def mlt_on(env: EnvParams):
    """Static gate of the MLT-resolved plasmasphere."""
    return env.ps_mlt != 0.0


def _mlt_shape(phi, env: EnvParams):
    """The local-time structure shared by the CA1992 and GCPM MLT media:
    the Fourier plasmapause shape S(a0 + phi) with its phi-slope, and the
    day-night trough with its phi-slope. Harmonics by angle recursion:
    one sin and one cos, whatever the harmonic count. cos(a0) is an env
    scalar formed on the host. With no harmonic the shape is the constant
    c0, a tensor of phi's shape without a tangent (the JAX package's
    Python float, which its tensor ops take). Returns (shape, dshape,
    trough_e, dtrough)."""
    c = env.ps_mlt_c
    n_harm = (len(c) - 1) // 2
    ang = env.ps_mlt_a0 + phi
    s1a, c1a = torch.sin(ang), torch.cos(ang)
    sk, ck = s1a, c1a
    dshape = torch.zeros_like(s1a)
    shape = c[0] if n_harm else dshape + c[0]
    for k in range(1, n_harm + 1):
        if k > 1:
            sk, ck = sk * c1a + ck * s1a, ck * c1a - sk * s1a
        shape = shape + c[2 * k - 1] * ck + c[2 * k] * sk
        dshape = dshape + k * (c[2 * k] * ck - c[2 * k - 1] * sk)
    trough_e = env.ps_trough + env.ps_mlt_tamp * (
        c1a - math.cos(env.ps_mlt_a0)
    )
    dtrough = -env.ps_mlt_tamp * s1a
    return shape, dshape, trough_e, dtrough


def mlt_ps_params(phi, env: EnvParams, with_grads=False):
    """Effective CA1992 parameters (lppi, lppo, ne_lppi, trough_c) at
    longitude phi of an MLT-resolved medium:
      lppi(phi)    = lppi S(a0 + phi)          (S(a0) == 1)
      ne_lppi(phi) = 10^g1(lppi(phi))          (branch-1 continuity)
      lppo(phi)    = lppi(phi) + 0.1 (g1(lppi(phi)) - ps_mlt_c3)
      trough(phi)  = ps_trough + tamp (cos(a0 + phi) - cos a0)
    with_grads=True also returns (dlppi, dlppo, dg1i, dtrough)/dphi, dg1i
    the phi-slope of g1(lppi(phi))."""
    shape, dshape, trough_e, dtrough = _mlt_shape(phi, env)
    lppi_e = env.lppi * shape
    dlppi = env.lppi * dshape
    e_i = torch.exp((2.0 - lppi_e) / 1.5)
    g1i = (-0.3145 * lppi_e + 3.9043) + env.ps_season * e_i
    dg1i = (-0.3145 - env.ps_season * e_i / 1.5) * dlppi
    ne_lppi_e = torch.exp(plasmasphere.LN10 * g1i)
    lppo_e = lppi_e + 0.1 * (g1i - env.ps_mlt_c3)
    dlppo = dlppi + 0.1 * dg1i
    params = (lppi_e, lppo_e, ne_lppi_e, trough_e)
    if with_grads:
        return params, (dlppi, dlppo, dg1i, dtrough)
    return params


def mlt_gcpm_params(phi, env: EnvParams, with_grads=False):
    """Effective GCPM parameters (lppo, trough_c) at longitude phi of an
    MLT-resolved GCPM medium: the knee center rides the same teardrop,
    lppo(phi) = lppo S(a0 + phi), and the trough the same day-night
    modulation. with_grads=True also returns their phi-slopes."""
    shape, dshape, trough_e, dtrough = _mlt_shape(phi, env)
    lppo_e = env.lppo * shape
    if with_grads:
        return (lppo_e, trough_e), (env.lppo * dshape, dtrough)
    return lppo_e, trough_e


def ne_total_m3(r, lat, env: EnvParams, phi=None):
    """Total electron density in m^-3 at (r [RE], lat [rad]).

    ne = (ne_iono(r) + w_ps * DE?(duct(L) * ne_plasma(L))) * 1e6, the
    composition of RayTrace_lat.jl:70-83 (DE variant plasmasphere.jl:171).
    phi: longitude (rad) for the MLT-resolved plasmasphere, which the 3D
    frame passes; without it (the 2D frames) the medium is its phi = 0
    meridian, the axisymmetric parameters."""
    ne_i = ionosphere.ne_iono_cm3(r, env.iono_n0, env.iono_decay, env.iono_r0)
    if env.iono_mix != 1.0:
        ne_i = env.iono_mix * ne_i + (1.0 - env.iono_mix) * (
            ionosphere.ne_iono_cm3(r, env.iono_n0_b, env.iono_decay_b,
                                   env.iono_r0)
        )
    L = dipole.l_shell(r, lat)
    if env.ps_model == "gcpm":
        if mlt_on(env) and phi is not None:
            lppo_e, trough_e = mlt_gcpm_params(phi, env)
        else:
            lppo_e, trough_e = env.lppo, env.ps_trough
        ne_p = plasmasphere.ne_gcpm_cm3(
            L, lat, lppo_e, trough_e, env.gcpm_ne0, env.gcpm_lscale,
            env.gcpm_bpow, env.gcpm_knee,
        )
    else:
        if mlt_on(env) and phi is not None:
            lppi_e, lppo_e, ne_lppi_e, trough_e = mlt_ps_params(phi, env)
        else:
            lppi_e, lppo_e = env.lppi, env.lppo
            ne_lppi_e, trough_e = env.ne_lppi, env.ps_trough
        ne_p = plasmasphere.ne_plasma_cm3(
            L, lppi_e, lppo_e, ne_lppi_e, env.ps_season, trough_e,
            env.ps_smooth, env.ps_refill, env.ps_refill_q,
            env.ps_refill_lref,
        )
    if env.duct_amp != 0.0:
        ne_p = ne_p * plasmasphere.duct_factor(
            L, env.duct_amp, env.duct_l0, env.duct_w
        )
    de = plasmasphere.diffusive_equilibrium_factor(r)
    ne_p = ne_p * (env.de_weight * de + (1.0 - env.de_weight))
    return (ne_i + env.ps_weight * ne_p) * 1.0e6


def require_dipole_2d(env: EnvParams):
    """The 2D frames assume the centered axial dipole (a tilted field has
    no meridional symmetry): tilted and IGRF media are 3D-only."""
    if env.b_model != "dipole":
        raise ValueError(
            "the 2D frames assume the centered axial dipole; "
            f"b_model={env.b_model!r} is 3D-only"
        )


def b_mag(r, lat, env: EnvParams):
    """Dipole field magnitude at (r [RE], lat [rad]) in Tesla: the 2D
    (meridional) entry point, which refuses the non-axial fields."""
    require_dipole_2d(env)
    return dipole.b_mag_lat(r, lat, env.b0)


def b_vec(r, theta, phi, env: EnvParams):
    """Vector field (B_r, B_theta, B_phi) at geographic (r, theta, phi),
    by the static b_model selector."""
    if env.b_model == "tilted":
        return dipole.b_vec_tilted(r, theta, phi, env.b0, env.b_tilt,
                                   env.b_tilt_phi)
    if env.b_model == "igrf":
        return dipole.b_vec_igrf(r, theta, phi, env.igrf_coeffs)
    return dipole.b_vec_colat(r, theta, phi, env.b0)


def mlat_3d(r, theta, phi, env: EnvParams):
    """Magnetic latitude at geographic (r, theta, phi), which organizes
    the density models in the 3D frame: pi/2 - theta for the centered
    dipole, the tilted frame's latitude otherwise (for "igrf" the tilt of
    its degree-1 part, set by make_env)."""
    if env.b_model in ("tilted", "igrf"):
        return dipole.magnetic_coords(theta, phi, env.b_tilt,
                                      env.b_tilt_phi)[0]
    return math.pi / 2.0 - theta


def mlon_3d(r, theta, phi, env: EnvParams):
    """Magnetic longitude at geographic (r, theta, phi), the MLT axis of
    the density models in the 3D frame: phi itself for the centered
    dipole, the tilted frame's azimuth (dipole.mlon_tilted) for
    tilted/IGRF: the plasmasphere's local-time structure rides the
    field."""
    if env.b_model in ("tilted", "igrf"):
        return dipole.mlon_tilted(theta, phi, env.b_tilt, env.b_tilt_phi)
    return phi
