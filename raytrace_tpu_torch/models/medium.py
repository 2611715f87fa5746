"""Composite propagation medium: dipole B-field + electron density.

Port of raytrace_tpu/models/medium.py for the axisymmetric feature set:
the centered dipole (the 2D frames' |B| and the 3D frame's vector field
with its magnetic latitude and longitude), the single ionosphere fit, the
CA1992 plasmasphere with hard branches, and the optional
diffusive-equilibrium factor.
`EnvParams` keeps every field of the JAX package's NamedTuple (so a JAX
`EnvParams._asdict()` converts field for field, see interop.py), but a
medium whose static gates select a feature not ported yet raises
NotImplementedError naming the ROADMAP item that ports it.

The scalars are Python floats. A tensor op with a Python float operand
computes in the tensor's dtype, which is what the JAX package's cast_env
does for float32 runs.
"""

import math
from typing import NamedTuple

from ..constants import B0_2D, B0_3D
from . import dipole, ionosphere, plasmasphere


class EnvParams(NamedTuple):
    """All-scalar medium parameters (field names as in the JAX package)."""

    b0: float                        # equatorial surface field, T
    iono_n0: float                   # ionosphere fit amplitude, cm^-3
    iono_decay: float                # ionosphere fit decay, 1/RE
    iono_r0: float                   # ionosphere fit offset, RE
    ps_weight: float                 # 1.0 = plasmasphere on, 0.0 = off
    lppi: float                      # plasmapause inner limit, L
    lppo: float                      # plasmapause outer limit, L
    ne_lppi: float                   # branch-1 density at Lppi, cm^-3
    ps_season: float                 # CA1992 seasonal/solar coefficient
    ps_trough: float                 # 5800 + 300 mlt
    de_weight: float                 # 1.0 = diffusive-equilibrium correction
    ps_smooth: float = 0.0
    iono_n0_b: float = 0.0
    iono_decay_b: float = 0.0
    iono_mix: float = 1.0
    ps_model: str = "ca1992"
    gcpm_ne0: float = 0.0
    gcpm_lscale: float = 0.0
    gcpm_bpow: float = 0.0
    gcpm_knee: float = 0.0
    b_model: str = "dipole"
    b_tilt: float = 0.0
    b_tilt_phi: float = 0.0
    duct_amp: float = 0.0
    duct_l0: float = 0.0
    duct_w: float = 0.0
    igrf_coeffs: tuple = ()
    eta_he: float = 0.0
    eta_o: float = 0.0
    ps_refill: float = 0.0
    ps_refill_q: float = 0.0
    ps_refill_lref: float = 4.0
    ps_mlt: float = 0.0
    ps_mlt_a0: float = 0.0
    ps_mlt_c: tuple = ()
    ps_mlt_tamp: float = 0.0
    ps_mlt_c3: float = 0.0


# (field, value that keeps the ported feature set, ROADMAP item that
# ports the other values)
_GATES = (
    ("ps_smooth", 0.0, "A8 (sigmoid-smoothed plasmapause)"),
    ("iono_mix", 1.0, "A8 (day/night ionosphere)"),
    ("ps_model", "ca1992", "A8 (GCPM plasmasphere)"),
    ("duct_amp", 0.0, "A8 (field-aligned duct)"),
    ("eta_he", 0.0, "A10 (multi-ion composition)"),
    ("eta_o", 0.0, "A10 (multi-ion composition)"),
    ("ps_refill", 0.0, "A8 (trough refill)"),
    ("ps_mlt", 0.0, "A8 (MLT-resolved plasmasphere)"),
    ("b_model", "dipole", "A9 (tilted and IGRF fields)"),
)


def check_env(env: EnvParams):
    """Raise NotImplementedError if a static gate selects an unported
    feature; also require the plasmasphere and DE weights to be 0 or 1."""
    for name, ok, item in _GATES:
        if getattr(env, name) != ok:
            raise NotImplementedError(
                f"{name}={getattr(env, name)!r} is not ported yet "
                f"(ROADMAP {item}); the port takes {name}={ok!r}"
            )
    for name in ("ps_weight", "de_weight"):
        if getattr(env, name) not in (0.0, 1.0):
            raise NotImplementedError(
                f"{name} must be 0 or 1 in the port; got {getattr(env, name)!r}"
            )


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
    b_model="dipole",
    duct_amp=0.0,
    duct_l0=3.0,
    duct_w=0.1,
    eta_he=0.0,
    eta_o=0.0,
    ps_refill=0.0,
    ps_refill_q=0.0,
    ps_refill_lref=4.0,
    ps_mlt=False,
):
    """Build EnvParams; runs the host-side plasmapause pre-solve.

    Defaults reproduce the canonical reference run (plasmasphere.jl:42-46):
    Kp_max=3 (Lppi=4.22), d=0, Rbar=90, mlt=2. The feature switches of the
    JAX package's make_env are accepted at their defaults only; the
    fields they leave inert (duct_l0, duct_w, ps_refill_q, ps_refill_lref)
    take the JAX package's values, so the two EnvParams agree field for
    field."""
    if iono_mlt:
        raise NotImplementedError(
            "iono_mlt=True is not ported yet (ROADMAP A8 (day/night "
            "ionosphere))"
        )
    env = EnvParams(
        b0=float(b0),
        iono_n0=float(iono_fit[0]),
        iono_decay=float(iono_fit[1]),
        iono_r0=float(iono_fit[2]),
        ps_weight=1.0 if plasmasphere_on else 0.0,
        lppi=0.0, lppo=0.0, ne_lppi=0.0, ps_season=0.0, ps_trough=0.0,
        de_weight=1.0 if de_correction else 0.0,
        ps_smooth=float(ps_smooth),
        ps_model=ps_model,
        b_model=b_model,
        duct_amp=float(duct_amp),
        duct_l0=float(duct_l0),
        duct_w=float(duct_w),
        eta_he=float(eta_he),
        eta_o=float(eta_o),
        ps_refill=float(ps_refill),
        ps_refill_q=float(ps_refill_q),
        ps_refill_lref=float(ps_refill_lref),
        ps_mlt=1.0 if ps_mlt else 0.0,
    )
    check_env(env)
    lppi = plasmasphere.lppi_from_kp(kp_max)
    lppo, ne_lppi = plasmasphere.initialize_plasmasphere(lppi, day, rbar, mlt)
    return env._replace(
        lppi=lppi,
        lppo=lppo,
        ne_lppi=ne_lppi,
        ps_season=plasmasphere.season_coeff(day, rbar),
        ps_trough=5800.0 + 300.0 * mlt,
    )


def make_env_lat():
    """Medium of RayTrace_lat.jl: legacy B0, ionosphere + CA1992."""
    return make_env(b0=B0_2D, plasmasphere_on=True)


def ne_total_m3(r, lat, env: EnvParams):
    """Total electron density in m^-3 at (r [RE], lat [rad]).

    ne = (ne_iono(r) + w_ps * DE?(ne_plasma(L))) * 1e6, the composition
    of RayTrace_lat.jl:70-83 (DE variant plasmasphere.jl:171)."""
    check_env(env)
    ne_i = ionosphere.ne_iono_cm3(r, env.iono_n0, env.iono_decay, env.iono_r0)
    L = dipole.l_shell(r, lat)
    ne_p = plasmasphere.ne_plasma_cm3(
        L, env.lppi, env.lppo, env.ne_lppi, env.ps_season, env.ps_trough,
    )
    de = plasmasphere.diffusive_equilibrium_factor(r)
    ne_p = ne_p * (env.de_weight * de + (1.0 - env.de_weight))
    return (ne_i + env.ps_weight * ne_p) * 1.0e6


def b_mag(r, lat, env: EnvParams):
    """Dipole field magnitude at (r [RE], lat [rad]) in Tesla."""
    check_env(env)
    return dipole.b_mag_lat(r, lat, env.b0)


def b_vec(r, theta, phi, env: EnvParams):
    """Vector field (B_r, B_theta, B_phi) at (r, theta, phi): the centered
    dipole (the tilted and IGRF fields are ROADMAP A9)."""
    check_env(env)
    return dipole.b_vec_colat(r, theta, phi, env.b0)


def mlat_3d(r, theta, phi, env: EnvParams):
    """Magnetic latitude at (r, theta, phi): pi/2 - theta for the
    centered dipole."""
    check_env(env)
    return math.pi / 2.0 - theta


def mlon_3d(r, theta, phi, env: EnvParams):
    """Magnetic longitude at (r, theta, phi): phi for the centered
    dipole."""
    check_env(env)
    return phi
