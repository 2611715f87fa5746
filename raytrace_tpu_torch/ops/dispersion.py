"""Cold-plasma (Stix) dispersion for whistler and EMIC waves, 2D and 3D
frames.

Port of raytrace_tpu/ops/dispersion.py. Solves A mu^4 - B mu^2 + C = 0 in
the ratio form X = f_p^2/f^2, Y = f_c/f over the electrons and the ion
species present (protons, and He+ and O+ where their fractions are not
0), with R, L, P normalized by s = max(|R|, |L|, |P|) and the stable
product root 2C/(B -+ F) where the direct form cancels. root=+1 is the
whistler branch, root=-1 the EMIC branch. mu = sqrt(|mu^2|), the
reference's abs() guard (RayMain.jl:213). Elementwise over any batch
shape.
"""

import math

import torch

from ..constants import (
    FCE_E, FCE_HE, FCE_O, FCE_P, FPE2_E, FPE2_HE, FPE2_O, FPE2_P,
)
from ..models import dipole, medium


def ion_species(eta_he=0.0, eta_o=0.0):
    """[(fpe2 coefficient * fraction, fce coefficient), ...] of the ion
    species present under quasi-neutrality n_e = n_p + n_He + n_O: the
    protons with the rest, then He+ and O+ unless their fraction is 0.0.
    Python floats, formed in double (the step kernel casts them)."""
    species = [(FPE2_P * (1.0 - eta_he - eta_o), FCE_P)]
    if eta_he != 0.0:
        species.append((FPE2_HE * eta_he, FCE_HE))
    if eta_o != 0.0:
        species.append((FPE2_O * eta_o, FCE_O))
    return species


def stix_rlp(ne_m3, bmag, f, eta_he=0.0, eta_o=0.0):
    """Stix R, L, P for a quasi-neutral plasma of electrons and the ion
    species of ion_species (RayMain.jl:156-176 in ratio form)."""
    n_cm3 = ne_m3 * 1.0e-6
    f2 = f * f
    xe = FPE2_E * n_cm3 / f2
    ye = FCE_E * bmag / f
    r = 1.0 - xe / (1.0 - ye)
    l = 1.0 - xe / (1.0 + ye)  # noqa: E741
    p = 1.0 - xe
    for fpe2_i, fce_i in ion_species(eta_he, eta_o):
        xi = fpe2_i * n_cm3 / f2
        yi = fce_i * bmag / f
        r = r - xi / (1.0 + yi)
        l = l - xi / (1.0 - yi)  # noqa: E741
        p = p - xi
    return r, l, p


def mu2_signed(r, l, p, psi, root=1.0):  # noqa: E741
    """Signed mu^2 of the selected root at wave-normal angle psi.

    root=+1: whistler branch (B+F); root=-1: EMIC branch (B-F). A
    negative value means the wave is evanescent there."""
    return mu2_signed_trig(r, l, p, torch.sin(psi), torch.cos(psi), root)


def mu2_signed_trig(r, l, p, sinpsi, cospsi, root=1.0):  # noqa: E741
    """Signed mu^2 of the selected root from (sin psi, cos psi).

    root=+1: whistler branch (B+F); root=-1: EMIC branch (B-F)."""
    s = torch.maximum(torch.maximum(torch.abs(r), torch.abs(l)), torch.abs(p))
    rn, ln, pn = r / s, l / s, p / s
    dn = 0.5 * (rn - ln)
    sn = 0.5 * (rn + ln)
    sin2 = sinpsi * sinpsi
    cos2 = cospsi * cospsi
    a = sn * sin2 + pn * cos2
    b = rn * ln * sin2 + pn * sn * (1.0 + cos2)
    c = pn * rn * ln
    rl_ps = rn * ln - pn * sn
    f2 = rl_ps * rl_ps * sin2 * sin2 + 4.0 * (pn * dn * cospsi) ** 2
    fdisc = torch.sqrt(f2)
    direct = (b + root * fdisc) / (2.0 * a)
    product = 2.0 * c / (b - root * fdisc)
    mu2n = torch.where(root * b >= 0.0, direct, product)
    return s * mu2n


def mu_from_mu2(mu2):
    """mu = sqrt(|mu^2|) -- the reference's abs() guard (RayMain.jl:213)."""
    return torch.sqrt(torch.abs(mu2))


def psi_lat(lat, chi):
    """psi = pi/2 + dip + chi, dip = atan(2 tan lat)
    (RayTrace_lat.jl:47-50): the angle itself, which the reference's
    closed-form dmu/dpsi takes (ops/analytic.py)."""
    return math.pi / 2.0 + dipole.dip_angle_lat(lat) + chi


def psi_colat(theta, chi):
    """psi = pi/2 + dip + chi, dip = atan(2 cot theta) (RayMain.jl:128-131):
    the colatitude frame's angle, which its diagnostics record."""
    return math.pi / 2.0 + dipole.dip_angle_colat(theta) + chi


def psi_trig_lat(lat, chi):
    """(sin psi, cos psi) for psi = pi/2 + dip + chi without inverse trig
    (dip = atan(2 tan lat); RayTrace_lat.jl:47-50)."""
    sl, cl = torch.sin(lat), torch.cos(lat)
    q = torch.sqrt(1.0 + 3.0 * sl * sl)
    sindip = 2.0 * sl / q
    cosdip = cl / q
    sc, cc = torch.sin(chi), torch.cos(chi)
    sinpsi = cosdip * cc - sindip * sc
    cospsi = -(sindip * cc + cosdip * sc)
    return sinpsi, cospsi


def mu_2d_lat(r, lat, chi, f, env: medium.EnvParams, root=1.0):
    """Phase refractive index at (r [RE], lat, chi, f [Hz])
    (phase_refractive_index, RayTrace_lat.jl:44-194)."""
    sinpsi, cospsi = psi_trig_lat(lat, chi)
    ne = medium.ne_total_m3(r, lat, env)
    b = medium.b_mag(r, lat, env)
    rr, ll, pp = stix_rlp(ne, b, f, env.eta_he, env.eta_o)
    return mu_from_mu2(mu2_signed_trig(rr, ll, pp, sinpsi, cospsi, root))


def mu_2d_colat(r, theta, chi, f, env: medium.EnvParams, root=1.0):
    """The colatitude frame's (RayMain.jl:125-264): dip(theta) = dip(lat)
    at lat = pi/2 - theta, so the latitude form serves."""
    return mu_2d_lat(r, math.pi / 2.0 - theta, chi, f, env, root)


def _psi_trig_bmag_3d(r, theta, phi, rho_r, rho_t, rho_p,
                      env: medium.EnvParams):
    """(sin psi, cos psi, |B|) from one field evaluation.

    sin psi comes from the cross product |B x rho|/(|B||rho|), not
    sqrt(1 - cos^2), which cancels to the float32 rounding floor at
    field-aligned propagation (psi -> 0 or pi)."""
    br, bt, bp = medium.b_vec(r, theta, phi, env)
    bmag = torch.sqrt(br * br + bt * bt + bp * bp)
    rmag = torch.sqrt(rho_r * rho_r + rho_t * rho_t + rho_p * rho_p)
    inv_brm = 1.0 / (bmag * rmag)
    cospsi = torch.clamp(
        (br * rho_r + bt * rho_t + bp * rho_p) * inv_brm, -1.0, 1.0
    )
    c_r = bt * rho_p - bp * rho_t
    c_t = bp * rho_r - br * rho_p
    c_p = br * rho_t - bt * rho_r
    sinpsi = torch.sqrt(c_r * c_r + c_t * c_t + c_p * c_p) * inv_brm
    return sinpsi, cospsi, bmag


def psi_3d(r, theta, phi, rho_r, rho_t, rho_p, env: medium.EnvParams):
    """Wave-normal angle from the refractive-index vector rho and B:
    arccos of psi_trig_3d's cosine (RayTrace_3D.jl:136-141): the angle of
    the reference gradient set, which ops/gradients.py forms as arccos of
    the fused chain's own cosine; the fused chains use the cosine itself."""
    return torch.arccos(
        psi_trig_3d(r, theta, phi, rho_r, rho_t, rho_p, env)[1])


def psi_trig_3d(r, theta, phi, rho_r, rho_t, rho_p, env: medium.EnvParams):
    """(sin psi, cos psi) of the wave normal rho against B, without
    arccos; psi in [0, pi], so sin psi >= 0."""
    sinpsi, cospsi, _ = _psi_trig_bmag_3d(
        r, theta, phi, rho_r, rho_t, rho_p, env
    )
    return sinpsi, cospsi


def mu_3d(r, theta, phi, rho_r, rho_t, rho_p, f, env: medium.EnvParams,
          root=1.0):
    """3D refractive index (RayTrace_3D.jl:93-219) at the state
    (r, theta, phi, rho) and frequency f."""
    sinpsi, cospsi, b = _psi_trig_bmag_3d(
        r, theta, phi, rho_r, rho_t, rho_p, env
    )
    ne = medium.ne_total_m3(r, medium.mlat_3d(r, theta, phi, env), env,
                            phi=medium.mlon_3d(r, theta, phi, env))
    rr, ll, pp = stix_rlp(ne, b, f, env.eta_he, env.eta_o)
    return mu_from_mu2(mu2_signed_trig(rr, ll, pp, sinpsi, cospsi, root))


def consistent_rho_3d(r, theta, phi, khat, f, env: medium.EnvParams,
                      root=1.0):
    """Refractive-index vector ON the dispersion surface: rho0 =
    mu(psi(khat)) khat for the wave-normal direction khat (normalized
    here). The reference launches with rho0 = (1, 1, 0)
    (RayTrace_3D.jl:390-391), an off-shell state; this is the physical
    launch."""
    kr, kt, kp = khat
    n = torch.sqrt(kr * kr + kt * kt + kp * kp)
    kr, kt, kp = kr / n, kt / n, kp / n
    mu = mu_3d(r, theta, phi, kr, kt, kp, f, env, root)
    return mu * kr, mu * kt, mu * kp
