"""Cold-plasma (Stix) dispersion for whistler waves, 2D latitude and 3D frames.

Port of raytrace_tpu/ops/dispersion.py (protons-only subset). Solves
A mu^4 - B mu^2 + C = 0 in the ratio form X = f_p^2/f^2, Y = f_c/f, with
R, L, P normalized by s = max(|R|, |L|, |P|) and the stable product root
2C/(B - F) where the direct form cancels. mu = sqrt(|mu^2|), the
reference's abs() guard (RayMain.jl:213). Elementwise over any batch
shape.
"""

import torch

from ..constants import FCE_E, FCE_P, FPE2_E, FPE2_P
from ..models import medium


def stix_rlp(ne_m3, bmag, f):
    """Stix R, L, P for a quasi-neutral electron-proton plasma
    (RayMain.jl:156-176 in ratio form)."""
    n_cm3 = ne_m3 * 1.0e-6
    f2 = f * f
    xe = FPE2_E * n_cm3 / f2
    ye = FCE_E * bmag / f
    r = 1.0 - xe / (1.0 - ye)
    l = 1.0 - xe / (1.0 + ye)  # noqa: E741
    p = 1.0 - xe
    xi = FPE2_P * n_cm3 / f2
    yi = FCE_P * bmag / f
    r = r - xi / (1.0 + yi)
    l = l - xi / (1.0 - yi)  # noqa: E741
    p = p - xi
    return r, l, p


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
    """Whistler phase refractive index at (r [RE], lat, chi, f [Hz])
    (phase_refractive_index, RayTrace_lat.jl:44-194)."""
    sinpsi, cospsi = psi_trig_lat(lat, chi)
    ne = medium.ne_total_m3(r, lat, env)
    b = medium.b_mag(r, lat, env)
    rr, ll, pp = stix_rlp(ne, b, f)
    return mu_from_mu2(mu2_signed_trig(rr, ll, pp, sinpsi, cospsi, root))


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


def psi_trig_3d(r, theta, phi, rho_r, rho_t, rho_p, env: medium.EnvParams):
    """(sin psi, cos psi) of the wave normal rho against B, without
    arccos; psi in [0, pi], so sin psi >= 0."""
    sinpsi, cospsi, _ = _psi_trig_bmag_3d(
        r, theta, phi, rho_r, rho_t, rho_p, env
    )
    return sinpsi, cospsi


def mu_3d(r, theta, phi, rho_r, rho_t, rho_p, f, env: medium.EnvParams,
          root=1.0):
    """3D whistler refractive index (RayTrace_3D.jl:93-219) at the state
    (r, theta, phi, rho) and frequency f."""
    sinpsi, cospsi, b = _psi_trig_bmag_3d(
        r, theta, phi, rho_r, rho_t, rho_p, env
    )
    ne = medium.ne_total_m3(r, medium.mlat_3d(r, theta, phi, env), env,
                            phi=medium.mlon_3d(r, theta, phi, env))
    rr, ll, pp = stix_rlp(ne, b, f)
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
