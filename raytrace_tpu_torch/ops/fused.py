"""Hand-fused analytic gradient chains of the dispersion relation.

Port of raytrace_tpu/ops/fused.py: the density chain
`_ne_and_grads` + `_compose_ne` over the whole medium (ionosphere with
the day/night blend, CA1992 with hard or smoothed plasmapause and trough
refill, GCPM, duct, diffusive equilibrium, and the MLT-resolved
parameters with their d/dphi channel), the 2D latitude frame's chain (mu
and its four partials r, lat, chi == psi, f) and the 3D dipole frame's
chain (mu and its seven partials r, theta, phi, rho_r, rho_theta,
rho_phi, f, in the cos(psi) form), and the general chain of the 3D frame
over the tilted dipole and the IGRF truncation (mu_and_grads_3d_general:
the field's hand-written tangents in front of the same density and Stix
core); the Stix core sums over the ion species of the medium
(dispersion.ion_species). Each comes from one forward sweep:
every derivative is a rational expression in quantities the forward pass
already computed. The same chains, line for line, are inlined in the
CUDA step kernel (csrc/step_chunk.cu); these are their plain PyTorch
forms, and the kernel rounds as they do on the card.
"""

import functools
import math
from typing import NamedTuple

import torch

from ..constants import FCE_E, FPE2_E, RE
from ..models import dipole, medium
from ..models.plasmasphere import DE_RBASE_M, DE_S, LN10
from .dispersion import ion_species


class MediumConsts(NamedTuple):
    """Subexpressions of env scalars alone, formed once in double on the
    host. The plain chain below multiplies by them, and ops/step_chunk.py
    passes the same doubles to the kernel, which casts each to its type,
    so both round them alike (the JAX package forms some of them in the
    run dtype; they differ from these by an ulp of that dtype)."""

    one_m_mix: float      # 1 - iono_mix
    ln_ne_lppi: float     # log(ne_lppi)
    inv_smooth: float     # 1 / ps_smooth
    one_m_refill: float   # 1 - ps_refill
    ln_lref: float        # log(ps_refill_lref)
    ln_keep: float        # log(max(1 - ps_refill, 1e-30))
    ln_gcpm_ne0: float    # log(gcpm_ne0)
    inv_lscale: float     # 1 / gcpm_lscale
    inv_knee: float       # 1 / gcpm_knee
    inv_duct_w: float     # 1 / duct_w
    duct_slope: float     # -(duct_amp / duct_w)
    cos_a0: float         # cos(ps_mlt_a0)


def _inv(x):
    return 1.0 / x if x != 0.0 else 0.0


def _log(x):
    return math.log(x) if x > 0.0 else 0.0


@functools.lru_cache(maxsize=64)
def medium_consts(env: medium.EnvParams) -> MediumConsts:
    """The env-only subexpressions of the density chain (0.0 where the
    feature that uses one is off)."""
    return MediumConsts(
        one_m_mix=1.0 - env.iono_mix,
        ln_ne_lppi=_log(env.ne_lppi),
        inv_smooth=_inv(env.ps_smooth),
        one_m_refill=1.0 - env.ps_refill,
        ln_lref=_log(env.ps_refill_lref),
        ln_keep=math.log(max(1.0 - env.ps_refill, 1.0e-30)),
        ln_gcpm_ne0=_log(env.gcpm_ne0),
        inv_lscale=_inv(env.gcpm_lscale),
        inv_knee=_inv(env.gcpm_knee),
        inv_duct_w=_inv(env.duct_w),
        duct_slope=-(env.duct_amp / env.duct_w) if env.duct_w else 0.0,
        cos_a0=math.cos(env.ps_mlt_a0),
    )


def mlt_params(phi, env: medium.EnvParams):
    """The MLT-resolved parameters and their phi-slopes at longitude phi
    (medium.mlt_gcpm_params or mlt_ps_params, with_grads=True), the
    `mlt` argument of _ne_and_grads."""
    if env.ps_model == "gcpm":
        return medium.mlt_gcpm_params(phi, env, with_grads=True)
    return medium.mlt_ps_params(phi, env, with_grads=True)


def _ne_and_grads(r, lat, env: medium.EnvParams, mlt=None):
    """(ne_m3, d ne/dr, d ne/dlat[, d ne/dphi]) over the whole medium.

    Python-float gates select the code path, as in the JAX package: a
    zero ps_weight drops the plasmasphere, iono_mix == 1 keeps one
    ionosphere fit, ps_model selects CA1992 or GCPM, and ps_smooth,
    ps_refill, ps_refill_q and duct_amp at zero drop their terms.

    mlt: None (axisymmetric; 3-tuple return) or `mlt_params(phi, env)`,
    the MLT-resolved parameters and their phi-derivatives; the return
    then grows a 4th element d ne/dphi (branch 1 does not depend on MLT,
    branch 2 moves with the plasmapause shape and its continuity
    density, branch 3 with the day-night trough level; the GCPM knee
    center and trough move alike)."""
    k = medium_consts(env)
    ni = env.iono_n0 * torch.exp(-env.iono_decay * (r - env.iono_r0))
    ni_r = -env.iono_decay * ni
    if env.iono_mix != 1.0:
        # day/night blend: a second exponential term, the derivative the
        # blend of the two terms' derivatives
        nb = env.iono_n0_b * torch.exp(-env.iono_decay_b * (r - env.iono_r0))
        ni = env.iono_mix * ni + k.one_m_mix * nb
        ni_r = env.iono_mix * ni_r + k.one_m_mix * (-env.iono_decay_b * nb)
    if env.ps_weight == 0.0:
        z = torch.zeros_like(ni)
        if mlt is not None:
            return 1.0e6 * ni, 1.0e6 * ni_r, z, z
        return 1.0e6 * ni, 1.0e6 * ni_r, z

    sl, cl = torch.sin(lat), torch.cos(lat)
    inv_cl = 1.0 / cl
    inv_cl2 = inv_cl * inv_cl
    L = r * inv_cl2
    L_r = inv_cl2
    L_lat = 2.0 * L * sl * inv_cl

    if env.ps_model == "gcpm":
        return _gcpm_and_grads(r, env, k, ni, ni_r, sl, cl, L, L_r, L_lat,
                               mlt)

    if mlt is not None:
        (lppi_e, lppo_e, ne_lppi_e, trough_e), (
            dlppi, dlppo, dg1i, dtrough) = mlt
    else:
        lppi_e, lppo_e = env.lppi, env.lppo
        ne_lppi_e, trough_e = env.ne_lppi, env.ps_trough

    # CA1992 branches: value and d/dL together (RayTrace_lat.jl:72-81)
    e1 = torch.exp((2.0 - L) / 1.5)
    g1 = (-0.3145 * L + 3.9043) + env.ps_season * e1
    ne1 = torch.exp(LN10 * g1)
    dne1 = LN10 * ne1 * (-0.3145 - env.ps_season * e1 / 1.5)
    ne2 = ne_lppi_e * torch.exp(LN10 * (lppi_e - L) / 0.1)
    dne2 = -(LN10 / 0.1) * ne2
    Ls = torch.clamp_min(L, 1.0e-6)
    # L^-4.5 as (1/L)^4 * rsqrt(L)
    inv_Ls = 1.0 / Ls
    inv_Ls2 = inv_Ls * inv_Ls
    f45 = (inv_Ls2 * inv_Ls2) * torch.rsqrt(Ls)
    p3 = trough_e * f45
    e3 = torch.exp((2.0 - L) * 0.1)
    ne3 = p3 + (1.0 - e3)
    dne3 = -4.5 * p3 * inv_Ls + e3 * 0.1
    if mlt is not None:
        # ln ne2 = LN10 (g1(lppi_e) + (lppi_e - L)/0.1): its phi-slope is
        # parameter motion only; branch 3 scales its power-law term with
        # the trough level
        dln2_phi = LN10 * (dg1i + dlppi / 0.1)
        dne2_phi = ne2 * dln2_phi
        dne3_phi = dtrough * f45
    if env.ps_refill != 0.0:
        # trough refill: a log-space blend toward the saturated branch-1
        # profile, value and d/dL together; with ps_refill_q the weight
        # is per L (plasmasphere.refill_weight), adding its dw/dL term
        ln3 = torch.log(ne3)
        ln1 = LN10 * g1
        qr = env.ps_refill_q
        if qr == 0.0:
            w_r, one_m_w, dw = env.ps_refill, k.one_m_refill, None
        else:
            e_r = torch.exp(qr * (k.ln_lref - torch.log(Ls)))
            keep = torch.exp(e_r * k.ln_keep)
            w_r = 1.0 - keep
            one_m_w = 1.0 - w_r
            dw = keep * k.ln_keep * qr * e_r / Ls
        ln3_eff = one_m_w * ln3 + w_r * ln1
        dln3_eff = one_m_w * (dne3 / ne3) + w_r * (dne1 / ne1)
        if dw is not None:
            dln3_eff = dln3_eff + dw * (ln1 - ln3)
        ne3_eff = torch.exp(ln3_eff)
        if mlt is not None:
            # the blend's target, branch 1, does not depend on MLT
            dne3_phi = ne3_eff * one_m_w * (dne3_phi / ne3)
        ne3 = ne3_eff
        dne3 = ne3 * dln3_eff
    ne_p_phi = None
    if env.ps_smooth != 0.0:
        # log-space sigmoid blends (plasmasphere.ne_plasma_cm3), value and
        # d/dL together; ln2 analytically, not log(ne2), which may
        # underflow to 0 at extreme L
        inv_w = k.inv_smooth
        s1 = 1.0 / (1.0 + torch.exp(-(lppi_e - L) * inv_w))
        s2 = 1.0 / (1.0 + torch.exp(-(lppo_e - L) * inv_w))
        ds1 = -s1 * (1.0 - s1) * inv_w     # d s1/dL
        ds2 = -s2 * (1.0 - s2) * inv_w
        ln1 = LN10 * g1
        dln1 = dne1 / ne1
        ln_ne_lppi = k.ln_ne_lppi if mlt is None else torch.log(ne_lppi_e)
        ln2 = ln_ne_lppi + LN10 * (lppi_e - L) / 0.1
        dln2 = -(LN10 / 0.1)
        ln3 = torch.log(ne3)
        dln3 = dne3 / ne3
        inner = s2 * ln2 + (1.0 - s2) * ln3
        dinner = ds2 * (ln2 - ln3) + s2 * dln2 + (1.0 - s2) * dln3
        lns = s1 * ln1 + (1.0 - s1) * inner
        ne_p = torch.exp(lns)
        dne_p = ne_p * (
            ds1 * (ln1 - inner) + s1 * dln1 + (1.0 - s1) * dinner
        )
        if mlt is not None:
            # the weights move with the boundaries: d s/dphi = -ds/dL *
            # dboundary/dphi
            ds1_phi = -ds1 * dlppi
            ds2_phi = -ds2 * dlppo
            dln3_phi = dne3_phi / ne3
            dinner_phi = (
                ds2_phi * (ln2 - ln3) + s2 * dln2_phi
                + (1.0 - s2) * dln3_phi
            )
            ne_p_phi = ne_p * (
                ds1_phi * (ln1 - inner) + (1.0 - s1) * dinner_phi
            )
    else:
        # hard branches with <=, at the effective boundaries
        in1 = L <= lppi_e
        in2 = L <= lppo_e
        ne_p = torch.where(in1, ne1, torch.where(in2, ne2, ne3))
        dne_p = torch.where(in1, dne1, torch.where(in2, dne2, dne3))
        if mlt is not None:
            ne_p_phi = torch.where(
                in1, torch.zeros_like(ne_p),
                torch.where(in2, dne2_phi, dne3_phi),
            )
    return _compose_ne(r, env, k, ni, ni_r, ne_p, dne_p, L_r, L_lat, L,
                       ne_p_phi=ne_p_phi)


def _gcpm_and_grads(r, env, k, ni, ni_r, sl, cl, L, L_r, L_lat, mlt):
    """The simplified-GCPM branch of _ne_and_grads: log-space value, d/dL
    and the direct d/dlat at fixed L (the mirror ratio) together; with
    `mlt` the knee center and trough level move with local time."""
    if mlt is not None:
        (lppo_e, trough_e), (dlppo, dtrough) = mlt
    else:
        lppo_e, trough_e = env.lppo, env.ps_trough
    q2g = 1.0 + 3.0 * sl * sl
    ln_m = 0.5 * torch.log(q2g) - 6.0 * torch.log(cl)
    dln_m = 3.0 * sl * cl / q2g + 6.0 * sl / cl
    ln_ps = (k.ln_gcpm_ne0 - (L - 2.0) * k.inv_lscale
             + env.gcpm_bpow * ln_m)
    Lsg = torch.clamp_min(L, 1.0e-6)
    f45g = torch.exp(-4.5 * torch.log(Lsg))
    p3g = trough_e * f45g
    e3g = torch.exp((2.0 - L) / 10.0)
    ne3g = p3g + (1.0 - e3g)
    ln_tr = torch.log(ne3g)
    dln_tr = (-4.5 * p3g / Lsg + e3g / 10.0) / ne3g
    wk = 1.0 / (1.0 + torch.exp(-(lppo_e - L) * k.inv_knee))
    dwk = -wk * (1.0 - wk) * k.inv_knee
    ne_p = torch.exp(wk * ln_ps + (1.0 - wk) * ln_tr)
    dne_p = ne_p * (
        dwk * (ln_ps - ln_tr) - wk * k.inv_lscale + (1.0 - wk) * dln_tr
    )
    ne_p_lat_direct = ne_p * wk * env.gcpm_bpow * dln_m
    ne_p_phi = None
    if mlt is not None:
        # knee motion (wk through lppo) and trough-level motion
        dwk_phi = wk * (1.0 - wk) * k.inv_knee * dlppo
        dln_tr_phi = dtrough * f45g / ne3g
        ne_p_phi = ne_p * (
            dwk_phi * (ln_ps - ln_tr) + (1.0 - wk) * dln_tr_phi
        )
    return _compose_ne(r, env, k, ni, ni_r, ne_p, dne_p, L_r, L_lat, L,
                       ne_p_lat_direct, ne_p_phi)


def _compose_ne(r, env, k, ni, ni_r, ne_p, dne_p, L_r, L_lat, L,
                ne_p_lat_direct=None, ne_p_phi=None):
    """Common tail of _ne_and_grads: apply the duct and the
    diffusive-equilibrium factor and assemble the total density with its
    (r, lat) partials. ne_p_lat_direct carries the plasmasphere's
    lat-dependence at fixed L (the GCPM mirror ratio); ne_p_phi (the MLT
    medium) rides the same L- and r-only factors and appends d ne/dphi."""
    if env.duct_amp != 0.0:
        # Gaussian duct (plasmasphere.duct_factor): value and d/dL
        # together; it multiplies the whole plasmasphere term
        x = (L - env.duct_l0) * k.inv_duct_w
        e = torch.exp(-0.5 * x * x)
        g = 1.0 + env.duct_amp * e
        dg = k.duct_slope * x * e
        dne_p = dne_p * g + ne_p * dg
        ne_p = ne_p * g
        if ne_p_lat_direct is not None:
            ne_p_lat_direct = ne_p_lat_direct * g
        if ne_p_phi is not None:
            ne_p_phi = ne_p_phi * g
    if env.de_weight != 0.0:
        G = DE_RBASE_M * (1.0 - DE_RBASE_M / (r * RE))
        de = torch.sqrt(torch.exp(-G / DE_S))
        de_r = -de * DE_RBASE_M * DE_RBASE_M / (2.0 * DE_S * r * r * RE)
        de = env.de_weight * de + (1.0 - env.de_weight)
        de_r = env.de_weight * de_r
    else:
        de = 1.0
        de_r = 0.0
    w = env.ps_weight
    ne = 1.0e6 * (ni + w * ne_p * de)
    ne_r = 1.0e6 * (ni_r + w * (dne_p * L_r * de + ne_p * de_r))
    lat_term = dne_p * L_lat
    if ne_p_lat_direct is not None:
        lat_term = lat_term + ne_p_lat_direct
    ne_lat = 1.0e6 * w * de * lat_term
    if ne_p_phi is not None:
        return ne, ne_r, ne_lat, 1.0e6 * w * de * ne_p_phi
    return ne, ne_r, ne_lat


def _stix_quartic_grads(ne, bm, f, sinpsi, cospsi, root, wrt_cos=False,
                        eta_he=0.0, eta_o=0.0):
    """mu plus d(mu)/d{ne, bm, f, geometry} at fixed geometry, over the
    ion species of ion_species(eta_he, eta_o) (protons only by default).
    Returns (mu, dmu_dn, dmu_db, dmu_df, dmu_dgeom).

    wrt_cos selects the geometry variable of dmu_dgeom: False (2D) gives
    dmu/dpsi, whose every term carries the factor sin(psi) cos(psi); True
    (3D) gives dmu/dcos(psi), where that factor becomes -cos(psi) and no
    1/sin(psi) has to be divided back out at field-aligned propagation
    (the psi form falsely wedge-retired 65% of a 3D fan in float32,
    benchmarks/perf_r03j.py)."""
    inv_f = 1.0 / f
    ncm = ne * 1.0e-6
    xe = FPE2_E * ncm * inv_f * inv_f
    ye = FCE_E * bm * inv_f
    inv_de = 1.0 / (1.0 - ye * ye)
    ae = (1.0 + ye) * inv_de
    be = (1.0 - ye) * inv_de
    # species sums in species order: Sa = sum x a, Say = sum x a^2 y
    # (ditto b) with a = 1/(1 + y), b = 1/(1 - y); the first species
    # starts each sum (the JAX package adds it to 0, which is exact)
    for k, (fpe2_i, fce_i) in enumerate(ion_species(eta_he, eta_o)):
        xi = fpe2_i * ncm * inv_f * inv_f
        yi = fce_i * bm * inv_f
        inv_di = 1.0 / (1.0 - yi * yi)
        ai = (1.0 - yi) * inv_di
        bi = (1.0 + yi) * inv_di
        if k == 0:
            Sa, Sb = xi * ai, xi * bi
            Say, Sby = xi * ai * ai * yi, xi * bi * bi * yi
            Sx = xi
        else:
            Sa = Sa + xi * ai
            Sb = Sb + xi * bi
            Say = Say + xi * ai * ai * yi
            Sby = Sby + xi * bi * bi * yi
            Sx = Sx + xi
    R = 1.0 - xe * ae - Sa
    L = 1.0 - xe * be - Sb
    P = 1.0 - xe - Sx
    inv_ne = 1.0 / ne
    R_n = -(xe * ae + Sa) * inv_ne
    L_n = -(xe * be + Sb) * inv_ne
    P_n = -(xe + Sx) * inv_ne
    inv_bm = 1.0 / bm
    R_b = (-xe * ae * ae * ye + Say) * inv_bm
    L_b = (xe * be * be * ye - Sby) * inv_bm
    R_f = (2.0 * (xe * ae + Sa) + (xe * ae * ae * ye - Say)) * inv_f
    L_f = (2.0 * (xe * be + Sb) + (-xe * be * be * ye + Sby)) * inv_f
    P_f = 2.0 * (xe + Sx) * inv_f

    s = torch.maximum(torch.maximum(torch.abs(R), torch.abs(L)), torch.abs(P))
    inv_s = 1.0 / s
    Rn, Ln, Pn = R * inv_s, L * inv_s, P * inv_s

    sin2 = sinpsi * sinpsi
    cos2 = cospsi * cospsi
    sin4 = sin2 * sin2
    Sn = 0.5 * (Rn + Ln)
    A = Sn * sin2 + Pn * cos2
    RL = Rn * Ln
    PS = Pn * Sn
    B = RL * sin2 + PS * (1.0 + cos2)
    C = Pn * RL
    G = RL - PS
    H = Pn * (Rn - Ln)
    F2 = G * G * sin4 + H * H * cos2
    F = torch.sqrt(F2)
    inv_F = 1.0 / F

    halfP = 0.5 * Pn
    geo = -cospsi if wrt_cos else sinpsi * cospsi
    A_R = 0.5 * sin2
    A_L = 0.5 * sin2
    A_P = cos2
    A_psi = (Sn - Pn) * 2.0 * geo
    onepcos2 = 1.0 + cos2
    B_R = Ln * sin2 + halfP * onepcos2
    B_L = Rn * sin2 + halfP * onepcos2
    B_P = Sn * onepcos2
    B_psi = 2.0 * G * geo
    C_R = Pn * Ln
    C_L = Pn * Rn
    C_P = RL
    F_R = (G * (Ln - halfP) * sin4 + H * Pn * cos2) * inv_F
    F_L = (G * (Rn - halfP) * sin4 - H * Pn * cos2) * inv_F
    F_P = (-G * Sn * sin4 + H * (Rn - Ln) * cos2) * inv_F
    F_psi = geo * (2.0 * G * G * sin2 - H * H) * inv_F

    inv_2A = 0.5 / A
    inv_A = inv_2A + inv_2A
    num_dir = B + root * F
    mu2n_dir = num_dir * inv_2A
    den_pro = B - root * F
    inv_den = 1.0 / den_pro
    mu2n_pro = 2.0 * C * inv_den
    use_dir = root * B >= 0.0
    mu2n = torch.where(use_dir, mu2n_dir, mu2n_pro)

    def mu2n_q(B_q, F_q, A_q, C_q):
        d_dir = (B_q + root * F_q) * inv_2A - mu2n_dir * A_q * inv_A
        d_pro = (2.0 * C_q - mu2n_pro * (B_q - root * F_q)) * inv_den
        return torch.where(use_dir, d_dir, d_pro)

    m_R = mu2n_q(B_R, F_R, A_R, C_R)
    m_L = mu2n_q(B_L, F_L, A_L, C_L)
    m_P = mu2n_q(B_P, F_P, A_P, C_P)
    m_psi = mu2n_q(B_psi, F_psi, A_psi, torch.zeros_like(C_R))

    mu2 = s * mu2n
    mu = torch.sqrt(torch.abs(mu2))
    gscale = torch.sign(mu2n) / (2.0 * mu)

    dmu_dn = gscale * (m_R * R_n + m_L * L_n + m_P * P_n)
    dmu_db = gscale * (m_R * R_b + m_L * L_b)
    dmu_df = gscale * (m_R * R_f + m_L * L_f + m_P * P_f)
    dmu_dpsi = gscale * s * m_psi
    return mu, dmu_dn, dmu_db, dmu_df, dmu_dpsi


def mu_and_grads_2d_lat(r, lat, chi, f, env: medium.EnvParams, root=1.0):
    """(mu, dmu/dr, dmu/dlat, dmu/dpsi, dmu/df) -- one fused sweep.

    dmu/dpsi == dmu/dchi (psi = pi/2 + dip + chi). Value equal to
    dispersion.mu_2d_lat; partials equal to its autodiff gradient. The
    2D frames trace the phi = 0 meridian, so an MLT-resolved medium is
    its axisymmetric parameters here."""
    return mu_and_grads_2d_lat_medium(r, lat, chi, f, env, root)[0]


def mu_and_grads_2d_lat_medium(r, lat, chi, f, env: medium.EnvParams,
                               root=1.0):
    """(mu_and_grads_2d_lat's tuple, (ne, |B|)): with the density and the
    field magnitude the chain took, which the reference gradient set
    (ops/gradients.py) feeds to its closed form."""
    sl, cl = torch.sin(lat), torch.cos(lat)
    q2 = 1.0 + 3.0 * sl * sl
    q = torch.sqrt(q2)
    inv_r = 1.0 / r
    inv_r3 = inv_r * inv_r * inv_r
    inv_q = 1.0 / q
    inv_q2 = inv_q * inv_q

    bm = env.b0 * q * inv_r3
    bm_r = -3.0 * bm * inv_r
    bm_lat = 3.0 * sl * cl * bm * inv_q2

    sindip = 2.0 * sl * inv_q
    cosdip = cl * inv_q
    sc, cc = torch.sin(chi), torch.cos(chi)
    sinpsi = cosdip * cc - sindip * sc
    cospsi = -(sindip * cc + cosdip * sc)
    dpsi_dlat = 2.0 * inv_q2

    ne, ne_r, ne_lat = _ne_and_grads(r, lat, env)
    mu, dmu_dn, dmu_db, dmu_df, dmu_dpsi = _stix_quartic_grads(
        ne, bm, f, sinpsi, cospsi, root, eta_he=env.eta_he, eta_o=env.eta_o
    )
    dmudr = dmu_dn * ne_r + dmu_db * bm_r
    dmudlat = dmu_dn * ne_lat + dmu_db * bm_lat + dmu_dpsi * dpsi_dlat
    return (mu, dmudr, dmudlat, dmu_dpsi, dmu_df), (ne, bm)


def mu_and_grads_3d(r, theta, phi, rho_r, rho_t, rho_p, f,
                    env: medium.EnvParams, root=1.0):
    """mu and its seven partials for the 3D state (centered dipole,
    axisymmetric medium) -- one fused sweep.

    Returns (mu, (dmu/dr, dmu/dtheta, dmu/dphi, dmu/drho_r, dmu/drho_t,
    dmu/drho_p, dmu/df)). Geometry: cos psi = Bhat . rhohat; the field
    direction does not depend on r, so r enters through |B| and ne only;
    d(cos psi)/d(rho_k) = (Bhat_k - cos psi rhohat_k)/|rho|. The field
    is axisymmetric, so with the MLT-resolved medium (env.ps_mlt) dmu/dphi
    flows entirely through the density, dmu_dn * dne/dphi; the
    axisymmetric medium keeps dmu/dphi == 0 exactly."""
    return mu_and_grads_3d_medium(r, theta, phi, rho_r, rho_t, rho_p, f,
                                  env, root)[0]


def mu_and_grads_3d_medium(r, theta, phi, rho_r, rho_t, rho_p, f,
                           env: medium.EnvParams, root=1.0):
    """(mu_and_grads_3d's pair, (ne, |B|, cos psi, Bhat_r, Bhat_theta)):
    with the density, field and wave-normal geometry the chain took, which
    the reference gradient set (ops/gradients.py) feeds to its closed form
    and Kimura chain (Bhat_phi = 0)."""
    lat = math.pi / 2.0 - theta
    sl, cl = torch.sin(lat), torch.cos(lat)
    q2 = 1.0 + 3.0 * sl * sl
    q = torch.sqrt(q2)
    inv_r = 1.0 / r
    inv_r3 = inv_r * inv_r * inv_r
    inv_q = 1.0 / q
    inv_q2 = inv_q * inv_q
    inv_q3 = inv_q2 * inv_q

    bm = env.b0 * q * inv_r3
    bm_r = -3.0 * bm * inv_r
    bm_lat = 3.0 * sl * cl * bm * inv_q2

    bhat_r = -2.0 * sl * inv_q         # b_vec_colat components / |B|
    bhat_t = -cl * inv_q
    dbhat_r_dlat = -2.0 * cl * inv_q3
    dbhat_t_dlat = 4.0 * sl * inv_q3

    # 1/|rho| as rsqrt, the JAX package's form; on the card torch.rsqrt
    # and the kernel call the same CUDA rsqrt (see csrc/step_chunk.cu)
    inv_rmag = torch.rsqrt(rho_r * rho_r + rho_t * rho_t + rho_p * rho_p)
    rhat_r = rho_r * inv_rmag
    rhat_t = rho_t * inv_rmag
    rhat_p = rho_p * inv_rmag
    cospsi = torch.clamp(bhat_r * rhat_r + bhat_t * rhat_t, -1.0, 1.0)
    # sin psi from the cross product |Bhat x rhohat| (Bhat_phi = 0)
    cr_m = bhat_r * rhat_t - bhat_t * rhat_r
    sinpsi = torch.sqrt(rhat_p * rhat_p + cr_m * cr_m)
    dcos_dlat = rhat_r * dbhat_r_dlat + rhat_t * dbhat_t_dlat
    dcos_dtheta = -dcos_dlat                   # dlat/dtheta = -1
    dcos_drho_r = (bhat_r - cospsi * rhat_r) * inv_rmag
    dcos_drho_t = (bhat_t - cospsi * rhat_t) * inv_rmag
    dcos_drho_p = (0.0 - cospsi * rhat_p) * inv_rmag

    if medium.mlt_on(env):
        ne, ne_r, ne_lat, ne_phi = _ne_and_grads(r, lat, env,
                                                 mlt=mlt_params(phi, env))
    else:
        ne, ne_r, ne_lat = _ne_and_grads(r, lat, env)
        ne_phi = None
    mu, dmu_dn, dmu_db, dmu_df, dmu_dc = _stix_quartic_grads(
        ne, bm, f, sinpsi, cospsi, root, wrt_cos=True, eta_he=env.eta_he,
        eta_o=env.eta_o
    )
    dmudr = dmu_dn * ne_r + dmu_db * bm_r
    dmudtheta = -(dmu_dn * ne_lat + dmu_db * bm_lat) + dmu_dc * dcos_dtheta
    dmudphi = torch.zeros_like(dmudr) if ne_phi is None else dmu_dn * ne_phi
    return (mu, (
        dmudr, dmudtheta, dmudphi,
        dmu_dc * dcos_drho_r, dmu_dc * dcos_drho_t,
        dmu_dc * dcos_drho_p, dmu_df,
    )), (ne, bm, cospsi, bhat_r, bhat_t)


def field_geometry(r, theta, phi, env: medium.EnvParams):
    """The non-axial field's geometry with its tangents, every one a
    scalar per ray: ((B_r, B_theta, B_phi, mlat, mlon), d/dr, d/dtheta,
    d/dphi), each a 5-tuple, from the closed forms of models/dipole.py
    (tilted_field or igrf_field, and magnetic_coords in the tilted frame,
    which for IGRF is that of its degree-1 part). The values are those of
    medium.b_vec, mlat_3d and mlon_3d: the same functions compute them."""
    if env.b_model == "tilted":
        b, b_r, b_t, b_p = dipole.tilted_field(
            r, theta, phi, env.b0, env.b_tilt, env.b_tilt_phi, tangents=True)
    elif env.b_model == "igrf":
        b, b_r, b_t, b_p = dipole.igrf_field(
            r, theta, phi, env.igrf_coeffs, tangents=True)
    else:
        raise ValueError(
            f"field_geometry serves the tilted and IGRF fields; "
            f"b_model={env.b_model!r} has the dipole chain mu_and_grads_3d"
        )
    m, m_t, m_p = dipole.magnetic_coords(
        theta, phi, env.b_tilt, env.b_tilt_phi, tangents=True)
    zero = torch.zeros_like(m[0])
    return (*b, *m), (*b_r, zero, zero), (*b_t, *m_t), (*b_p, *m_p)


def mu_and_grads_3d_general(r, theta, phi, rho_r, rho_t, rho_p, f,
                            env: medium.EnvParams, root=1.0):
    """mu and its seven partials over a non-axial field (tilted / IGRF).

    The geometry (field components, magnetic latitude and longitude) and
    its fifteen tangents come from field_geometry, scalar per ray; the
    density chain and the Stix quartic are those of the dipole chain
    (_ne_and_grads, _stix_quartic_grads in the cos(psi) form), with the
    MLT parameters taken at the magnetic longitude. On top of the
    tangents (x in r, theta, phi):
      |B|_x   = (B . B_x)/|B|
      cos psi = Bhat . rhohat;  d cos/dx = (B_x . rhohat - cos psi |B|_x)/|B|
                (formed from the unclipped products, as the JAX package's)
      sin psi = |Bhat x rhohat|, the full three-component cross (a tilted
                field has Bhat_phi != 0 in geographic coordinates)
      d cos/d rho_k = (Bhat_k - cos psi rhohat_k)/|rho|
      d ne/dx = ne_r [x == r] + ne_lat dmlat/dx + ne_mlon dmlon/dx
    Values and partials equal torch.func.grad of dispersion.mu_3d; at
    tilt = 0 they reduce to mu_and_grads_3d's (to rounding: the magnetic
    longitude still passes through atan2)."""
    ((br, bt, bp, mlat, mlon), (br_r, bt_r, bp_r, _, _),
     (br_t, bt_t, bp_t, mlat_t, mlon_t),
     (br_p, bt_p, bp_p, mlat_p, mlon_p)) = field_geometry(r, theta, phi, env)

    bm = torch.sqrt(br * br + bt * bt + bp * bp)
    inv_bm = 1.0 / bm
    bm_r = (br * br_r + bt * bt_r + bp * bp_r) * inv_bm
    bm_t = (br * br_t + bt * bt_t + bp * bp_t) * inv_bm
    bm_p = (br * br_p + bt * bt_p + bp * bp_p) * inv_bm
    hr, ht, hp = br * inv_bm, bt * inv_bm, bp * inv_bm

    inv_rmag = torch.rsqrt(rho_r * rho_r + rho_t * rho_t + rho_p * rho_p)
    rr, rt, rp = rho_r * inv_rmag, rho_t * inv_rmag, rho_p * inv_rmag
    cospsi = torch.clamp(hr * rr + ht * rt + hp * rp, -1.0, 1.0)
    c1 = ht * rp - hp * rt
    c2 = hp * rr - hr * rp
    c3 = hr * rt - ht * rr
    sinpsi = torch.sqrt(c1 * c1 + c2 * c2 + c3 * c3)
    dcos_dr = ((br_r * rr + bt_r * rt + bp_r * rp) - cospsi * bm_r) * inv_bm
    dcos_dt = ((br_t * rr + bt_t * rt + bp_t * rp) - cospsi * bm_t) * inv_bm
    dcos_dp = ((br_p * rr + bt_p * rt + bp_p * rp) - cospsi * bm_p) * inv_bm
    dcos_drho_r = (hr - cospsi * rr) * inv_rmag
    dcos_drho_t = (ht - cospsi * rt) * inv_rmag
    dcos_drho_p = (hp - cospsi * rp) * inv_rmag

    if medium.mlt_on(env):
        ne, ne_r, ne_lat, ne_mlon = _ne_and_grads(
            r, mlat, env, mlt=mlt_params(mlon, env))
        dne_dr = ne_r
        dne_dt = ne_lat * mlat_t + ne_mlon * mlon_t
        dne_dp = ne_lat * mlat_p + ne_mlon * mlon_p
    else:
        ne, ne_r, ne_lat = _ne_and_grads(r, mlat, env)
        dne_dr = ne_r
        dne_dt = ne_lat * mlat_t
        dne_dp = ne_lat * mlat_p

    mu, dmu_dn, dmu_db, dmu_df, dmu_dc = _stix_quartic_grads(
        ne, bm, f, sinpsi, cospsi, root, wrt_cos=True, eta_he=env.eta_he,
        eta_o=env.eta_o
    )
    return mu, (
        dmu_dn * dne_dr + dmu_db * bm_r + dmu_dc * dcos_dr,
        dmu_dn * dne_dt + dmu_db * bm_t + dmu_dc * dcos_dt,
        dmu_dn * dne_dp + dmu_db * bm_p + dmu_dc * dcos_dp,
        dmu_dc * dcos_drho_r, dmu_dc * dcos_drho_t,
        dmu_dc * dcos_drho_p, dmu_df,
    )
