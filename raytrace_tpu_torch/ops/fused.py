"""Hand-fused analytic gradient chain for the 2D latitude-frame dispersion.

Port of raytrace_tpu/ops/fused.py (the axisymmetric CA1992 hard-branch
path, protons only). mu and its four partials (r, lat, chi == psi, f)
come from one forward sweep: every derivative is a rational expression in
quantities the forward pass already computed. The same chain, line for
line, is inlined in the CUDA step kernel (csrc/step_chunk.cu); this is
its plain PyTorch form.
"""

import torch

from ..constants import FCE_E, FCE_P, FPE2_E, FPE2_P, RE
from ..models import medium
from ..models.plasmasphere import DE_RBASE_M, DE_S, LN10


def _ne_and_grads(r, lat, env: medium.EnvParams):
    """(ne_m3, d ne/dr, d ne/dlat): ionosphere + CA1992 hard branches.

    A Python-float-zero ps_weight drops the plasmasphere entirely, as in
    the JAX package."""
    medium.check_env(env)
    ni = env.iono_n0 * torch.exp(-env.iono_decay * (r - env.iono_r0))
    ni_r = -env.iono_decay * ni
    if env.ps_weight == 0.0:
        z = torch.zeros_like(ni)
        return 1.0e6 * ni, 1.0e6 * ni_r, z

    sl, cl = torch.sin(lat), torch.cos(lat)
    inv_cl = 1.0 / cl
    inv_cl2 = inv_cl * inv_cl
    L = r * inv_cl2
    L_r = inv_cl2
    L_lat = 2.0 * L * sl * inv_cl

    # CA1992 branches: value and d/dL together (RayTrace_lat.jl:72-81)
    e1 = torch.exp((2.0 - L) / 1.5)
    g1 = (-0.3145 * L + 3.9043) + env.ps_season * e1
    ne1 = torch.exp(LN10 * g1)
    dne1 = LN10 * ne1 * (-0.3145 - env.ps_season * e1 / 1.5)
    ne2 = env.ne_lppi * torch.exp(LN10 * (env.lppi - L) / 0.1)
    dne2 = -(LN10 / 0.1) * ne2
    Ls = torch.clamp_min(L, 1.0e-6)
    # L^-4.5 as (1/L)^4 * rsqrt(L)
    inv_Ls = 1.0 / Ls
    inv_Ls2 = inv_Ls * inv_Ls
    f45 = (inv_Ls2 * inv_Ls2) * torch.rsqrt(Ls)
    p3 = env.ps_trough * f45
    e3 = torch.exp((2.0 - L) * 0.1)
    ne3 = p3 + (1.0 - e3)
    dne3 = -4.5 * p3 * inv_Ls + e3 * 0.1
    in1 = L <= env.lppi
    in2 = L <= env.lppo
    ne_p = torch.where(in1, ne1, torch.where(in2, ne2, ne3))
    dne_p = torch.where(in1, dne1, torch.where(in2, dne2, dne3))
    return _compose_ne(r, env, ni, ni_r, ne_p, dne_p, L_r, L_lat)


def _compose_ne(r, env, ni, ni_r, ne_p, dne_p, L_r, L_lat):
    """Apply the diffusive-equilibrium factor and assemble the total
    density with its (r, lat) partials."""
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
    ne_lat = 1.0e6 * w * de * (dne_p * L_lat)
    return ne, ne_r, ne_lat


def _stix_quartic_grads(ne, bm, f, sinpsi, cospsi, root):
    """mu plus d(mu)/d{ne, bm, f, psi} at fixed geometry (protons only).

    Returns (mu, dmu_dn, dmu_db, dmu_df, dmu_dpsi)."""
    inv_f = 1.0 / f
    ncm = ne * 1.0e-6
    xe = FPE2_E * ncm * inv_f * inv_f
    ye = FCE_E * bm * inv_f
    inv_de = 1.0 / (1.0 - ye * ye)
    ae = (1.0 + ye) * inv_de
    be = (1.0 - ye) * inv_de
    # the species sums of the JAX package, over its one proton species:
    # Sa = x a, Say = x a^2 y (ditto b) with a = 1/(1 + y), b = 1/(1 - y)
    xi = FPE2_P * ncm * inv_f * inv_f
    yi = FCE_P * bm * inv_f
    inv_di = 1.0 / (1.0 - yi * yi)
    ai = (1.0 - yi) * inv_di
    bi = (1.0 + yi) * inv_di
    Sa = xi * ai
    Sb = xi * bi
    Say = xi * ai * ai * yi
    Sby = xi * bi * bi * yi
    Sx = xi
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
    geo = sinpsi * cospsi
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
    dispersion.mu_2d_lat; partials equal to its autodiff gradient."""
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
        ne, bm, f, sinpsi, cospsi, root
    )
    dmudr = dmu_dn * ne_r + dmu_db * bm_r
    dmudlat = dmu_dn * ne_lat + dmu_db * bm_lat + dmu_dpsi * dpsi_dlat
    return mu, dmudr, dmudlat, dmu_dpsi, dmu_df
