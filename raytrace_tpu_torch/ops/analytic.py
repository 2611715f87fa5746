"""Analytic derivative forms of the reference scripts (port of
raytrace_tpu/ops/analytic.py).

The closed-form dmu/dpsi (RayMain.jl:246-254) and the Kimura 1966
dmu/drho_k chain (RayTrace_3D.jl:261-311), which grad_mode="reference"
(ops/gradients.py) feeds into the right-hand side for trajectory parity
with the Julia scripts, and the reference-style central difference
(RayMain.jl:268-316), an oracle. Every operation is written in the order
the CUDA step kernel performs it (csrc/step_chunk.cu, ref_dmudpsi and
rhs_3d_ref), so that the two round alike on the card: a square is a
product, and `1.0 / x` is a reciprocal.
"""

import torch

from ..models import medium
from . import dispersion


def mu_and_dmudpsi(ne_m3, bmag, f, psi, root=1.0):
    """(mu, dmu/dpsi) via the reference's closed form (RayMain.jl:246-254).

    dmu/dpsi = 1/(2 mu) ((dB + root dF)/(2A) - 2 dA (B + root F)/(2A^2)),
    evaluated on normalized Stix parameters; both mu and dmu/dpsi scale as
    sqrt(s), so the rescale is sqrt(s) for each.

    This reproduces the reference formula *as written*, which is NOT the
    derivative of the mu the reference traces, in two ways: the dA term
    carries an extra factor 2 against the quotient rule, and it ignores
    the abs() guard (where mu^2 < 0, as on the whole canonical whistler
    trace, the true d(sqrt|mu^2|)/dpsi has the opposite sign). Net effect:
    about -3x the true derivative in the traced regime."""
    r, l, p = dispersion.stix_rlp(ne_m3, bmag, f)  # noqa: E741
    s = torch.maximum(torch.maximum(torch.abs(r), torch.abs(l)), torch.abs(p))
    rn, ln, pn = r / s, l / s, p / s
    dn = 0.5 * (rn - ln)
    sn = 0.5 * (rn + ln)
    sinpsi, cospsi = torch.sin(psi), torch.cos(psi)
    sin2, cos2 = sinpsi * sinpsi, cospsi * cospsi
    a = sn * sin2 + pn * cos2
    b = rn * ln * sin2 + pn * sn * (1.0 + cos2)
    rl_ps = rn * ln - pn * sn
    pdc = pn * dn * cospsi
    f2 = rl_ps * rl_ps * sin2 * sin2 + 4.0 * (pdc * pdc)
    fd = torch.sqrt(f2)
    mu2n = (b + root * fd) / (2.0 * a)
    mun = torch.sqrt(torch.abs(mu2n))
    dadpsi = 2.0 * (sn - pn) * sinpsi * cospsi
    dbdpsi = 2.0 * (rn * ln - pn * sn) * sinpsi * cospsi
    pd = pn * dn
    dfdpsi = (1.0 / (2.0 * fd)) * (
        rl_ps * rl_ps * 4.0 * sin2 * sinpsi * cospsi
        - 8.0 * (pd * pd) * sinpsi * cospsi
    )
    dmudpsi_n = (1.0 / (2.0 * mun)) * (
        (dbdpsi + root * dfdpsi) / (2.0 * a)
        - 2.0 * dadpsi * (b + root * fd) / (2.0 * a * a)
    )
    sq = torch.sqrt(s)
    return sq * mun, sq * dmudpsi_n


def mu_dmudpsi_2d_lat(r, lat, chi, f, env: medium.EnvParams, root=1.0):
    """(mu, dmu/dpsi) at a 2D latitude-frame state."""
    psi = dispersion.psi_lat(lat, chi)
    ne = medium.ne_total_m3(r, lat, env)
    b = medium.b_mag(r, lat, env)
    return mu_and_dmudpsi(ne, b, f, psi, root)


def kimura_dmudrho(mu, dmudpsi, psi, bvec, rho):
    """Kimura 1966 analytic dmu/drho_k (reference: RayTrace_3D.jl:261-311).

    dmu/drho_k = dmu/dpsi (rho_k cos psi - mu cos(alpha_Bk)) / (mu^2 sin psi)
    with cos(alpha_Bk) = B_k sign(rho_k)/|B| (the reference computes
    B.rho_k_vec/(|B||rho_k|), which reduces to this). sign(0) = 0, as
    jnp.sign has it (torch.sign also gives 0 for NaN)."""
    br, bt, bp = bvec
    bmag = torch.sqrt(br * br + bt * bt + bp * bp)
    out = []
    for rho_k, b_k in zip(rho, (br, bt, bp)):
        cos_alpha = b_k * torch.sign(rho_k) / bmag
        out.append(
            dmudpsi
            * (rho_k * torch.cos(psi) - mu * cos_alpha)
            / (mu * mu * torch.sin(psi))
        )
    return tuple(out)


def fd_grad(fn, x, h):
    """Reference-style central difference (RayMain.jl:268-316).

    The reference uses absolute steps h = 1e-11 (space/angle, with r in
    meters) and 1e-5 Hz (frequency). In scaled units the equivalent
    spatial step is h/RE. Float64 only: an oracle, not a compute path."""
    return (fn(x + h / 2.0) - fn(x - h / 2.0)) / h
