"""Bounce-averaged azimuthal drift and MLT drift-averaging (port of
raytrace_tpu/drift.py).

The gradient-curvature drift on the centred dipole, bounce-averaged with
the dt = ds / (v |cos a|) weight of diffusion.bounce_averaged:

    dphi/dt = 3 gamma m v^2 (cos^2 a + sin^2 a / 2) (1 + s^2)
              / (q B r^2 (1+3s^2)^{3/2}),   s = sin lambda,

(the equatorial limit is Omega_d = 3 gamma m v^2 L / (2 q B0 RE^2)), and
the drift-orbit average of per-MLT-sector diffusion maps. Derivation
and validation are the JAX module's. Device and dtype as in
placement.py.
"""

import math
import numbers

import numpy as np
import torch

from .constants import B0_3D, M_E, Q_E, RE
from .diffusion import bounce_nodes, kinematics, mirror_latitude
from .placement import place


def drift_rate(e_kev, alpha_eq_rad, l_shell, b0=B0_3D, n_lat=96,
               n_bisect=60, device=None):
    """Bounce-averaged drift angular frequency <dphi/dt> [rad/s].

    e_kev and alpha_eq_rad broadcast together; l_shell and b0 are
    scalars (one field-line family). Returns dict omega_d [rad/s],
    t_drift_s = 2 pi / omega_d [s], mirror_lat_rad."""
    e_kev, alpha_eq = torch.broadcast_tensors(
        *place(e_kev, alpha_eq_rad, device=device))
    gamma, v, _ = kinematics(e_kev)
    lam_m = mirror_latitude(alpha_eq, n_bisect=n_bisect)
    lam, dlam = bounce_nodes(lam_m, n_lat)

    s, c = torch.sin(lam), torch.cos(lam)
    one3s2 = 1.0 + 3.0 * s * s
    b_ratio = torch.sqrt(one3s2) / c**6                  # B / B_eq
    s2a = torch.clamp(torch.sin(alpha_eq[..., None]) ** 2 * b_ratio, 0.0,
                      1.0)
    cosa = torch.sqrt(torch.clamp(1.0 - s2a, min=0.0))

    L = float(l_shell)
    r_re = L * c * c                                     # radius [RE]
    b_t = (float(b0) / r_re**3) * torch.sqrt(one3s2)     # |B| [T]
    r_m = r_re * RE

    # v_par^2 + v_perp^2/2 = v^2 (1 - s2a/2)
    pitch_fac = 1.0 - 0.5 * s2a
    rate = (3.0 * gamma[..., None] * M_E * v[..., None] ** 2 * pitch_fac
            * (1.0 + s * s)
            / (Q_E * b_t * r_m * r_m * one3s2 ** 1.5))

    # bounce-average weights dt = ds / (v |cos a|); v constant cancels
    jarc = L * c * torch.sqrt(one3s2) * RE
    wline = jarc * dlam / torch.clamp(cosa, min=1.0e-12)
    omega = (rate * wline).sum(dim=-1) / wline.sum(dim=-1)

    return {
        "omega_d": omega,
        "t_drift_s": 2.0 * math.pi / torch.clamp(omega, min=1.0e-300),
        "mirror_lat_rad": lam_m,
    }


def drift_average(sector_maps, weights=None, device=None):
    """Drift-orbit average of per-MLT-sector bounce-averaged tensors.

    sector_maps: dicts as bounce_averaged returns them; every key common
    to all with a numeric value (a number, an array or a tensor) is
    averaged, others are dropped. weights: each sector's occupancy
    fraction along the drift orbit (default equal), normalized here.
    A key's values average on their tensors' device (placement.py)."""
    if not sector_maps:
        raise ValueError("sector_maps must be non-empty")
    if weights is None:
        w = np.full(len(sector_maps), 1.0 / len(sector_maps))
    else:
        w = np.asarray(weights, np.float64)
        if w.shape[0] != len(sector_maps) or (w < 0.0).any():
            raise ValueError("weights must be >= 0, one per sector")
        w = w / w.sum()
    keys = set(sector_maps[0])
    for m in sector_maps[1:]:
        keys &= set(m)
    out = {}
    for k in sorted(keys):
        vals = [m[k] for m in sector_maps]
        if not all(isinstance(x, (numbers.Number, np.ndarray, torch.Tensor))
                   and not isinstance(x, bool) for x in vals):
            continue    # non-numeric entry
        out[k] = sum(float(wi) * x
                     for wi, x in zip(w, place(*vals, device=device)))
    return out
