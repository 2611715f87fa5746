"""Haselgrove ray equations, 2D latitude frame (port of raytrace_tpu/ops/rhs.py).

State u = (r, lat, chi, T) in the last dimension: r in RE, the
independent variable t is phase path in RE, T is group delay in seconds,
f is a parameter (Hz). u is (..., 4) and f is (...,), so the function
serves a (B, 4) batch and, under torch.func.vmap, a single (4,) ray.
"""

import torch

from ..constants import RE_OVER_C
from ..models import medium
from . import gradients


def rhs_2d_lat(u, f, env: medium.EnvParams, grad_mode=gradients.FUSED,
               root=1.0):
    """du/dt for the latitude-frame 2D ray (RayTrace_lat.jl:270-273)."""
    r, lat, chi = u[..., 0], u[..., 1], u[..., 2]
    mu, dmudr, dmudlat, dmudpsi, dmudf = gradients.mu_grads_2d_lat(
        r, lat, chi, f, env, grad_mode, root
    )
    sinchi, coschi = torch.sin(chi), torch.cos(chi)
    inv_mu2 = 1.0 / (mu * mu)
    inv_mu2_r = inv_mu2 * (1.0 / r)
    dr = inv_mu2 * (mu * coschi + dmudpsi * sinchi)
    dlat = inv_mu2_r * (mu * sinchi - dmudpsi * coschi)
    dchi = inv_mu2_r * (dmudlat * coschi - (r * dmudr + mu) * sinchi)
    dT = RE_OVER_C * (1.0 + (f * mu * inv_mu2) * dmudf)
    return torch.stack([dr, dlat, dchi, dT], dim=-1)
