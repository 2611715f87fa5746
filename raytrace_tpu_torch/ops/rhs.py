"""Haselgrove ray equations (port of raytrace_tpu/ops/rhs.py).

Three frames, the state in the last dimension: the 2D latitude frame
u = (r, lat, chi, T), the 2D colatitude frame u = (r, theta, chi, T) and
the 3D Kimura frame u = (r, theta, phi, rho_r, rho_theta, rho_phi, T). r is in RE, the independent variable t is phase
path in RE, T is group delay in seconds, f is a parameter (Hz). u is
(..., n) and f is (...,), so a function serves a (B, n) batch and, under
torch.func.vmap, a single (n,) ray.

legacy_freq_state=True reproduces the 2D reference scripts' quirk: they
integrate the group delay into the frequency slot, so the frequency drifts
by the accumulated group delay (RayMain.jl:328 vs :344); the 2D right-hand
sides then read it as f + T. The 3D frame has no such quirk
(RayTrace_3D.jl:334).
"""

import torch

from ..constants import RE_OVER_C
from ..models import medium
from . import gradients


def rhs_2d_lat(u, f, env: medium.EnvParams, legacy_freq_state=False,
               grad_mode=gradients.FUSED, root=1.0):
    """du/dt for the latitude-frame 2D ray (RayTrace_lat.jl:270-273)."""
    r, lat, chi = u[..., 0], u[..., 1], u[..., 2]
    freq = f + u[..., 3] if legacy_freq_state else f
    mu, dmudr, dmudlat, dmudpsi, dmudf = gradients.mu_grads_2d_lat(
        r, lat, chi, freq, env, grad_mode, root
    )
    sinchi, coschi = torch.sin(chi), torch.cos(chi)
    inv_mu2 = 1.0 / (mu * mu)
    inv_mu2_r = inv_mu2 * (1.0 / r)
    dr = inv_mu2 * (mu * coschi + dmudpsi * sinchi)
    dlat = inv_mu2_r * (mu * sinchi - dmudpsi * coschi)
    dchi = inv_mu2_r * (dmudlat * coschi - (r * dmudr + mu) * sinchi)
    dT = RE_OVER_C * (1.0 + (freq * mu * inv_mu2) * dmudf)
    return torch.stack([dr, dlat, dchi, dT], dim=-1)


def rhs_2d_colat(u, f, env: medium.EnvParams, legacy_freq_state=False,
                 grad_mode=gradients.FUSED, root=1.0):
    """du/dt for the colatitude-frame 2D ray (RayMain.jl:341-344); the
    sign flips against the latitude form follow lat = pi/2 - theta."""
    r, theta, chi = u[..., 0], u[..., 1], u[..., 2]
    freq = f + u[..., 3] if legacy_freq_state else f
    mu, dmudr, dmudtheta, dmudpsi, dmudf = gradients.mu_grads_2d_colat(
        r, theta, chi, freq, env, grad_mode, root
    )
    sinchi, coschi = torch.sin(chi), torch.cos(chi)
    inv_mu2 = 1.0 / (mu * mu)
    inv_mu2_r = inv_mu2 * (1.0 / r)
    dr = inv_mu2 * (mu * coschi - dmudpsi * sinchi)
    dtheta = inv_mu2_r * (mu * sinchi + dmudpsi * coschi)
    dchi = inv_mu2_r * (dmudtheta * coschi - (r * dmudr + mu) * sinchi)
    dT = RE_OVER_C * (1.0 + (freq * mu * inv_mu2) * dmudf)
    return torch.stack([dr, dtheta, dchi, dT], dim=-1)


def rhs_3d(u, f, env: medium.EnvParams, grad_mode=gradients.FUSED,
           root=1.0):
    """du/dt for the 3D ray (RayTrace_3D.jl:350-356), f a true parameter."""
    r, theta = u[..., 0], u[..., 1]
    rho_r, rho_t, rho_p = u[..., 3], u[..., 4], u[..., 5]
    mu, (dmudr, dmudtheta, dmudphi, dmudrr, dmudrt, dmudrp, dmudf) = (
        gradients.mu_grads_3d(r, theta, u[..., 2], rho_r, rho_t, rho_p, f,
                              env, grad_mode, root)
    )
    sintheta, costheta = torch.sin(theta), torch.cos(theta)
    inv_mu2 = 1.0 / (mu * mu)
    inv_mu = mu * inv_mu2
    inv_r = 1.0 / r
    inv_st = 1.0 / sintheta
    inv_mu2_r = inv_mu2 * inv_r
    dr = inv_mu2 * (rho_r - mu * dmudrr)
    dtheta = inv_mu2_r * (rho_t - mu * dmudrt)
    dphi = inv_mu2_r * inv_st * (rho_p - mu * dmudrp)
    drho_r = dmudr * inv_mu + rho_t * dtheta + rho_p * dphi * sintheta
    drho_t = (
        dmudtheta * inv_mu - rho_t * dr + r * rho_p * dphi * costheta
    ) * inv_r
    drho_p = (
        dmudphi * inv_mu - rho_p * dr * sintheta - r * rho_p * dtheta * costheta
    ) * (inv_r * inv_st)
    dT = RE_OVER_C * (1.0 + (f * inv_mu) * dmudf)
    return torch.stack([dr, dtheta, dphi, drho_r, drho_t, drho_p, dT], dim=-1)


# frame name -> (right-hand side, index of the group delay in the state)
# the refusal of legacy_freq_state in the 3D frame, the JAX package's words
LEGACY_3D = ("legacy_freq_state is a 2D-script quirk; the 3D frame already "
             "treats frequency as a parameter (RayTrace_3D.jl:334)")

FRAMES = {"2d_lat": (rhs_2d_lat, 3), "2d_colat": (rhs_2d_colat, 3),
          "3d": (rhs_3d, 6)}


def frame_rhs(frame, env: medium.EnvParams, root=1.0,
              grad_mode=gradients.FUSED, legacy_freq_state=False):
    """(rhs_fn(u, f), group_idx) of a frame: the one dispatch the tracer
    and the step kernel's plain version share, so that every knob reaches
    every frame (the JAX package's parallel/ensemble.py::_frame_rhs). The
    3D frame refuses legacy_freq_state."""
    if frame not in FRAMES:
        raise ValueError(f"unknown frame {frame!r}; the frames are "
                         f"{sorted(FRAMES)}")
    fn, group_idx = FRAMES[frame]
    if frame == "3d" and legacy_freq_state:
        raise ValueError(LEGACY_3D)
    # the modes are passed only where they are on
    kw = {"root": root}
    if grad_mode != gradients.FUSED:
        kw["grad_mode"] = grad_mode
    if legacy_freq_state:
        kw["legacy_freq_state"] = True
    return (lambda u, f: fn(u, f, env, **kw)), group_idx
