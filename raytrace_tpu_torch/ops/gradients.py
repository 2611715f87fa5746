"""Gradient layer: mu and its partials in the 2D latitude and colatitude
frames and the 3D frame.

Port of raytrace_tpu/ops/gradients.py (fused and autodiff modes).
  "fused"    -- the hand-derived chains of ops/fused.py (the default, and
                the chains the CUDA step kernel inlines);
  "autodiff" -- torch.func.grad of dispersion.mu_2d_lat / mu_2d_colat /
                mu_3d: the
                cross-check that the fused chains are the exact
                derivatives of the traced mu = sqrt(|mu^2|).
The reference's mixed gradient set (grad_mode="reference") is ROADMAP A10.
"""

import math

import torch

from ..models import medium
from . import dispersion

AUTODIFF = "autodiff"
FUSED = "fused"


def _mu_sum(r, lat, chi, f, env, root):
    # each ray's mu depends on its own inputs only, so the gradient of the
    # batch sum is the per-ray gradient
    mu = dispersion.mu_2d_lat(r, lat, chi, f, env, root)
    return mu.sum(), mu


def _unported_mode(grad_mode):
    return NotImplementedError(
        f"grad_mode={grad_mode!r} is not ported yet (ROADMAP A10); "
        "the port has 'fused' and 'autodiff'"
    )


def mu_grads_2d_lat(r, lat, chi, f, env: medium.EnvParams, grad_mode=FUSED,
                    root=1.0):
    """(mu, dmu/dr, dmu/dlat, dmu/dpsi, dmu/df) at a latitude-frame state."""
    medium.check_env(env)
    medium.require_dipole_2d(env)
    if grad_mode == FUSED:
        from . import fused

        return fused.mu_and_grads_2d_lat(r, lat, chi, f, env, root)
    if grad_mode != AUTODIFF:
        raise _unported_mode(grad_mode)
    (dmudr, dmudlat, dmudchi, dmudf), mu = torch.func.grad(
        _mu_sum, argnums=(0, 1, 2, 3), has_aux=True
    )(r, lat, chi, f, env, root)
    return mu, dmudr, dmudlat, dmudchi, dmudf


def _mu_colat_sum(r, theta, chi, f, env, root):
    mu = dispersion.mu_2d_colat(r, theta, chi, f, env, root)
    return mu.sum(), mu


def mu_grads_2d_colat(r, theta, chi, f, env: medium.EnvParams,
                      grad_mode=FUSED, root=1.0):
    """(mu, dmu/dr, dmu/dtheta, dmu/dpsi, dmu/df) at a colatitude-frame
    state. dip(theta) = dip(lat = pi/2 - theta), so the fused latitude
    chain serves, with dmu/dtheta = -dmu/dlat."""
    medium.check_env(env)
    medium.require_dipole_2d(env)
    if grad_mode == FUSED:
        from . import fused

        mu, dmudr, dmudlat, dmudpsi, dmudf = fused.mu_and_grads_2d_lat(
            r, math.pi / 2.0 - theta, chi, f, env, root)
        return mu, dmudr, -dmudlat, dmudpsi, dmudf
    if grad_mode != AUTODIFF:
        raise _unported_mode(grad_mode)
    (dmudr, dmudtheta, dmudchi, dmudf), mu = torch.func.grad(
        _mu_colat_sum, argnums=(0, 1, 2, 3), has_aux=True
    )(r, theta, chi, f, env, root)
    return mu, dmudr, dmudtheta, dmudchi, dmudf


def _mu3_sum(r, theta, phi, rho_r, rho_t, rho_p, f, env, root):
    mu = dispersion.mu_3d(r, theta, phi, rho_r, rho_t, rho_p, f, env, root)
    return mu.sum(), mu


def mu_grads_3d(r, theta, phi, rho_r, rho_t, rho_p, f,
                env: medium.EnvParams, grad_mode=FUSED, root=1.0):
    """mu and its seven partials (r, theta, phi, rho_r, rho_t, rho_p, f)
    at a 3D state, as (mu, (partials...)). The fused chain of the centered
    dipole hand-codes its geometry; the tilted and IGRF fields go through
    the general chain (fused.mu_and_grads_3d_general)."""
    medium.check_env(env)
    if grad_mode == FUSED:
        from . import fused

        if env.b_model != "dipole":
            return fused.mu_and_grads_3d_general(
                r, theta, phi, rho_r, rho_t, rho_p, f, env, root)
        return fused.mu_and_grads_3d(r, theta, phi, rho_r, rho_t, rho_p, f,
                                     env, root)
    if grad_mode != AUTODIFF:
        raise _unported_mode(grad_mode)
    grads, mu = torch.func.grad(
        _mu3_sum, argnums=(0, 1, 2, 3, 4, 5, 6), has_aux=True
    )(r, theta, phi, rho_r, rho_t, rho_p, f, env, root)
    return mu, grads
