"""Gradient layer: mu and its partials in the 2D latitude and colatitude
frames and the 3D frame.

Port of raytrace_tpu/ops/gradients.py.
  "fused"     -- the hand-derived chains of ops/fused.py (the default, and
                 the chains the CUDA step kernel inlines);
  "autodiff"  -- the exact derivatives of the traced mu = sqrt(|mu^2|)
                 in forward mode: dispersion.mu_2d_lat / mu_2d_colat /
                 mu_3d evaluated once on dual numbers (ops/dual.py), one
                 tangent row per input (4 in 2D, 7 in 3D), each op's
                 tangent by torch's forward-mode formula, as the step
                 kernel's AD instances compute it; the set the fused
                 chains are held to. In 2D dmu/dchi is dmu/dpsi.
  "reference" -- the gradient set the reference scripts integrate:
                 dmu/dpsi from its closed form (ops/analytic.py), dmu/dr
                 exactly 0 (their central difference steps r by 1e-11 m,
                 below half an ulp of r ~ 7.4e6 m), and in 3D the rho
                 partials from the Kimura chain over that dmu/dpsi. mu and
                 the angle and frequency partials come from the fused chain
                 here, where the JAX package takes them from autodiff: the
                 two are equal to 1e-11 (its gradients.py:40-43), and the
                 step kernel computes the fused values. The closed form
                 takes the density, |B| and cos psi the fused chain took.
                 Protons only, and in 3D the centered dipole only
                 (ValueError otherwise, as in the JAX package).
"""

import math

import torch

from ..models import medium
from . import analytic, dispersion, dual

AUTODIFF = "autodiff"
REFERENCE = "reference"
FUSED = "fused"
GRAD_MODES = (FUSED, AUTODIFF, REFERENCE)


def _require_protons_only(env):
    """grad_mode='reference' reproduces the reference's closed forms,
    which are written for the 2-species e-p plasma (RayMain.jl:154)."""
    if env.eta_he != 0.0 or env.eta_o != 0.0:
        raise ValueError(
            "grad_mode='reference' is protons-only (the reference has no "
            "ion composition); use the default fused/autodiff gradients"
        )


def require_reference_env(env):
    """The media the reference set takes, in every frame: protons only,
    the centered dipole (its Kimura chain is the axial dipole's)."""
    if env.b_model != "dipole":
        raise ValueError(
            "grad_mode='reference' reproduces the reference's centered-"
            f"dipole chain; b_model={env.b_model!r} is unsupported there"
        )
    _require_protons_only(env)


def _reference_2d(lat, chi, f, env, ne, bm, dmudr):
    """The reference set's (dmu/dr, dmu/dpsi) in the 2D frames: 0, and the
    closed form over the fused chain's density and |B| at the angle psi
    itself (dispersion.psi_lat; the JAX package's
    analytic.mu_dmudpsi_2d_lat)."""
    _require_protons_only(env)
    _, dmudpsi = analytic.mu_and_dmudpsi(ne, bm, f,
                                         dispersion.psi_lat(lat, chi))
    return torch.zeros_like(dmudr), dmudpsi


def _check_mode(grad_mode):
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}; the modes are "
                         f"{GRAD_MODES}")


def mu_grads_2d_lat(r, lat, chi, f, env: medium.EnvParams, grad_mode=FUSED,
                    root=1.0):
    """(mu, dmu/dr, dmu/dlat, dmu/dpsi, dmu/df) at a latitude-frame state."""
    medium.check_env(env)
    medium.require_dipole_2d(env)
    _check_mode(grad_mode)
    if grad_mode != AUTODIFF:
        from . import fused

        (mu, dmudr, dmudlat, dmudpsi, dmudf), (ne, bm) = (
            fused.mu_and_grads_2d_lat_medium(r, lat, chi, f, env, root))
        if grad_mode == REFERENCE:
            dmudr, dmudpsi = _reference_2d(lat, chi, f, env, ne, bm, dmudr)
        return mu, dmudr, dmudlat, dmudpsi, dmudf
    mu, (dmudr, dmudlat, dmudchi, dmudf) = dual.value_and_grads(
        dispersion.mu_2d_lat, (r, lat, chi, f), env, root)
    return mu, dmudr, dmudlat, dmudchi, dmudf


def mu_grads_2d_colat(r, theta, chi, f, env: medium.EnvParams,
                      grad_mode=FUSED, root=1.0):
    """(mu, dmu/dr, dmu/dtheta, dmu/dpsi, dmu/df) at a colatitude-frame
    state. dip(theta) = dip(lat = pi/2 - theta), so the fused latitude
    chain serves, with dmu/dtheta = -dmu/dlat."""
    medium.check_env(env)
    medium.require_dipole_2d(env)
    _check_mode(grad_mode)
    if grad_mode != AUTODIFF:
        from . import fused

        lat = math.pi / 2.0 - theta
        (mu, dmudr, dmudlat, dmudpsi, dmudf), (ne, bm) = (
            fused.mu_and_grads_2d_lat_medium(r, lat, chi, f, env, root))
        if grad_mode == REFERENCE:
            dmudr, dmudpsi = _reference_2d(lat, chi, f, env, ne, bm, dmudr)
        return mu, dmudr, -dmudlat, dmudpsi, dmudf
    mu, (dmudr, dmudtheta, dmudchi, dmudf) = dual.value_and_grads(
        dispersion.mu_2d_colat, (r, theta, chi, f), env, root)
    return mu, dmudr, dmudtheta, dmudchi, dmudf


def mu_grads_3d(r, theta, phi, rho_r, rho_t, rho_p, f,
                env: medium.EnvParams, grad_mode=FUSED, root=1.0):
    """mu and its seven partials (r, theta, phi, rho_r, rho_t, rho_p, f)
    at a 3D state, as (mu, (partials...)). The fused chain of the centered
    dipole hand-codes its geometry; the tilted and IGRF fields go through
    the general chain (fused.mu_and_grads_3d_general). The reference
    set (built around the axial dipole's Kimura chain) refuses the
    non-axial fields."""
    medium.check_env(env)
    _check_mode(grad_mode)
    if grad_mode == REFERENCE:
        require_reference_env(env)
    if grad_mode == FUSED:
        from . import fused

        if env.b_model != "dipole":
            return fused.mu_and_grads_3d_general(
                r, theta, phi, rho_r, rho_t, rho_p, f, env, root)
        return fused.mu_and_grads_3d(r, theta, phi, rho_r, rho_t, rho_p, f,
                                     env, root)
    if grad_mode == REFERENCE:
        return _mu_grads_3d_reference(r, theta, phi, rho_r, rho_t, rho_p, f,
                                      env, root)
    return dual.value_and_grads(
        dispersion.mu_3d, (r, theta, phi, rho_r, rho_t, rho_p, f), env,
        root)


def _mu_grads_3d_reference(r, theta, phi, rho_r, rho_t, rho_p, f, env, root):
    """The reference set in 3D (JAX gradients.py:161-174): the fused
    chain's mu and its theta, phi and f partials; dmu/dr = 0; the rho
    partials from the Kimura chain over the closed-form dmu/dpsi at psi =
    arccos(cos psi) (dispersion.psi_3d's angle), over the fused chain's
    density, |B|, cos psi and field direction (kimura_dmudrho's
    cos(alpha_Bk) is scale-free, so the unit vector serves). The closed
    form takes the density without longitude, as the reference has it
    (the JAX package's medium.ne_total_m3 without phi): over the
    MLT-resolved medium that is not the fused chain's, so the chain runs
    again at the medium's base parameters, as the step kernel's ALTX
    instances run it."""
    from . import fused

    (mu, grads), (ne, bm, cospsi, bhat_r, bhat_t) = (
        fused.mu_and_grads_3d_medium(r, theta, phi, rho_r, rho_t, rho_p, f,
                                     env, root))
    if medium.mlt_on(env):
        ne = fused._ne_and_grads(r, math.pi / 2.0 - theta, env)[0]
    psi = torch.arccos(cospsi)
    _, dmudpsi_ref = analytic.mu_and_dmudpsi(ne, bm, f, psi)
    kim = analytic.kimura_dmudrho(mu, dmudpsi_ref, psi,
                                  (bhat_r, bhat_t, torch.zeros_like(bhat_r)),
                                  (rho_r, rho_t, rho_p))
    # dmu/dr == 0 for the same sub-ulp central difference as in 2D
    return mu, (torch.zeros_like(grads[0]), grads[1], grads[2], *kim,
                grads[6])
