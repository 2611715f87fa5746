"""Gradient layer: mu and its four partials in the 2D latitude frame.

Port of raytrace_tpu/ops/gradients.py (fused and autodiff modes).
  "fused"    -- the hand-derived chain of ops/fused.py (the default, and
                the chain the CUDA step kernel inlines);
  "autodiff" -- torch.func.grad of dispersion.mu_2d_lat: the cross-check
                that the fused chain is the exact derivative of the traced
                mu = sqrt(|mu^2|).
The reference's mixed gradient set (grad_mode="reference") is ROADMAP A10.
"""

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


def mu_grads_2d_lat(r, lat, chi, f, env: medium.EnvParams, grad_mode=FUSED,
                    root=1.0):
    """(mu, dmu/dr, dmu/dlat, dmu/dpsi, dmu/df) at a latitude-frame state."""
    medium.check_env(env)
    if grad_mode == FUSED:
        from . import fused

        return fused.mu_and_grads_2d_lat(r, lat, chi, f, env, root)
    if grad_mode != AUTODIFF:
        raise NotImplementedError(
            f"grad_mode={grad_mode!r} is not ported yet (ROADMAP A10); "
            "the port has 'fused' and 'autodiff'"
        )
    (dmudr, dmudlat, dmudchi, dmudf), mu = torch.func.grad(
        _mu_sum, argnums=(0, 1, 2, 3), has_aux=True
    )(r, lat, chi, f, env, root)
    return mu, dmudr, dmudlat, dmudchi, dmudf
