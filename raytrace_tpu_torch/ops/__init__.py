"""Compute path: dispersion, gradients, Haselgrove RHS, the step kernel."""

from . import dispersion, gradients, rhs

__all__ = ["dispersion", "gradients", "rhs"]
