"""Isotropic exponential ionosphere fits (port of raytrace_tpu/models/ionosphere.py).

n = n0 exp(-k (r - r0)) cm^-3 with r in RE; the two reference fits are
parameter sets of the same function.
"""

import torch

# (n0 [cm^-3], decay k, offset r0 [RE]) for the two reference fits
TRACED_FIT = (1.8e5, 4.183119, 1.0471)
IRI_DAYSIDE_FIT = (1.0e5, 10.0, 1.0471)


def ne_iono_cm3(r, n0, decay, r0):
    """Ionospheric electron density in cm^-3 at radius r (RE)."""
    return n0 * torch.exp(-decay * (r - r0))
