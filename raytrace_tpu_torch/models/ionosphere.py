"""Isotropic exponential ionosphere fits (port of raytrace_tpu/models/ionosphere.py).

n = n0 exp(-k (r - r0)) cm^-3 with r in RE; the reference fits are
parameter sets of the same function. The day/night medium blends the IRI
dayside and nightside fits by the smooth MLT weight `day_weight`.
"""

import math

import torch

# (n0 [cm^-3], decay k, offset r0 [RE]) for the two reference fits
TRACED_FIT = (1.8e5, 4.183119, 1.0471)
IRI_DAYSIDE_FIT = (1.0e5, 10.0, 1.0471)
# nightside companion of the dayside IRI fit: one decade lower peak
# density, slightly softer topside falloff (plasmasphere.jl:110-113 plans
# the day/night interpolation)
IRI_NIGHTSIDE_FIT = (1.0e4, 8.0, 1.0471)


def ne_iono_cm3(r, n0, decay, r0):
    """Ionospheric electron density in cm^-3 at radius r (RE)."""
    return n0 * torch.exp(-decay * (r - r0))


def day_weight(mlt):
    """Smooth dayside weight in [0, 1] from magnetic local time (hours):
    1 at noon, 0 at midnight, cosine in between. A host-side scalar."""
    return 0.5 * (1.0 - math.cos(2.0 * math.pi * mlt / 24.0))


def ne_iono_mlt_cm3(r, mlt, day_fit=IRI_DAYSIDE_FIT,
                    night_fit=IRI_NIGHTSIDE_FIT):
    """Day/night-interpolated ionosphere density (cm^-3) at radius r (RE)
    and magnetic local time mlt (hours, a Python float or a tensor): the
    day_weight blend of the dayside and nightside fits."""
    if isinstance(mlt, torch.Tensor):
        w = 0.5 * (1.0 - torch.cos(2.0 * math.pi * mlt / 24.0))
    else:
        w = day_weight(mlt)
    return w * ne_iono_cm3(r, *day_fit) + (1.0 - w) * ne_iono_cm3(
        r, *night_fit
    )
