"""Centered-dipole geomagnetic field, latitude form.

Port of raytrace_tpu/models/dipole.py (the 2D latitude-frame subset).
Plain functions on tensors; radii in RE, angles in radians.
"""

import torch


def b_mag_lat(r, lat, b0):
    """|B|(r, lat) = b0 / r^3 * sqrt(1 + 3 sin^2(lat)). RayTrace_lat.jl:66."""
    s = torch.sin(lat)
    return b0 * torch.sqrt(1.0 + 3.0 * s * s) / (r * r * r)


def dip_angle_lat(lat):
    """Dip angle between the horizontal and B: atan(2 tan lat)."""
    return torch.atan(2.0 * torch.tan(lat))


def l_shell(r, lat):
    """McIlwain L-shell of the dipole line through (r, lat): r / cos^2 lat."""
    c = torch.cos(lat)
    return r / (c * c)
