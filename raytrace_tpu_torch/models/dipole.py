"""Centered-dipole geomagnetic field.

Port of raytrace_tpu/models/dipole.py (the centered-dipole subset: the
latitude form of the 2D frames and the vector field of the 3D frame).
Plain functions on tensors; radii in RE, angles in radians.
"""

import math

import torch


def b_mag_lat(r, lat, b0):
    """|B|(r, lat) = b0 / r^3 * sqrt(1 + 3 sin^2(lat)). RayTrace_lat.jl:66."""
    s = torch.sin(lat)
    return b0 * torch.sqrt(1.0 + 3.0 * s * s) / (r * r * r)


def b_vec_colat(r, theta, phi, b0):
    """Vector dipole field (B_r, B_theta, B_phi) at (r, theta, phi), theta
    the colatitude: B_r = -2 b0 sin(lat)/r^3, B_theta = -b0 cos(lat)/r^3,
    B_phi = 0 with lat = pi/2 - theta (RayTrace_3D.jl:54-66)."""
    lat = math.pi / 2.0 - theta
    inv_r3 = 1.0 / (r * r * r)
    br = -2.0 * b0 * inv_r3 * torch.sin(lat)
    btheta = -b0 * inv_r3 * torch.cos(lat)
    bphi = torch.zeros_like(br)
    return br, btheta, bphi


def dip_angle_lat(lat):
    """Dip angle between the horizontal and B: atan(2 tan lat)."""
    return torch.atan(2.0 * torch.tan(lat))


def l_shell(r, lat):
    """McIlwain L-shell of the dipole line through (r, lat): r / cos^2 lat."""
    c = torch.cos(lat)
    return r / (c * c)
