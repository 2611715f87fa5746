"""Geomagnetic field models: the centered dipole, the tilted dipole and
the degree-3 IGRF truncation.

Port of raytrace_tpu/models/dipole.py: the latitude form of the 2D
frames, the vector field of the 3D frame, and the two non-axial fields
with the magnetic latitude and longitude of their tilted frame. Plain
functions on tensors; radii in RE, angles in radians.
"""

import functools
import math

import numpy as np
import torch


def b_mag_lat(r, lat, b0):
    """|B|(r, lat) = b0 / r^3 * sqrt(1 + 3 sin^2(lat)). RayTrace_lat.jl:66."""
    s = torch.sin(lat)
    return b0 * torch.sqrt(1.0 + 3.0 * s * s) / (r * r * r)


def b_mag_colat(r, theta, b0):
    """|B|(r, theta) with colatitude theta (rad). Reference: RayMain.jl:150."""
    c = torch.cos(theta)
    return b0 * torch.sqrt(1.0 + 3.0 * c * c) / (r * r * r)


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


def dip_angle_colat(theta):
    """Dip angle, colatitude form: atan(2 cot theta) (RayMain.jl:128)."""
    return torch.atan(2.0 / torch.tan(theta))


def l_shell(r, lat):
    """McIlwain L-shell of the dipole line through (r, lat): r / cos^2 lat."""
    c = torch.cos(lat)
    return r / (c * c)


# ---------------------------------------------------------------------------
# Non-axial fields: the tilted centered dipole and the degree-3 IGRF
# truncation (raytrace_tpu/models/dipole.py:40-240). The tilt's sines and
# cosines are env scalars formed in double on the host (moment_unit,
# mlon_axes); a tensor op with such a Python float computes in the tensor's
# dtype. Each geometry function returns its values alone, or with
# tangents=True the values and their d/dr, d/dtheta, d/dphi, every one a
# scalar per ray: the closed forms that the JAX package takes from
# jax.linearize, written out so that ops/fused.py::mu_and_grads_3d_general
# and the CUDA step kernel (csrc/step_chunk.cu) perform the same operations
# in the same order.


@functools.lru_cache(maxsize=64)
def moment_unit(tilt, phi0):
    """Unit dipole-moment vector (Cartesian, Python floats) tilted by
    `tilt` (rad) from the -z axis toward geographic longitude `phi0`;
    tilt = 0 is the centered axial dipole of b_vec_colat."""
    st, ct = math.sin(tilt), math.cos(tilt)
    return st * math.cos(phi0), st * math.sin(phi0), -ct


@functools.lru_cache(maxsize=64)
def mlon_axes(tilt, phi0):
    """(x_m, y_m): the geographic x and y axes carried by the geodesic
    rotation Rz(phi0) Ry(-tilt) Rz(-phi0) that takes the geographic pole
    onto the magnetic north axis -moment_unit (Python floats); the
    magnetic longitude is atan2(y_m . rhat, x_m . rhat)."""
    s, c = math.sin(tilt), math.cos(tilt)
    s0, c0 = math.sin(phi0), math.cos(phi0)
    xm = (c * c0 * c0 + s0 * s0, (c - 1.0) * s0 * c0, s * c0)
    ym = ((c - 1.0) * s0 * c0, c * s0 * s0 + c0 * c0, s * s0)
    return xm, ym


def _moment_components(st, ct, sp, cp, tilt, phi0):
    """The moment unit vector on the local spherical basis (m . rhat,
    m . thetahat, m . phihat) from the sines and cosines of theta, phi."""
    mx, my, mz = moment_unit(tilt, phi0)
    m_r = mx * st * cp + my * st * sp + mz * ct
    m_t = mx * ct * cp + my * ct * sp - mz * st
    m_p = -mx * sp + my * cp
    return m_r, m_t, m_p


def tilted_field(r, theta, phi, b0, tilt, phi0=0.0, tangents=False):
    """Tilted-dipole field (B_r, B_theta, B_phi) at geographic (r, theta,
    phi): B = (b0/r^3)(3 (m . rhat) rhat - m) on the local spherical basis,
    B_r = 2 k (m . rhat), B_theta = -k (m . thetahat), B_phi = -k
    (m . phihat) with k = b0/r^3. With tangents=True returns (B, dB/dr,
    dB/dtheta, dB/dphi), four triples: every component scales as 1/r^3,
    d(m . rhat)/dtheta = m . thetahat, d(m . thetahat)/dtheta = -(m . rhat),
    d(m . rhat)/dphi = sin(theta) (m . phihat), d(m . thetahat)/dphi =
    cos(theta) (m . phihat), d(m . phihat)/dphi = -(mx cos phi + my sin
    phi)."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    m_r, m_t, m_p = _moment_components(st, ct, sp, cp, tilt, phi0)
    inv_r = 1.0 / r
    k = b0 * (inv_r * inv_r * inv_r)
    k2 = 2.0 * k
    b = (k2 * m_r, -k * m_t, -k * m_p)
    if not tangents:
        return b
    mx, my, _ = moment_unit(tilt, phi0)
    m3 = -3.0 * inv_r
    d_r = (b[0] * m3, b[1] * m3, b[2] * m3)
    d_t = (k2 * m_t, k * m_r, torch.zeros_like(m_r))
    d_p = (k2 * (st * m_p), -k * (ct * m_p), k * (mx * cp + my * sp))
    return b, d_r, d_t, d_p


def b_vec_tilted(r, theta, phi, b0, tilt, phi0=0.0):
    """Tilted-dipole field (B_r, B_theta, B_phi); tilt = 0 reduces to
    b_vec_colat. A 3D-frame-only medium (guarded in models/medium.py)."""
    return tilted_field(r, theta, phi, b0, tilt, phi0)


def mlat_sin_tilted(theta, phi, tilt, phi0=0.0):
    """sin(magnetic latitude) in the tilted frame: -(m . rhat); cos(theta)
    for tilt = 0. The density models are organized by magnetic latitude."""
    return -_moment_components(torch.sin(theta), torch.cos(theta),
                               torch.sin(phi), torch.cos(phi), tilt, phi0)[0]


def mlon_tilted(theta, phi, tilt, phi0=0.0):
    """Magnetic longitude at geographic (theta, phi) in the tilted frame:
    atan2(y_m . rhat, x_m . rhat) with the rotated axes of mlon_axes.
    tilt = 0 gives phi up to rounding (the value still passes through
    atan2). 2 pi-discontinuous across the atan2 cut, but every consumer
    reads it through sin/cos of a0 + phi_m only."""
    return magnetic_coords(theta, phi, tilt, phi0)[1]


def magnetic_coords(theta, phi, tilt, phi0=0.0, tangents=False):
    """(mlat, mlon) of the tilted frame at geographic (theta, phi): mlat =
    asin(clip(-(m . rhat), -1, 1)), mlon as in mlon_tilted. With
    tangents=True returns ((mlat, mlon), d/dtheta pair, d/dphi pair)
    (neither depends on r): d mlat = d s / sqrt(1 - s^2), with a zero
    tangent where the clip is active (jax.linearize's convention), and
    d mlon = (x dy - y dx)/(x^2 + y^2); reciprocals formed once."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    m_r, m_t, m_p = _moment_components(st, ct, sp, cp, tilt, phi0)
    xm, ym = mlon_axes(tilt, phi0)
    s = -m_r
    sc = torch.clamp(s, -1.0, 1.0)
    mlat = torch.asin(sc)
    rx, ry, rz = st * cp, st * sp, ct
    y = ym[0] * rx + ym[1] * ry + ym[2] * rz
    x = xm[0] * rx + xm[1] * ry + xm[2] * rz
    mlon = torch.atan2(y, x)
    if not tangents:
        return mlat, mlon
    inside = (s > -1.0) & (s < 1.0)
    zero = torch.zeros_like(s)
    inv_c = 1.0 / torch.sqrt(1.0 - sc * sc)
    mlat_t = torch.where(inside, -m_t, zero) * inv_c
    mlat_p = torch.where(inside, -(st * m_p), zero) * inv_c
    # d rhat/dtheta = (ct cp, ct sp, -st); d rhat/dphi = (-ry, rx, 0)
    rx_t, ry_t = ct * cp, ct * sp
    y_t = ym[0] * rx_t + ym[1] * ry_t - ym[2] * st
    x_t = xm[0] * rx_t + xm[1] * ry_t - xm[2] * st
    y_p = ym[1] * rx - ym[0] * ry
    x_p = xm[1] * rx - xm[0] * ry
    inv_h = 1.0 / (x * x + y * y)
    mlon_t = (x * y_t - y * x_t) * inv_h
    mlon_p = (x * y_p - y * x_p) * inv_h
    return (mlat, mlon), (mlat_t, mlon_t), (mlat_p, mlon_p)


# Schmidt quasi-normalized coefficients of IGRF-13, epoch 2020.0, in nT,
# degrees 1-3, ordered (g10, g11, h11, g20, g21, h21, g22, h22, g30, g31,
# h31, g32, h32, g33, h33). Degree 1 alone is the tilted centered dipole;
# degrees 2-3 add the quadrupole and octupole asymmetries.
IGRF13_2020 = (
    -29404.8, -1450.9, 4652.5,
    -2499.6, 2982.0, -2991.6, 1677.0, -734.6,
    1363.2, -2381.2, -82.1, 1236.2, 241.9, 525.7, -543.4,
)

_RT3, _RT6, _RT15, _RT10 = (1.7320508075688772, 2.449489742783178,
                            3.872983346207417, 3.1622776601683795)


def igrf_dipole(coeffs):
    """(b0 [T], tilt [rad], phi0 [rad]) of the degree-1 (centered-dipole)
    part of an IGRF coefficient set, in moment_unit's convention (tilt
    from -z toward longitude phi0; 0 for a purely axial negative g10). It
    organizes the density models. numpy on the host, as in the JAX
    package."""
    g10, g11, h11 = (float(c) for c in coeffs[:3])
    b0 = np.sqrt(g10 * g10 + g11 * g11 + h11 * h11) * 1.0e-9
    tilt = np.arccos(np.clip(-g10 * 1.0e-9 / b0, -1.0, 1.0))
    phi0 = np.arctan2(h11, g11)
    return float(b0), float(tilt), float(phi0)


def igrf_field(r, theta, phi, coeffs, tangents=False):
    """(B_r, B_theta, B_phi) in T of the degree-3 IGRF truncation at
    geographic (r [RE], theta, phi): B = -grad V, V = a sum_n (a/r)^(n+1)
    sum_m (g cos m phi + h sin m phi) P_nm with closed-form Schmidt P_nm
    for n <= 3. Cubes are written s * s * s (never pow). With
    tangents=True returns (B, dB/dr, dB/dtheta, dB/dphi), four triples:
    the radial factors differentiate to -(n + 2)/r times themselves, the
    theta tangents need the second derivatives of P_nm, the phi tangents
    the sums with m^2; the clamp max(sin theta, 1e-12) of B_phi has a zero
    tangent where it is active (jax.linearize's convention)."""
    (g10, g11, h11, g20, g21, h21, g22, h22,
     g30, g31, h31, g32, h32, g33, h33) = coeffs
    s, c = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    s2p = 2.0 * sp * cp               # sin 2phi
    c2p = cp * cp - sp * sp           # cos 2phi
    s3p = s2p * cp + c2p * sp         # sin 3phi
    c3p = c2p * cp - s2p * sp         # cos 3phi

    # Schmidt P_nm and d P_nm/d theta
    p10, d10 = c, -s
    p11, d11 = s, c
    p20, d20 = 1.5 * c * c - 0.5, -3.0 * s * c
    p21, d21 = _RT3 * s * c, _RT3 * (c * c - s * s)
    p22, d22 = 0.5 * _RT3 * s * s, _RT3 * s * c
    c5 = 5.0 * c * c - 1.0
    p30, d30 = 2.5 * c * c * c - 1.5 * c, -1.5 * s * c5
    p31 = 0.25 * _RT6 * s * c5
    d31 = 0.25 * _RT6 * (c * c5 - 10.0 * c * s * s)
    p32 = 0.5 * _RT15 * s * s * c
    d32 = 0.5 * _RT15 * (2.0 * s * c * c - s * s * s)
    p33, d33 = 0.25 * _RT10 * s * s * s, 0.75 * _RT10 * s * s * c

    inv_r = 1.0 / r
    f1 = inv_r * inv_r * inv_r        # (a/r)^(n+2) with a = 1 RE
    f2 = f1 * inv_r
    f3 = f2 * inv_r

    # azimuthal factors (g cos m phi + h sin m phi) and m (g sin - h cos)
    a11, q11 = g11 * cp + h11 * sp, g11 * sp - h11 * cp
    a21, q21 = g21 * cp + h21 * sp, g21 * sp - h21 * cp
    a22, q22 = g22 * c2p + h22 * s2p, 2.0 * (g22 * s2p - h22 * c2p)
    a31, q31 = g31 * cp + h31 * sp, g31 * sp - h31 * cp
    a32, q32 = g32 * c2p + h32 * s2p, 2.0 * (g32 * s2p - h32 * c2p)
    a33, q33 = g33 * c3p + h33 * s3p, 3.0 * (g33 * s3p - h33 * c3p)
    # per-degree sums with P (t), dP/dtheta (dt) and the phi-derivative (pt)
    t1 = g10 * p10 + a11 * p11
    dt1 = g10 * d10 + a11 * d11
    pt1 = q11 * p11
    t2 = g20 * p20 + a21 * p21 + a22 * p22
    dt2 = g20 * d20 + a21 * d21 + a22 * d22
    pt2 = q21 * p21 + q22 * p22
    t3 = g30 * p30 + a31 * p31 + a32 * p32 + a33 * p33
    dt3 = g30 * d30 + a31 * d31 + a32 * d32 + a33 * d33
    pt3 = q31 * p31 + q32 * p32 + q33 * p33

    nt = 1.0e-9
    s_min = 1.0e-12
    inv_s = 1.0 / torch.clamp_min(s, s_min)
    sum_p = f1 * pt1 + f2 * pt2 + f3 * pt3
    br = nt * (2.0 * f1 * t1 + 3.0 * f2 * t2 + 4.0 * f3 * t3)
    btheta = -nt * (f1 * dt1 + f2 * dt2 + f3 * dt3)
    bphi = nt * inv_s * sum_p
    b = (br, btheta, bphi)
    if not tangents:
        return b

    # second theta-derivatives of P_nm
    e10, e11 = -c, -s
    e20, e21, e22 = -3.0 * (c * c - s * s), -4.0 * _RT3 * s * c, d21
    e30 = -1.5 * (c * c5 - 10.0 * c * s * s)
    e31 = 0.25 * _RT6 * (10.0 * s * s * s - s * c5 - 30.0 * c * c * s)
    e32 = 0.5 * _RT15 * (2.0 * c * c * c - 7.0 * s * s * c)
    e33 = 0.75 * _RT10 * (2.0 * s * c * c - s * s * s)
    ddt1 = g10 * e10 + a11 * e11
    ddt2 = g20 * e20 + a21 * e21 + a22 * e22
    ddt3 = g30 * e30 + a31 * e31 + a32 * e32 + a33 * e33
    # m (g sin - h cos) against dP/dtheta, and m^2 (g cos + h sin) against P
    dpt1 = q11 * d11
    dpt2 = q21 * d21 + q22 * d22
    dpt3 = q31 * d31 + q32 * d32 + q33 * d33
    ppt1 = a11 * p11
    ppt2 = a21 * p21 + 4.0 * a22 * p22
    ppt3 = a31 * p31 + 4.0 * a32 * p32 + 9.0 * a33 * p33

    nt_r = nt * inv_r
    sum_dp = f1 * dpt1 + f2 * dpt2 + f3 * dpt3
    d_r = (
        -nt_r * (6.0 * f1 * t1 + 12.0 * f2 * t2 + 20.0 * f3 * t3),
        nt_r * (3.0 * f1 * dt1 + 4.0 * f2 * dt2 + 5.0 * f3 * dt3),
        -nt_r * inv_s * (3.0 * f1 * pt1 + 4.0 * f2 * pt2 + 5.0 * f3 * pt3),
    )
    c_eff = torch.where(s > s_min, c, torch.zeros_like(c))
    d_t = (
        nt * (2.0 * f1 * dt1 + 3.0 * f2 * dt2 + 4.0 * f3 * dt3),
        -nt * (f1 * ddt1 + f2 * ddt2 + f3 * ddt3),
        nt * (inv_s * sum_dp - inv_s * inv_s * c_eff * sum_p),
    )
    d_p = (
        -nt * (2.0 * f1 * pt1 + 3.0 * f2 * pt2 + 4.0 * f3 * pt3),
        nt * sum_dp,
        nt * inv_s * (f1 * ppt1 + f2 * ppt2 + f3 * ppt3),
    )
    return b, d_r, d_t, d_p


def b_vec_igrf(r, theta, phi, coeffs):
    """(B_r, B_theta, B_phi) in T of the degree-3 IGRF truncation."""
    return igrf_field(r, theta, phi, coeffs)


def igrf_potential(r, theta, phi, coeffs):
    """Scalar potential V (T * RE) whose -gradient is b_vec_igrf: the
    autodiff oracle of the closed forms above (tests only)."""
    (g10, g11, h11, g20, g21, h21, g22, h22,
     g30, g31, h31, g32, h32, g33, h33) = coeffs
    s, c = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    p10, p11 = c, s
    p20, p21, p22 = 1.5 * c * c - 0.5, _RT3 * s * c, 0.5 * _RT3 * s * s
    p30 = 2.5 * c * c * c - 1.5 * c
    p31 = 0.25 * _RT6 * s * (5.0 * c * c - 1.0)
    p32 = 0.5 * _RT15 * s * s * c
    p33 = 0.25 * _RT10 * s * s * s
    c2p, s2p = torch.cos(2 * phi), torch.sin(2 * phi)
    c3p, s3p = torch.cos(3 * phi), torch.sin(3 * phi)
    t1 = g10 * p10 + (g11 * cp + h11 * sp) * p11
    t2 = (g20 * p20 + (g21 * cp + h21 * sp) * p21
          + (g22 * c2p + h22 * s2p) * p22)
    t3 = (g30 * p30 + (g31 * cp + h31 * sp) * p31
          + (g32 * c2p + h32 * s2p) * p32 + (g33 * c3p + h33 * s3p) * p33)
    inv_r = 1.0 / r
    return 1.0e-9 * (
        inv_r * inv_r * t1 + inv_r * inv_r * inv_r * t2
        + inv_r * inv_r * inv_r * inv_r * t3
    )
