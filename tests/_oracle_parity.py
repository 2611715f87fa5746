"""The C++ float64 oracle's trajectory cases of tests/test_native.py and
tests/test_mlt3d.py, run through the port's float64 trace (dopri5, its
plain version on the CPU) against native.trace_*, each held to the band
the JAX test holds the JAX package to. The cases take 8-40 s each on a
CPU, so the files test_torch_oracle_*.py each run a few of them (the
driver spreads test files over workers)."""

import numpy as np
import torch

from raytrace_tpu import native
from raytrace_tpu.constants import RE
from raytrace_tpu.models import make_env, make_env_lat, make_env_raymain
from raytrace_tpu.ops.dispersion import consistent_rho_3d
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig, trace
from raytrace_tpu_torch.interop import env_from_numpy

R0 = (RE + 1.0e6) / RE
T_MAX = 5.0e9 / RE
COLAT = dict(lat_sign=-1.0, lat_offset=np.pi / 2)


def _port(env, u0, f, frame, rtol, atol, t_max, max_steps, **spec):
    """The port's trace of one ray (the JAX env's fields, float64)."""
    res = trace(env_from_numpy(env._asdict()),
                torch.tensor(np.asarray(u0, np.float64))[None],
                torch.tensor([f], dtype=torch.float64), frame=frame,
                cfg=SolverConfig(rtol=rtol, atol=atol, dt0=1e-4),
                spec=StopSpec(r_floor=1.0, t_max=t_max, **spec),
                max_steps=max_steps, chunk=256)
    return (res.u[0].numpy(), float(res.t[0]), int(res.status[0]))


def _l_shell(u):
    return u[0] / np.cos(u[1]) ** 2


def canonical_2d():
    """test_native_trace_parity: the RayTrace_lat ray at rtol 1e-9."""
    env = make_env_lat()
    u0 = np.array([R0, np.pi / 4, 0.0, 0.0])
    nat = native.trace_2d_lat(u0, 1000.0, env, rtol=1e-9, atol=1e-14,
                              t_max=T_MAX, max_steps=200000)
    u, _, st = _port(env, u0, 1000.0, "2d_lat", 1e-9, 1e-14, T_MAX, 200000)
    assert nat["status"] == st == events.HIT_EARTH
    assert abs(_l_shell(nat["u"]) / _l_shell(u) - 1.0) < 1e-4
    assert abs(nat["u"][3] / u[3] - 1.0) < 1e-5


def config4_3d():
    """test_native_3d_trajectory_parity: config 4's off-shell launch, the
    negative group delay in both."""
    env = make_env()
    u0 = np.array([R0, np.pi / 4, 0.0, 1.0, 1.0, 0.0, 0.0])
    nat = native.trace_3d(u0, 1000.0, env, rtol=1e-9, atol=1e-12,
                          t_max=T_MAX, max_steps=200000)
    u, _, st = _port(env, u0, 1000.0, "3d", 1e-9, 1e-12, T_MAX, 200000,
                     **COLAT)
    assert nat["status"] == st == events.HIT_EARTH
    np.testing.assert_allclose(nat["u"][1], u[1], atol=2e-5)
    assert nat["u"][6] < 0.0 and u[6] < 0.0
    assert abs(nat["u"][6] / u[6] - 1.0) < 1e-3


def raymain_colat():
    """test_native_colat_trace_parity: RayMain's ray in the colatitude
    frame."""
    env = make_env_raymain()
    u0 = np.array([R0, np.pi / 4, 0.0, 0.0])
    nat = native.trace_2d(u0, 5000.0, env, frame=native.FRAME_COLAT,
                          rtol=1e-9, atol=1e-14, t_max=T_MAX,
                          max_steps=200000)
    u, _, st = _port(env, u0, 5000.0, "2d_colat", 1e-9, 1e-14, T_MAX,
                     200000)
    assert nat["status"] == st == events.HIT_EARTH
    np.testing.assert_allclose(nat["u"][:2], u[:2], rtol=1e-3)
    assert abs(nat["u"][3] / u[3] - 1.0) < 1e-4


def duct_multiion():
    """test_native_trace_parity_duct_multiion: the duct and He+/O+."""
    env = make_env(b0=3.0696381e-5, duct_amp=0.5, duct_l0=2.6, duct_w=0.25,
                   eta_he=0.1, eta_o=0.05)
    u0 = np.array([R0, 0.85, 0.0, 0.0])
    t_max = 2.0e9 / RE
    nat = native.trace_2d_lat(u0, 2000.0, env, rtol=1e-9, atol=1e-14,
                              t_max=t_max, max_steps=200000)
    u, t, st = _port(env, u0, 2000.0, "2d_lat", 1e-9, 1e-14, t_max, 200000)
    assert nat["status"] == st == events.HIT_EARTH
    assert abs(_l_shell(nat["u"]) / _l_shell(u) - 1.0) < 1e-4
    assert abs(nat["u"][3] / u[3] - 1.0) < 1e-4
    assert abs(nat["t"] / t - 1.0) < 1e-4


def _launch_3d(env):
    th0 = np.pi / 2 - 0.9
    rho0 = consistent_rho_3d(R0, th0, 0.3, (1.0, 1.0, 0.0), 1000.0, env)
    return np.array([R0, th0, 0.3, *map(float, rho0), 0.0])


def field_3d(which):
    """test_native_3d_trajectory_parity_tilted_gcpm: a tilted-dipole ray
    and a GCPM ray launched on the dispersion surface."""
    env = (make_env(b_model="tilted", b_tilt=0.2007, b_tilt_phi=1.0)
           if which == "tilted" else make_env(ps_model="gcpm",
                                              gcpm_bpow=0.5))
    u0 = _launch_3d(env)
    nat = native.trace_3d(u0, 1000.0, env, rtol=1e-9, atol=1e-13,
                          t_max=T_MAX, max_steps=400000)
    u, _, st = _port(env, u0, 1000.0, "3d", 1e-9, 1e-13, T_MAX, 400000,
                     **COLAT)
    assert nat["status"] == st == events.HIT_EARTH
    np.testing.assert_allclose(nat["u"][1], u[1], atol=5e-7)
    np.testing.assert_allclose(nat["u"][6], u[6], rtol=2e-5)
