"""Port parity for raytrace_tpu_torch.analysis, float64 on the CPU: every
function against the JAX module on the same arrays (inputs from numpy
seeds), to 1e-12 relative unless it returns counts or masks, which must be
equal. The two functions that read the medium take the port's
models.medium on the CPU (device="cpu") and the JAX package's
models.medium."""

import jax
import numpy as np
import pytest
import torch

from raytrace_tpu import analysis as j_an
from raytrace_tpu.integrate.solve import TraceResult as JTraceResult
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu_torch import analysis as t_an
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.models import make_env, make_env_lat

jax.config.update("jax_enable_x64", True)

B0_3D = 3.12e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0.0)


def _traj(seed, s=40, b=6, n=4):
    """(S, B, n) snapshots: smooth paths whose latitude swings through the
    equator, with a frozen tail, and the (B,) frequencies."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, s)[:, None]
    u = np.zeros((s, b, n))
    u[..., 0] = 1.1 + 2.0 * np.sin(np.pi * t) * rng.uniform(0.5, 1.0, b)
    u[..., 1] = rng.uniform(0.3, 0.9, b) * np.cos(
        rng.uniform(2.0, 9.0, b) * t) + 0.05
    u[-5:] = u[-6]
    u[..., 2] = rng.normal(size=(s, b))
    u[..., n - 1] = 3.0 * t
    return u, rng.uniform(500.0, 8000.0, b)


def _fan(seed, b=24):
    """A fan's launch and final states, statuses and frequencies."""
    rng = np.random.default_rng(seed)
    u0 = np.stack([np.full(b, 1.157), np.linspace(0.5, 1.0, b),
                   rng.uniform(-0.5, 0.5, b), np.zeros(b)], 1)
    uf = np.stack([np.ones(b), rng.uniform(-0.4, 0.4, b),
                   rng.normal(size=b), rng.uniform(0.5, 4.0, b)], 1)
    status = rng.choice([events.HIT_EARTH, events.MAX_PHASE_TIME,
                         events.DT_UNDERFLOW], size=b, p=[0.7, 0.2, 0.1])
    return u0, uf, status.astype(np.int32), rng.uniform(500.0, 8000.0, b)


def test_dispersion_fit_and_hop_delays_match_jax():
    """dispersion_measure, fit_eckersley (with and without statuses) and
    hop_delays (with a valid mask, any group index)."""
    u0, uf, status, f = _fan(1)
    T = uf[:, 3]
    _close(t_an.dispersion_measure(T, f), j_an.dispersion_measure(T, f))
    for st in (None, status):
        got, want = t_an.fit_eckersley(T, f, st), j_an.fit_eckersley(T, f, st)
        assert got["n_used"] == want["n_used"]
        _close([got["d0"], got["rms_rel"]], [want["d0"], want["rms_rel"]])
    empty = t_an.fit_eckersley(T, f, np.zeros_like(status))
    assert empty["n_used"] == 0 and np.isnan(empty["d0"])
    res = JTraceResult(u=uf, t=None, status=status, n_accept=None,
                       n_reject=None)
    valid = np.arange(f.size) % 5 != 0
    for kw in ({}, dict(valid=valid), dict(valid=valid, group_idx=3)):
        for g, w in zip(t_an.hop_delays(res, f, **kw),
                        j_an.hop_delays(res, f, **kw)):
            np.testing.assert_array_equal(g, w)


def test_resonance_energy_and_kp_threshold_match_jax():
    """cyclotron_resonance_energy_ev (non-relativistic and relativistic,
    protons only and with He+ and O+) and kp_critical_anisotropy on random
    densities, fields and frequencies below the gyrofrequency."""
    rng = np.random.default_rng(2)
    n = 256
    bm = 10.0 ** rng.uniform(-7.0, -5.0, n)
    ne = 10.0 ** rng.uniform(7.0, 10.5, n)
    f = 0.05 * 2.8e10 * bm * rng.uniform(0.05, 0.9, n)
    for ions in ((0.0, 0.0), (0.1, 0.02)):
        for rel in (False, True):
            _close(t_an.cyclotron_resonance_energy_ev(f, bm, ne, *ions,
                                                      relativistic=rel),
                   j_an.cyclotron_resonance_energy_ev(f, bm, ne, *ions,
                                                      relativistic=rel))
    _close(t_an.kp_critical_anisotropy(f, bm),
           j_an.kp_critical_anisotropy(f, bm))


@pytest.mark.parametrize("medium", ["lat", "plume_mlt", "ions"])
def test_f_lhr_matches_jax(medium):
    """f_lhr over the canonical 2D medium, the MLT-resolved plasmasphere at
    longitudes off the anchor meridian (and phi=None), and He+ and O+."""
    rng = np.random.default_rng(3)
    r = rng.uniform(1.05, 5.0, 64)
    lat = rng.uniform(-0.9, 0.9, 64)
    phis = [None]
    if medium == "lat":
        je, te = j_make_env_lat(), make_env_lat()
    elif medium == "plume_mlt":
        je, te = (j_make_env(b0=B0_3D, ps_mlt=True),
                  make_env(b0=B0_3D, ps_mlt=True))
        phis.append(rng.uniform(-3.0, 3.0, 64))
    else:
        je = j_make_env_lat()._replace(eta_he=0.1, eta_o=0.02)
        te = make_env_lat()._replace(eta_he=0.1, eta_o=0.02)
    for phi in phis:
        _close(t_an.f_lhr(r, lat, te, phi=phi, device="cpu"),
               j_an.f_lhr(r, lat, je, phi=phi))


def test_trajectory_counts_and_resonance_profile_match_jax():
    """count_lat_reversals, count_equator_crossings (both frames, one ray
    and a batch) and resonance_profile_2d_lat (one ray and a batch)."""
    u, f = _traj(4)
    for x in (u, u[:, 2]):
        g, w = t_an.count_lat_reversals(x), j_an.count_lat_reversals(x)
        np.testing.assert_array_equal(g[0], w[0])
        idx_g, idx_w = (g[1], w[1]) if x.ndim == 3 else ([g[1]], [w[1]])
        assert len(idx_g) == len(idx_w)
        for gi, wi in zip(idx_g, idx_w):
            np.testing.assert_array_equal(gi, wi)
        for frame in ("2d_lat", "2d_colat"):
            np.testing.assert_array_equal(
                t_an.count_equator_crossings(x, frame),
                j_an.count_equator_crossings(x, frame))
    assert int(t_an.count_equator_crossings(u).sum()) > 0
    je, te = j_make_env_lat(), make_env_lat()
    for x, ff in ((u, f), (u[:, 1], f[1])):
        got = t_an.resonance_profile_2d_lat(x, ff, te, device="cpu")
        want = j_an.resonance_profile_2d_lat(x, ff, je)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat", "3d"])
def test_footprint_and_spreading_match_jax(frame):
    """landing_footprint in each frame (with and without a valid mask) and
    footprint_spreading over its hits, and its refusals."""
    u0, uf, status, f = _fan(5)
    if frame == "3d":
        pad = lambda x: np.concatenate(  # noqa: E731
            [x[:, :3], np.zeros((x.shape[0], 3)), x[:, 3:]], 1)
        u0, uf = pad(u0), pad(uf)
    res = JTraceResult(u=uf, t=None, status=status, n_accept=None,
                       n_reject=None)
    for valid in (None, np.arange(f.size) % 7 != 3):
        got = t_an.landing_footprint(u0, f, res, valid, frame)
        want = j_an.landing_footprint(u0, f, res, valid, frame)
        assert set(got) == set(want)
        for k in want:
            if np.asarray(want[k]).dtype.kind == "f":
                _close(got[k], want[k])
            else:
                np.testing.assert_array_equal(got[k], want[k])
    param = np.linspace(-0.5, 0.5, f.size)
    got = t_an.footprint_spreading(got, param[valid], r_land=1.0)
    want = j_an.footprint_spreading(want, param[valid], r_land=1.0)
    for k in want:
        _close(got[k], want[k])
    with pytest.raises(ValueError, match="align"):
        t_an.footprint_spreading(
            {"hit": np.ones(3, bool), "landing_lat": np.zeros(3)}, param)
