"""Port parity for raytrace_tpu_torch.convection, float64 on the host.

Each case mirrors one test of tests/test_convection.py (its name, its
inputs and its assertions) on the port's module, and holds the port's
numbers to the JAX package's module on the same inputs: both are NumPy
float64 on the host over the same constants, so they agree to rounding
(held at 1e-13 relative). test_lppi_derived_drop_in_for_storm_chain
drives the port's models/storm.py with the port's lppi_derived, and the
env pinning goes through the port's models/medium.py."""

import math

import numpy as np
import pytest

from raytrace_tpu import convection as j_cv
from raytrace_tpu.models import storm as j_storm
from raytrace_tpu.models.plasmasphere import lppi_from_kp
from raytrace_tpu_torch import convection as cv
from raytrace_tpu_torch.constants import C_LIGHT, M_E, Q_E, RE
from raytrace_tpu_torch.models import medium, storm

from _tiers_parity import assert_same


def _same(fn):
    """fn(module) through the port and the JAX module, compared."""
    got = fn(cv)
    assert_same(got, fn(j_cv), 1e-13)
    return got


def test_module_constants_match_jax():
    assert cv.OMEGA_EARTH == j_cv.OMEGA_EARTH
    assert cv.C_COROTATION_V == j_cv.C_COROTATION_V
    assert cv._MC2_J == j_cv._MC2_J
    assert (C_LIGHT, M_E, Q_E) == (j_cv.C_LIGHT, j_cv.M_E, j_cv.Q_E)


def test_corotation_constant_and_rate():
    assert 9.0e4 < cv.C_COROTATION_V < 9.5e4
    for l_sh in (1.5, 3.0, 6.0):
        d = _same(lambda m: m.exb_drift(l_sh, 0.0, kp=3.0))
        np.testing.assert_allclose(d["dphi_dt"], cv.OMEGA_EARTH, rtol=1e-12)
    d = _same(lambda m: m.exb_drift(6.0, 0.0, kp=3.0))
    assert d["dl_dt"] > 0.0
    # and over arrays, broadcast
    _same(lambda m: m.exb_drift(np.linspace(1.5, 7.0, 12)[:, None],
                                np.linspace(-3.0, 3.0, 9)[None, :], 4.5))


def test_stagnation_point_closed_form():
    for kp in (1.0, 3.0, 6.0):
        l_s, _ = _same(lambda m: m.stagnation_point(kp))
        a = float(cv.maynard_chen_a(kp))
        np.testing.assert_allclose(
            l_s, (cv.C_COROTATION_V / (2.0 * a)) ** (1.0 / 3.0), rtol=1e-12)
        d = cv.exb_drift(l_s, 0.5 * math.pi, kp)
        assert abs(d["dphi_dt"] * l_s * RE) < 1e-9
        assert abs(d["dl_dt"] * RE) < 1e-9


def test_derived_plasmapause_matches_ca1992_kp_relation():
    pp3 = _same(lambda m: m.plasmapause(3.0))
    assert abs(pp3["l_mean"] - lppi_from_kp(3.0)) / lppi_from_kp(3.0) < 0.05
    prev = None
    for kp in (2.0, 3.0, 4.0, 5.0, 6.0):
        pp = cv.plasmapause(kp)
        emp = lppi_from_kp(kp)
        assert abs(pp["l_mean"] - emp) / emp < 0.12, (kp, pp["l_mean"], emp)
        if prev is not None:
            assert pp["l_mean"] < prev
        prev = pp["l_mean"]


def test_plasmapause_shape():
    pp = _same(lambda m: m.plasmapause(3.0, n_mlt=192))
    i_max = int(np.argmax(pp["l_pp"]))
    assert abs(pp["mlt_rad"][i_max] - 0.5 * math.pi) < 0.1
    np.testing.assert_allclose(pp["l_pp"][i_max], pp["l_stag"], rtol=0.02)
    assert pp["l_pp"][i_max] <= pp["l_stag"] + 1e-9
    phi_on = cv.potential(pp["l_pp"], pp["mlt_rad"], 3.0)
    _, phi_s = cv.stagnation_point(3.0)
    np.testing.assert_allclose(phi_on, phi_s, rtol=1e-6)
    i_dawn = int(np.argmin(np.abs(pp["mlt_rad"] + 0.5 * math.pi)))
    assert pp["l_pp"][i_dawn] < 0.75 * pp["l_pp"][i_max]


def test_closed_drift_path_returns_to_start():
    l0 = 3.0
    span = 1.1 * 2.0 * math.pi / cv.OMEGA_EARTH
    tr = _same(lambda m: m.trace_drift_path(l0, 0.0, kp=3.0, t_span_s=span,
                                            n_steps=6000))
    assert not tr["escaped"]
    i_ret = int(np.argmax(tr["mlt_rad"] > 2.0 * math.pi))
    assert i_ret > 0, "did not complete a circuit"
    np.testing.assert_allclose(tr["l"][i_ret], l0, rtol=1e-3)


def test_open_drift_path_escapes_sunward():
    tr = _same(lambda m: m.trace_drift_path(6.5, 0.0, kp=3.0,
                                            t_span_s=3600.0 * 48,
                                            n_steps=4000))
    assert tr["escaped"]
    assert tr["l"][tr["n_valid"] - 1] > 6.5


def test_alfven_layer_zero_energy_limit_is_plasmapause():
    al = _same(lambda m: m.alfven_layer(1e-9, kp=3.0))
    pp = cv.plasmapause(3.0)
    np.testing.assert_allclose(al["l_stag"][0], pp["l_stag"], rtol=1e-6)
    np.testing.assert_allclose(al["l_mean"][0], pp["l_mean"], rtol=1e-4)
    np.testing.assert_allclose(al["l_layer"][0], pp["l_pp"], rtol=1e-4)


def test_alfven_layer_grows_with_energy_and_scaling():
    e = np.array([0.1, 1.0, 5.0, 20.0, 100.0])
    al = _same(lambda m: m.alfven_layer(e, kp=3.0))
    assert (np.diff(al["l_stag"]) > 0.0).all()
    assert (np.diff(al["l_mean"]) > 0.0).all()
    a_v = float(cv.maynard_chen_a(3.0))
    g = 1.0 + 100e3 * Q_E / (M_E * C_LIGHT**2)
    e_eff = 100e3 * (g + 1.0) / (2.0 * g)
    l_pred = math.sqrt(3.0 * e_eff / (2.0 * a_v))
    np.testing.assert_allclose(al["l_stag"][-1], l_pred, rtol=0.10)


def test_alfven_layer_hamiltonian_is_constant_on_layer():
    al = cv.alfven_layer(2.0, kp=4.0)
    h = _same(lambda m: m.electron_hamiltonian(
        al["l_layer"][0], al["mlt_rad"], al["m_inv"][0], kp=4.0))
    h_sep = cv.electron_hamiltonian(al["l_stag"][0], 0.5 * math.pi,
                                    al["m_inv"][0], kp=4.0)
    rest = M_E * C_LIGHT**2
    np.testing.assert_allclose(h - rest, h_sep - rest, rtol=1e-5)
    _same(lambda m: m._gamma_rel(np.geomspace(1e-16, 1e-11, 6),
                                 np.geomspace(1e-8, 1e-5, 6)))


def test_maynard_chen_monotone_and_positive():
    kp = np.linspace(0.0, 9.0, 50)
    a = _same(lambda m: m.maynard_chen_a(kp))
    assert (a > 0.0).all()
    kp = np.linspace(0.0, 8.5, 50)
    assert (np.diff(cv.maynard_chen_a(kp)) > 0.0).all()


def test_erosion_times_derive_storm_tau():
    prev = None
    for ks in (4.0, 5.0, 6.0):
        r = _same(lambda m: m.erosion_times(1.0, ks, n_mlt=16))
        assert r["frac_stripped"] == 1.0
        assert r["n_diverged"] == 0
        assert np.isfinite(r["t_strip_s"]).all()
        t_h = r["t_median_s"] / 3600.0
        assert 0.5 < t_h < 12.0, t_h
        if prev is not None:
            assert t_h < prev
        prev = t_h


def test_lppi_derived_drop_in_for_storm_chain():
    kps = np.array([2.0, 4.0, 6.0])
    der = _same(lambda m: m.lppi_derived(kps, n_mlt=32))
    emp = lppi_from_kp(kps)
    assert der.shape == emp.shape
    assert (np.abs(der - emp) / emp < 0.12).all()
    assert isinstance(cv.lppi_derived(3.0, n_mlt=32), float)

    t = np.linspace(0.0, 48.0, 9)
    kp_h = np.array([0.0, 12.0, 24.0])
    kp_v = np.array([1.0, 5.0, 2.0])
    lpp_e = storm.plasmapause_history(t, kp_h, kp_v)
    lpp_d = storm.plasmapause_history(
        t, kp_h, kp_v, lppi_fn=lambda k: cv.lppi_derived(k, n_mlt=24),
        dt_hours=1.0)
    assert lpp_d.shape == lpp_e.shape
    assert np.isfinite(lpp_d).all() and (lpp_d > 1.5).all()
    assert lpp_d[4] < lpp_d[0]
    # the port's storm chain with the port's lppi_derived is the JAX
    # package's with the JAX one
    want = j_storm.plasmapause_history(
        t, kp_h, kp_v, lppi_fn=lambda k: j_cv.lppi_derived(k, n_mlt=24),
        dt_hours=1.0)
    assert_same(lpp_d, want, 1e-13)


def test_lppi_at_mlt_dusk_bulge_and_env_pinning():
    l_dusk = _same(lambda m: m.lppi_at_mlt(3.0, 18.0))
    l_dawn = _same(lambda m: m.lppi_at_mlt(3.0, 6.0))
    assert l_dusk > 1.25 * l_dawn
    arr = _same(lambda m: m.lppi_at_mlt(3.0, np.array([6.0, 18.0, 30.0])))
    np.testing.assert_allclose(arr[0], arr[2], rtol=1e-12)
    np.testing.assert_allclose(arr[0], l_dawn, rtol=1e-12)
    env = medium.make_env(kp_max=(5.6 - l_dawn) / 0.46)
    np.testing.assert_allclose(float(env.lppi), l_dawn, rtol=1e-9)


@pytest.mark.parametrize("kp", [2.0, 4.5])
def test_mlt_shape_fourier_still_matches_jax(kp):
    # the part PR 3 ported, beside the rest
    _same(lambda m: m.mlt_shape_fourier(kp, 2.0, n_harm=3))
