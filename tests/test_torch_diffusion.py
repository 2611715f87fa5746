"""Port parity for raytrace_tpu_torch.diffusion, float64 on the CPU.

The JAX module computes the chain twice -- a numpy float64 oracle
(local_coefficients, mirror_latitude, bounce_averaged) and a jittable
mirror for the chip (local_coefficients_jax, mirror_latitude_jnp,
bounce_averaged_jax); the port has one implementation. Each case mirrors
one test of tests/test_diffusion.py (its name and inputs) and holds the
port (device="cpu") against the oracle and, where the JAX module has a
chip path for it, against that path on JAX's CPU too. Tolerances: the
root-bisected coefficients (D_aa, D_ap, D_pp and the bounce averages) to
1e-9 relative, root counts and masks exactly, the closed forms
(spectrum, kinematics) to 1e-12, the mirror latitude to 1e-11 rad
absolute (near a_eq = 90 deg the root of sin^2 a sqrt(1 + 3 sin^2 l) =
cos^6 l is ill-conditioned: one ulp of its terms moves it ~1e-16 /
(2 cos^2 a_eq) relative). Both modes (whistler, EMIC), a multi-ion
medium and both momentum units are covered."""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from raytrace_tpu import diffusion as j_diff
from raytrace_tpu.constants import C_LIGHT, FCE_E, M_E
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu_torch import diffusion as t_diff
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.constants import B0_2D
from raytrace_tpu_torch.models import make_env, make_env_lat

from _tiers_parity import Side, assert_same, to_numpy

jax.config.update("jax_enable_x64", True)

# the uniform medium of tests/test_diffusion.py: fce = 28 kHz, fpe/fce ~ 3.2
B0 = 1.0e-6
NE = 1.0e8
FCE = FCE_E * B0
FCP = FCE / 1836.15267
BAND = dict(bw_t=100.0e-12, f_m=0.35 * FCE, df=0.15 * FCE, f_lc=0.15 * FCE,
            f_uc=0.55 * FCE)
EMIC_BAND = dict(bw_t=1e-9, f_m=0.6 * FCP, df=0.25 * FCP, f_lc=0.3 * FCP,
                 f_uc=0.95 * FCP)
FCE4 = FCE_E * float(j_medium.b_mag(4.0, 0.0, j_make_env_lat()))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_STATIC = ("eta_he", "eta_o", "jac_floor", "n_grid", "n_bisect",
           "max_roots", "momentum_units", "mode")
_LOCAL_JIT = jax.jit(j_diff.local_coefficients_jax, static_argnums=(4,),
                     static_argnames=_STATIC)
_BOUNCE_JIT = jax.jit(j_diff.bounce_averaged_jax, static_argnums=(2, 3, 4),
                      static_argnames=_STATIC + ("lat_cut_deg", "n_lat"))


class _ChipPath:
    """The JAX module's chip path (jitted, as its callers run it) under the
    oracle's names, numpy out."""

    @staticmethod
    def local_coefficients(*args, **kw):
        return to_numpy(_LOCAL_JIT(*args, **kw))

    @staticmethod
    def daa_local(*args, **kw):
        return to_numpy(_LOCAL_JIT(*args, **kw)["daa"])

    @staticmethod
    def mirror_latitude(*args, **kw):
        return to_numpy(j_diff.mirror_latitude_jnp(*args, **kw))

    @staticmethod
    def bounce_averaged(e, a, l_shell, env, spec, **kw):
        return to_numpy(_BOUNCE_JIT(e, a, l_shell, env, spec, **kw))


def _side(path):
    """A package side: d (the diffusion functions), spec(...) and the
    media. path: "port", "oracle" or "chip" (the JAX package's two)."""
    if path == "port":
        mod, env_lat, env = t_diff, make_env_lat(), make_env()
        d = Side(t_diff, True)
    else:
        mod, env_lat, env = j_diff, j_make_env_lat(), j_make_env()
        d = Side(j_diff, False) if path == "oracle" else _ChipPath()
    kw = {"device": "cpu"} if path == "port" else {}
    return SimpleNamespace(
        d=d, env_lat=env_lat, env=env,
        power=lambda spec, w: to_numpy(spec.power_density(w, **kw)),
        spec=lambda **kw: mod.WaveSpectrum(**{**BAND, **kw}),
        emic_spec=lambda: mod.WaveSpectrum(**EMIC_BAND))


def _l4_spec(s, **kw):
    return s.spec(**{**dict(bw_t=100e-12, f_m=0.3 * FCE4, df=0.2 * FCE4,
                            f_lc=0.05 * FCE4, f_uc=0.8 * FCE4), **kw})


def _roots(s):
    return [s.d.resonant_roots(40.0, np.radians(45.0), B0, NE, s.spec()),
            s.d.resonant_roots(40.0, 0.0, B0, NE, s.spec())]


def _bounce_equatorial(s):
    spec = _l4_spec(s, f_m=0.5 * FCE4, df=0.25 * FCE4, f_uc=0.95 * FCE4)
    aeq = np.radians(89.5)
    bm = float(j_medium.b_mag(4.0, 0.0, j_make_env_lat()))
    ne = float(j_medium.ne_total_m3(4.0, 0.0, j_make_env_lat()))
    return [s.d.bounce_averaged(100.0, aeq, 4.0, s.env_lat, spec),
            s.d.daa_local(100.0, aeq, bm, ne, spec)]


def _lifetimes(s):
    thin = _l4_spec(s, f_m=0.9 * FCE4, df=0.01 * FCE4, f_lc=0.89 * FCE4,
                    f_uc=0.91 * FCE4)
    return [s.d.loss_cone_lifetime_s(300.0, 4.0, s.env_lat,
                                     _l4_spec(s, f_lc=0.02 * FCE4, bw_t=bw))
            for bw in (100e-12, 200e-12)] + [
        s.d.loss_cone_lifetime_s(5000.0, 4.0, s.env_lat, thin)]


def _emic_threshold(s):
    alpha = np.radians(60.0)
    e = np.geomspace(200.0, 20000.0, 48)[:, None]
    ne = np.array([1e8, 1e9, 1e10])[None, :]
    return [s.d.local_coefficients(np.array([1000.0, 5000.0]), alpha, B0, NE,
                                   s.emic_spec(), mode="emic"),
            s.d.local_coefficients(e, alpha, B0, ne, s.emic_spec(),
                                   mode="emic")]


def _bounce_map(s):
    spec = s.spec(bw_t=50e-12, f_m=800.0, df=300.0, f_lc=200.0, f_uc=1800.0)
    return s.d.bounce_averaged(
        np.array([[30.0], [100.0], [300.0]]), np.radians([[20.0, 45.0, 70.0]]),
        3.0, s.env_lat, spec, lat_cut_deg=20.0, n_lat=24, n_grid=192,
        n_bisect=24)


# case name (the JAX test it mirrors) -> (function of a side, the JAX
# paths it is held to, relative tolerance)
BOTH = ("oracle", "chip")
CASES = {
    "spectrum_normalization": (lambda s: [
        s.power(s.spec(), np.linspace(2 * math.pi * BAND["f_lc"],
                                      2 * math.pi * BAND["f_uc"], 20001)),
        s.power(s.spec(), 2 * math.pi * np.array(
            [BAND["f_lc"] * 0.99, BAND["f_uc"] * 1.01])),
        s.spec()._norm_w()], ("oracle",), 1e-12),
    "resonant_root_satisfies_both_conditions": (lambda s: _roots(s)[0],
                                                ("oracle",), 1e-9),
    "root_matches_independent_resonance_energy": (lambda s: _roots(s)[1],
                                                  ("oracle",), 1e-9),
    "no_resonance_outside_band_means_zero": (lambda s: s.d.local_coefficients(
        2000.0, np.radians(45.0), B0, NE, s.spec()), BOTH, 1e-9),
    "dap_dpp_per_root_relations": (lambda s: s.d.local_coefficients(
        40.0, np.radians(45.0), B0, NE, s.spec(directions="backward")),
        BOTH, 1e-9),
    "symmetric_spectrum_symmetric_alpha": (lambda s: [
        s.d.local_coefficients(40.0, a, B0, NE, s.spec())
        for a in (np.radians([30.0, 55.0, 80.0]),
                  math.pi - np.radians([30.0, 55.0, 80.0]))], BOTH, 1e-9),
    "daa_scales_with_wave_power": (lambda s: [
        s.d.daa_local(40.0, np.radians(45.0), B0, NE, s.spec(bw_t=bw))
        for bw in (100e-12, 300e-12)], BOTH, 1e-9),
    "bounce_period_matches_dipole_approximation": (
        lambda s: s.d.bounce_averaged(
            100.0, np.radians([20.0, 45.0, 70.0]), 4.0, s.env_lat, s.spec(),
            n_lat=128), BOTH, 1e-9),
    "bounce_average_equatorial_limit": (_bounce_equatorial, BOTH, 1e-9),
    "lat_cut_reduces_bounce_average": (lambda s: [
        s.d.bounce_averaged(100.0, np.radians(30.0), 4.0, s.env_lat,
                            _l4_spec(s), lat_cut_deg=cut)
        for cut in (None, 10.0)], BOTH, 1e-9),
    "loss_cone_lifetime_inverse_power": (_lifetimes, ("oracle",), 1e-9),
    "spectrum_from_rays_moments": (lambda s: s.d.spectrum_from_rays(
        np.array([800.0, 1000.0, 1500.0, 4000.0]),
        np.array([50e-12, 100e-12, 50e-12, 0.0])), ("oracle",), 1e-12),
    "spectrum_from_rays_monochromatic_floor": (
        lambda s: s.d.spectrum_from_rays(
            [1000.0, 1000.0], [1e-12, 2e-12], directions="forward"),
        ("oracle",), 1e-12),
    "jax_local_matches_numpy": (lambda s: s.d.local_coefficients(
        np.array([[20.0], [40.0], [80.0], [300.0]]),
        np.radians(np.linspace(12.0, 78.0, 6))[None, :], B0, NE, s.spec()),
        BOTH, 1e-9),
    "jax_local_directional_spectrum": (lambda s: s.d.local_coefficients(
        55.0, np.radians([30.0, 60.0]), B0, NE, s.spec(directions="forward")),
        BOTH, 1e-9),
    "jax_bounce_average_matches_numpy": (_bounce_map, BOTH, 1e-9),
    "emic_root_on_l_branch_anomalous_resonance": (lambda s: s.d.resonant_roots(
        5000.0, np.radians(60.0), B0, NE, s.emic_spec(), mode="emic"),
        ("oracle",), 1e-9),
    "emic_scatters_only_relativistic_electrons": (_emic_threshold, BOTH,
                                                  1e-9),
    "jax_emic_matches_numpy": (lambda s: s.d.local_coefficients(
        np.array([3000.0, 5000.0, 8000.0]), np.radians(55.0), B0, NE,
        s.emic_spec(), mode="emic"), BOTH, 1e-9),
}
PARAMS = [(case, path) for case in sorted(CASES) for path in CASES[case][1]]


def _drop_counts(out):
    """The port's bounce averages carry n_roots, which the JAX ones lack."""
    if isinstance(out, dict):
        return {k: _drop_counts(v) for k, v in out.items() if k != "n_roots"
                or "tau_b" not in out}
    if isinstance(out, list):
        return [_drop_counts(v) for v in out]
    return out


@pytest.mark.parametrize("case,path", PARAMS)
def test_diffusion_case_matches_jax(case, path):
    fn, _, rtol = CASES[case]
    assert_same(_drop_counts(fn(_side("port"))), fn(_side(path)), rtol)


@pytest.mark.parametrize("path", ["oracle", "chip"])
def test_mirror_latitude_invariant_matches_jax(path):
    aeq = np.radians(np.array([10.0, 30.0, 60.0, 89.0, 89.99]))
    got = _side("port").d.mirror_latitude(aeq)
    want = _side(path).d.mirror_latitude(aeq)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-11)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-12)


@pytest.mark.parametrize("path", ["oracle", "chip"])
def test_momentum_units_match_jax(path):
    # tests/test_diffusion.py::test_jax_local_momentum_units_mc: 'mc'
    # against the chip path's 'mc', and x (m_e c)^k against the oracle's SI
    port, jax_side = _side("port"), _side(path)
    args = (55.0, np.radians([30.0, 60.0]), B0, NE)
    got = port.d.local_coefficients(*args, port.spec(), momentum_units="mc")
    if path == "chip":
        want = jax_side.d.local_coefficients(*args, jax_side.spec(),
                                             momentum_units="mc")
    else:
        want = jax_side.d.local_coefficients(*args, jax_side.spec())
        s = M_E * C_LIGHT
        got = dict(got, dap=got["dap"] * s, dpp=got["dpp"] * s * s)
    assert_same(got, want, 1e-9)
    with pytest.raises(ValueError):
        t_diff.local_coefficients(*args, port.spec(), momentum_units="cgs",
                                  device="cpu")


@pytest.mark.parametrize("path", ["oracle", "chip"])
@pytest.mark.parametrize("mode", ["whistler", "emic"])
def test_multi_ion_medium_matches_jax(path, mode):
    # He+ and O+ in the Stix sums of both modes, locally and bounce-averaged
    ions = dict(eta_he=0.15, eta_o=0.05)
    band = "emic_spec" if mode == "emic" else "spec"
    e = np.array([[3000.0], [8000.0]]) if mode == "emic" \
        else np.array([[30.0], [120.0]])

    def case(s, env):
        return [s.d.local_coefficients(e, np.radians([[25.0, 60.0]]), B0, NE,
                                       getattr(s, band)(), mode=mode, **ions),
                s.d.bounce_averaged(e, np.radians([[25.0, 60.0]]), 2.5, env,
                                    getattr(s, band)(), mode=mode, n_lat=16,
                                    n_grid=128, n_bisect=24)]

    got = case(_side("port"), make_env(b0=B0_2D, **ions))
    want = case(_side(path), j_make_env(b0=B0_2D, **ions))
    assert_same(_drop_counts(got), want, 1e-9)
    assert int(np.asarray(got[0]["n_roots"]).sum()) > 0


def test_kinematics_and_spectrum_carry_over():
    e = np.geomspace(1.0, 1e4, 9)
    assert_same(Side(t_diff, True).kinematics(e), j_diff.kinematics(e), 1e-12)
    spec = j_diff.WaveSpectrum(**EMIC_BAND, directions="backward")
    port = interop.spectrum_from_numpy(spec)
    assert port == t_diff.WaveSpectrum(**EMIC_BAND, directions="backward")
    assert port.direction_signs() == spec.direction_signs()
    with pytest.raises(ValueError):
        t_diff.spectrum_from_rays([1000.0], [0.0], device="cpu")


def test_bounce_root_count_is_the_local_counts_sum():
    port = _side("port")
    out = t_diff.bounce_averaged(np.array([[40.0], [150.0]]),
                                 np.radians([[30.0, 70.0]]), 4.0,
                                 port.env_lat, _l4_spec(port),
                                 lat_cut_deg=15.0, n_lat=16, device="cpu")
    assert out["n_roots"].dtype == torch.int64
    assert out["n_roots"].shape == (2, 2) and int(out["n_roots"].sum()) > 0
    full = t_diff.bounce_averaged(np.array([[40.0], [150.0]]),
                                  np.radians([[30.0, 70.0]]), 4.0,
                                  port.env_lat, _l4_spec(port), n_lat=16,
                                  device="cpu")
    assert (full["n_roots"] >= out["n_roots"]).all()


def test_float32_mc_tracks_float64():
    # the chip's float32 path: 'mc' units keep D_pp out of the underflow
    port = _side("port")
    e = torch.tensor([[30.0], [120.0]])
    a = torch.tensor(np.radians([[25.0, 60.0]]), dtype=torch.float32)
    kw = dict(momentum_units="mc", n_lat=16, n_grid=256)
    got = t_diff.bounce_averaged(e, a, 4.0, port.env_lat, _l4_spec(port),
                                 **kw)
    ref = t_diff.bounce_averaged(e.double(), a.double(), 4.0, port.env_lat,
                                 _l4_spec(port), **kw)
    assert got["daa"].dtype == torch.float32
    assert (ref["dpp"] > 0.0).all()
    for k in ("daa", "dap", "dpp"):
        np.testing.assert_allclose(got[k].double().numpy(), ref[k].numpy(),
                                   rtol=1e-3)


def test_numpy_inputs_go_to_the_card_and_tensors_stay():
    spec = t_diff.WaveSpectrum(**BAND)
    if not torch.cuda.is_available():
        # the card is the default; nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_diff.local_coefficients(40.0, 0.5, B0, NE, spec)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_diff.mirror_latitude(0.5)
    out = t_diff.local_coefficients(torch.tensor(40.0, dtype=torch.float64),
                                    0.5, B0, NE, spec)
    assert out["daa"].device.type == "cpu"
    assert out["daa"].dtype == torch.float64
