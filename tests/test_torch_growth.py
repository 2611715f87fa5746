"""Port parity for raytrace_tpu_torch.growth, float64 on the CPU.

Each case mirrors one test of tests/test_growth.py (its name, its inputs)
and runs those inputs through the JAX package's growth module and the
port's (device="cpu"): the closed forms (gamma_whistler, gamma_emic,
_dr_dw, cold_mode_oblique, the group velocity, the transit gain, the
equatorial spectrum, path_gain with ql kinetics) to 1e-12 relative,
gamma_oblique and path_gain with oblique kinetics to 1e-10 (the port's
Bessel series and recurrence against scipy's jv), masks exactly. The
traced trajectories are the JAX package's (one 2D and one on-shell 3D
ray, traced once per process). Then the cases the JAX tests leave out
(the colatitude frame, psi_mode="parallel", multi-ion media, float32
tensors), the Bessel weights against scipy, and the device convention."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import jv

from raytrace_tpu import growth as j_growth
from raytrace_tpu.constants import FCE_E, FCE_P, RE
from raytrace_tpu.integrate import SolverConfig, StopSpec, trace
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import dispersion as j_dispersion
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch import growth as t_growth
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.models import make_env, make_env_lat

from _tiers_parity import assert_same, namespace

jax.config.update("jax_enable_x64", True)

# the media of tests/test_growth.py: an L = 4 equator (fce ~ 13.6 kHz,
# 1000 cm^-3) and the L = 2.56 plasmasphere equator of its regression pin
BMAG = 3.12e-5 / 64.0
NE = 1.0e9
FCE = FCE_E * BMAG
FCI = FCE_P * BMAG


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sides():
    jax_side = namespace(False, g=j_growth)
    jax_side.env_lat, jax_side.env = j_make_env_lat(), j_make_env()
    port = namespace(True, g=t_growth)
    port.env_lat, port.env = make_env_lat(), make_env()
    for side, mod in ((jax_side, j_growth), (port, t_growth)):
        side.hot = functools.partial(mod.HotElectrons, eta=1.0e-3,
                                     t_par_ev=10.0e3, anisotropy=1.0)
        side.hot_p = functools.partial(mod.HotProtons, eta=1.0e-3,
                                       t_par_ev=30.0e3, anisotropy=1.0)
    return jax_side, port


@functools.lru_cache(maxsize=None)
def _traced():
    """The JAX package's traced rays of tests/test_growth.py: the
    unducted 58 deg, 4 kHz 2D ray (save_every 16) and the on-shell 3D
    1 kHz ray (save_every 16), as numpy (S, 1, n)."""
    env = j_make_env_lat()
    u0 = jnp.array([[(RE + 1e6) / RE, np.radians(58.0), 0.0, 0.0]])
    res2 = trace(
        lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env), u0, jnp.array([4000.0]),
        cfg=SolverConfig(rtol=1e-5, atol=1e-9, dt0=1e-4),
        spec=StopSpec(r_floor=1.0, t_max=3e9 / RE), max_steps=8192,
        save_every=16,
    )
    env3 = j_make_env()
    r0, th0, ph0 = (RE + 1.0e6) / RE, np.pi / 4, 0.0
    rho = np.asarray(j_dispersion.consistent_rho_3d(
        r0, th0, ph0, (1.0, 1.0, 0.0), 1000.0, env3))
    res3 = trace(
        lambda u, ff: j_rhs.rhs_3d(u, ff, env3),
        jnp.array([[r0, th0, ph0, *rho, 0.0]]), jnp.array([1000.0]),
        cfg=SolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4),
        spec=StopSpec(r_floor=1.0, t_max=5e8 / RE, lat_sign=-1.0,
                      lat_offset=np.pi / 2),
        group_idx=6, max_steps=4096, save_every=16,
    )
    return np.asarray(res2.traj["u"]), np.asarray(res3.traj["u"])


def _cold_invariants(out):
    """cold_mode_oblique's outputs without the polarization's free phase
    (a pick between two near-equal row crosses may rotate it): |e_i|^2
    and Im(conj(e0) e1), beside the real outputs."""
    e = out["e"]
    inv = {k: out[k] for k in ("mu2", "propagating", "lam_p", "S", "D",
                               "P")}
    inv["e_abs2"] = np.abs(e) ** 2
    inv["e01_im"] = np.imag(np.conj(e[..., 0]) * e[..., 1])
    return inv


def _field_line(env_np):
    """|B| and ne along the L = 4 line at 0-30 deg (the JAX medium's)."""
    lat = np.radians(np.linspace(0.0, 30.0, 7))
    r = 4.0 * np.cos(lat) ** 2
    return (np.asarray(j_medium.b_mag(r, lat, env_np), np.float64),
            np.asarray(j_medium.ne_total_m3(r, lat, env_np), np.float64))


def _threshold(s):
    f_c = FCE * 0.5
    return s.g.gamma_whistler(np.array([f_c * 0.999, f_c * 1.001,
                                        0.25 * FCE]), BMAG, NE, s.hot())


def _oblique_isotropic(s):
    out = []
    for psid in (0.0, 10.0, 25.0, 40.0):
        g, parts = s.g.gamma_oblique(0.22 * FCE, BMAG, NE,
                                     s.hot(anisotropy=0.0),
                                     np.radians(psid), return_parts=True)
        out.append((g, parts["gamma_m"], parts["mu2"], parts["lam_p"]))
    return out


def _path_gain_2d(s):
    traj = _traced()[0]
    g = s.g.path_gain(traj, 4000.0, s.env_lat, s.hot(t_par_ev=25.0e3))
    g0 = s.g.path_gain(traj, 4000.0, s.env_lat,
                       s.hot(t_par_ev=25.0e3, anisotropy=0.0))
    g1 = s.g.path_gain(traj[:, 0], 4000.0, s.env_lat,
                       s.hot(t_par_ev=25.0e3))
    return g, g0, g1


def _path_gain_3d(s):
    traj = _traced()[1]
    return [s.g.path_gain(traj, 1000.0, s.env, s.hot(t_par_ev=25.0e3,
                                                      anisotropy=a),
                          frame="3d") for a in (1.0, 0.0)]


def _path_gain_oblique(s):
    traj = _traced()[0]
    hot0 = s.hot(t_par_ev=25.0e3, anisotropy=0.0)
    return (s.g.path_gain(traj, 4000.0, s.env_lat, hot0,
                          kinetics="oblique"),
            s.g.path_gain(traj, 4000.0, s.env_lat, hot0, kinetics="ql"))


# case name (the JAX test it mirrors) -> (function of a package side,
# relative tolerance)
CASES = {
    "threshold_at_kp_critical_anisotropy": (_threshold, 1e-12),
    "isotropic_population_damps": (lambda s: s.g.gamma_whistler(
        np.array([0.1, 0.3, 0.5, 0.7]) * FCE, BMAG, NE,
        s.hot(anisotropy=0.0)), 1e-12),
    "scalings_and_weak_growth": (lambda s: [
        s.g.gamma_whistler(0.3 * FCE, BMAG, NE, s.hot()),
        s.g.gamma_whistler(0.3 * FCE, BMAG, NE, s.hot(eta=2.0e-3)),
        s.g.gamma_whistler(np.array([0.05, 0.2, 0.45]) * FCE, BMAG, NE,
                           s.hot())], 1e-12),
    "obliquity_reduces_growth_and_cone_cuts_off": (
        lambda s: s.g.gamma_whistler(
            0.3 * FCE, BMAG, NE, s.hot(),
            psi=np.array([0.0, 0.4, 0.8, 1.2, np.arccos(0.29)])), 1e-12),
    "regression_value": (lambda s: s.g.gamma_whistler(
        4000.0, 3.12e-5 / 2.56**3, 1.8593826731720128e9,
        s.hot(t_par_ev=25.0e3)), 1e-12),
    "full_kinetic_crosscheck": (lambda s: s.g.gamma_whistler(
        np.array([2000.0, 4000.0, 8000.0]), 3.12e-5 / 2.56**3,
        1.8593826731720128e9, s.hot(t_par_ev=25.0e3)), 1e-12),
    "emic_threshold_and_damping": (lambda s: [
        s.g.gamma_emic(np.array([0.4995, 0.5005, 0.3]) * FCI, BMAG, NE,
                       s.hot_p()),
        s.g.gamma_emic(np.array([0.1, 0.4, 0.8]) * FCI, BMAG, NE,
                       s.hot_p(anisotropy=0.0)),
        s.g.gamma_emic(0.3 * FCI, BMAG, NE, s.hot_p(eta=2.0e-3))], 1e-12),
    "emic_full_kinetic_crosscheck": (lambda s: s.g.gamma_emic(
        0.3 * FCI, BMAG, NE, s.hot_p()), 1e-12),
    "equatorial_gain_profile_shape": (lambda s: s.g.equatorial_gain_profile(
        4.0, np.linspace(500.0, 12000.0, 47), s.env_lat, s.hot()), 1e-12),
    "equatorial_confinement_along_field_line": (lambda s: s.g.gamma_whistler(
        0.15 * FCE_E * _field_line(j_make_env_lat())[0][0],
        *_field_line(j_make_env_lat()), s.hot()), 1e-12),
    "path_gain_on_traced_ray": (_path_gain_2d, 1e-12),
    "path_gain_3d_on_shell": (_path_gain_3d, 1e-12),
    "group_velocity_closed_form": (lambda s: [
        s.g.group_velocity_parallel(0.2 * FCE * (1 + np.array([-1e-6, 0.0,
                                                               1e-6])),
                                    BMAG, NE, "whistler"),
        s.g.group_velocity_parallel(0.2 * FCE / 1836.15267, BMAG, NE,
                                    "emic")], 1e-12),
    "transit_gain_structure": (lambda s: [
        s.g.transit_gain_db(4.0, 0.2 * FCE_E * float(j_medium.b_mag(
            4.0, 0.0, j_make_env_lat())), s.env_lat, s.hot()),
        s.g.transit_gain_db(4.0, np.array([0.1, 0.2, 0.4]) * FCE_E * float(
            j_medium.b_mag(4.0, 0.0, j_make_env_lat())), s.env_lat,
            s.hot(eta=2.0e-3)),
        s.g.transit_gain_db(4.0, 0.3 * FCE_P * float(j_medium.b_mag(
            4.0, 0.0, j_make_env_lat())), s.env_lat, s.hot_p(),
            mode="emic")], 1e-12),
    "cold_mode_oblique_root_polarization_and_denominator": (
        lambda s: _cold_invariants(s.g.cold_mode_oblique(
            0.25 * FCE, BMAG, NE, np.radians([0.0, 15.0, 35.0, 55.0]))),
        1e-12),
    "oblique_parallel_limit_matches_ql": (lambda s: s.g.gamma_oblique(
        np.array([0.05, 0.15, 0.25, 0.4, 0.6]) * FCE, BMAG, NE, s.hot(),
        psi=1e-9), 1e-10),
    "oblique_isotropic_damps_and_landau_turns_on": (_oblique_isotropic,
                                                    1e-10),
    "oblique_growth_below_ql_estimate": (lambda s: [
        s.g.gamma_oblique(0.22 * FCE, BMAG, NE, s.hot(),
                          np.radians([1e-7, 15.0, 30.0, 45.0])),
        s.g.gamma_whistler(0.22 * FCE, BMAG, NE, s.hot(),
                           psi=np.radians([15.0, 30.0, 45.0]))], 1e-10),
    "oblique_quadrature_converged": (lambda s: [
        s.g.gamma_oblique(0.22 * FCE, BMAG, NE, s.hot(),
                          np.radians([10.0, 40.0, 65.0]), n_quad=nq)
        for nq in (96, 192)], 1e-10),
    "path_gain_oblique_kinetics_on_traced_ray": (_path_gain_oblique, 1e-10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_growth_case_matches_jax(case):
    fn, rtol = CASES[case]
    jax_side, port = _sides()
    assert_same(fn(port), fn(jax_side), rtol)


@pytest.mark.parametrize("ions", [(0.0, 0.0), (0.1, 0.05)])
def test_dr_dw_matches_jax(ions):
    # tests/test_growth.py::test_dr_dw_matches_stix_rlp_derivative's
    # closed form, with _dp_dw beside it
    w = 2 * np.pi * 0.3 * FCE * np.array([0.5, 1.0, 1.5])
    def t(x):
        return torch.tensor(x, dtype=torch.float64)

    assert_same(t_growth._dr_dw(t(w), t(NE), t(BMAG), *ions).numpy(),
                j_growth._dr_dw(w, NE, BMAG, *ions), 1e-12)
    assert_same(t_growth._dp_dw(t(w), t(NE), *ions).numpy(),
                j_growth._dp_dw(w, NE, *ions), 1e-12)


# -- the cases the JAX tests leave out ---------------------------------------

def _colat_traj(seed=5, s=60, b=4):
    """(S, B, 4) colatitude-frame snapshots through the equator with a
    frozen tail, and (B,) frequencies."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, s)[:, None]
    u = np.zeros((s, b, 4))
    u[..., 0] = 1.2 + 2.5 * np.sin(np.pi * t) * rng.uniform(0.6, 1.0, b)
    u[..., 1] = np.pi / 2 - rng.uniform(0.3, 0.8, b) * np.cos(
        rng.uniform(2.0, 6.0, b) * t)
    u[..., 2] = 0.3 * rng.normal(size=(s, b))
    u[..., 3] = 2.0 * t
    u[-6:] = u[-7]
    return u, rng.uniform(1000.0, 6000.0, b)


@pytest.mark.parametrize("kinetics,psi_mode,rtol", [
    ("ql", "local", 1e-12), ("ql", "parallel", 1e-12),
    ("oblique", "local", 1e-10)])
def test_path_gain_colat_frame_matches_jax(kinetics, psi_mode, rtol):
    u, f = _colat_traj()
    jax_side, port = _sides()
    got, want = (s.g.path_gain(u, f, s.env_lat, s.hot(t_par_ev=25.0e3),
                               frame="2d_colat", psi_mode=psi_mode,
                               kinetics=kinetics)
                 for s in (port, jax_side))
    assert_same(got, want, rtol)
    assert np.abs(want["gain_neper"][-1]).max() > 0.0


def test_multi_ion_medium_matches_jax():
    jax_side, port = _sides()
    ions = dict(eta_he=0.1, eta_o=0.05)
    f = np.array([0.1, 0.25, 0.45]) * FCE
    psi = np.radians([5.0, 20.0, 40.0])

    def case(s):
        return [s.g.gamma_whistler(f, BMAG, NE, s.hot(), psi, **ions),
                s.g.gamma_emic(f / 1836.15267, BMAG, NE, s.hot_p(), psi,
                               **ions),
                s.g.group_velocity_parallel(f, BMAG, NE, "whistler",
                                            **ions),
                _cold_invariants(s.g.cold_mode_oblique(f, BMAG, NE, psi,
                                                       **ions))]

    assert_same(case(port), case(jax_side), 1e-12)
    assert_same(port.g.gamma_oblique(f, BMAG, NE, port.hot(), psi, **ions),
                jax_side.g.gamma_oblique(f, BMAG, NE, jax_side.hot(), psi,
                                         **ions), 1e-10)


def test_bessel_weights_match_scipy():
    # the series below |x| = 1, Miller's recurrence above, both signs,
    # orders up to 6 from one recurrence (measured within 1.06e-15 of
    # scipy, J_0 itself 1.03e-15: held at the 2e-15 the first orders had)
    x = np.concatenate([-np.geomspace(1e-8, 300.0, 400), [0.0],
                        np.geomspace(1e-8, 300.0, 400)])
    js = t_growth._bessel_orders(torch.as_tensor(x), 6)
    assert len(js) == 7
    for n in range(-6, 7):
        got = t_growth._bessel_jn(js, n).numpy()
        np.testing.assert_allclose(got, jv(n, x), rtol=0.0, atol=2e-15)
    # the default keeps J_0 ... J_2, bit for bit the same values
    for a, b in zip(t_growth._bessel_orders(torch.as_tensor(x)), js):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        t_growth._bessel_jn(js, 7)


@pytest.mark.parametrize("harmonics", [(-2, 0), tuple(range(-3, 4)),
                                       (2, -3)],
                         ids=["m-2,0", "m-3..3", "m2,-3"])
def test_oblique_higher_harmonics_match_jax(harmonics):
    """gamma_oblique at any harmonic (Bessel orders up to max|m| + 1)
    against the JAX package's scipy.special.jv sum, at 1e-10, with the
    per-harmonic parts; at large k_perp rho the |m| >= 2 terms carry a
    visible share."""
    jax_side, port = _sides()
    psi = np.radians([10.0, 35.0, 55.0, 70.0])

    def case(s):
        g, parts = s.g.gamma_oblique(0.22 * FCE, BMAG, NE,
                                     s.hot(t_par_ev=50.0e3), psi,
                                     harmonics=harmonics,
                                     return_parts=True)
        return g, parts["gamma_m"]

    got, want = case(port), case(jax_side)
    assert_same(got, want, 1e-10)
    if 2 in harmonics:
        assert np.abs(want[1][2]).max() > 1e-6 * np.abs(want[0]).max()


def test_float32_tensors_stay_float32():
    port = _sides()[1]
    f = torch.tensor([0.1, 0.3], dtype=torch.float32) * FCE
    g32 = t_growth.gamma_whistler(f, BMAG, NE, port.hot())
    g64 = t_growth.gamma_whistler(f.double(), BMAG, NE, port.hot())
    assert g32.dtype == torch.float32 and g64.dtype == torch.float64
    np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=1e-4)


def test_interop_carries_the_hot_populations():
    assert interop.hot_from_numpy(j_growth.HotElectrons(eta=2e-3)) \
        == t_growth.HotElectrons(eta=2e-3)
    assert interop.hot_from_numpy(j_growth.HotProtons(t_par_ev=5e3)) \
        == t_growth.HotProtons(t_par_ev=5e3)
    assert interop.hot_from_numpy({"eta": 1e-4, "t_par_ev": 1e3,
                                   "anisotropy": 0.5}) \
        == t_growth.HotElectrons(1e-4, 1e3, 0.5)


def test_numpy_inputs_go_to_the_card_and_tensors_stay():
    hot = t_growth.HotElectrons()
    if not torch.cuda.is_available():
        # the card is the default; nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_growth.gamma_whistler(0.3 * FCE, BMAG, NE, hot)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_growth.path_gain(np.ones((3, 1, 4)), 1000.0, make_env_lat(),
                               hot)
    g = t_growth.gamma_whistler(torch.tensor(0.3 * FCE), BMAG, NE, hot)
    assert g.device.type == "cpu"
