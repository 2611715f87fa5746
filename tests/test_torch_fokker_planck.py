"""Port parity for raytrace_tpu_torch.fokker_planck, radial and drift,
float64 on the CPU.

Each case mirrors one test of tests/test_fokker_planck.py,
tests/test_radial.py or tests/test_drift.py (its name and inputs) and
runs those inputs through the JAX package and the port (device="cpu").
Tolerances: the tridiagonal paths on the same operator (thomas_solve,
build_operator, evolve_cn, steady_state, evolve_radial) and the closed
forms (drift_rate, dll_power_law) to 1e-12 relative; what goes through
the bounce-time factor G = T(a) sin a cos a (bounce_time_factor,
precipitation_lifetime, eigen_lifetime) to 1e-9: near a_eq = 90 deg its
1 - sin^2 a B/B_eq cancels to ~cos^2 a, so the last ulp of the math
libraries' sin and cos (numpy's against torch's) reaches ~1e-10 there
(the lifetimes measured 3e-11 apart). Three JAX cases run 10-20k
Crank-Nicolson steps; their parity cases take a tenth of the steps at the
same dt (the eager substitution costs ~3 torch ops a cell a step on the
CPU). Then the CUDA-graph option on the CPU (the eager loop) and the
device convention."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import diffusion as j_diff
from raytrace_tpu import drift as j_drift
from raytrace_tpu import fokker_planck as j_fp
from raytrace_tpu import radial as j_radial
from raytrace_tpu.constants import FCE_E
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu_torch import drift as t_drift
from raytrace_tpu_torch import fokker_planck as t_fp
from raytrace_tpu_torch import radial as t_radial

from _tiers_parity import assert_same, namespace

jax.config.update("jax_enable_x64", True)

JAX = namespace(False, fp=j_fp, radial=j_radial, drift=j_drift)
PORT = namespace(True, fp=t_fp, radial=t_radial, drift=t_drift)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dipole_g(alpha_lc, n_cells):
    """tests/test_fokker_planck.py's grid and G (the JAX package's numpy:
    the same inputs for both packages)."""
    centers, faces, da = j_fp.make_grid(alpha_lc, n_cells)
    g_c = j_fp.bounce_time_factor(centers) * np.sin(centers) * np.cos(centers)
    g_f = j_fp.bounce_time_factor(faces) * np.sin(faces) * np.cos(faces)
    return centers, faces, da, g_c, np.maximum(g_f, 1e-12)


def _real_daa_profile(n_cells):
    """<D_aa>(alpha_eq) on the L = 4 medium, hiss-like band (the JAX
    oracle's, floored at 1e-8 of its maximum as the JAX tests floor it)."""
    env = j_medium.make_env_lat()
    fce = FCE_E * float(j_medium.b_mag(4.0, 0.0, env))
    spec = j_diff.WaveSpectrum(bw_t=300e-12, f_m=0.15 * fce, df=0.10 * fce,
                               f_lc=0.05 * fce, f_uc=0.50 * fce)
    rl = 0.25
    a_lc = math.asin(math.sqrt(rl**3 / math.sqrt(4.0 - 3.0 * rl)))
    centers, _, _ = j_fp.make_grid(a_lc, n_cells)
    daa = np.asarray(j_diff.bounce_averaged(100.0, centers, 4.0, env, spec,
                                            n_lat=32)["daa"], np.float64)
    return np.maximum(daa, 1e-8 * daa.max()), a_lc


def _conserve(s):
    centers, faces, da, g_c, g_f = _dipole_g(np.radians(5.0), 96)
    d_f = 1.0e-3 * (1.0 + 0.5 * np.sin(3.0 * faces))
    tri = s.fp.build_operator(d_f, g_c, g_f, da, left_bc="reflecting",
                              right_bc="reflecting")
    f0 = np.random.default_rng(3).random(96) + 0.1
    f1 = s.fp.evolve_cn(f0, tri, 20.0, 500)
    return [tri, f1, s.fp.content(f1, g_c, da),
            s.fp.evolve_cn(f0, tri, 5.0, 2000)]


def _slab(n, d0):
    centers, faces, da = j_fp.make_grid(0.3, n)
    return d0 * np.ones(n + 1), np.ones(n), np.ones(n + 1), da


def _cn_mode(s):
    d_f, g_c, g_f, da = _slab(128, 2.0e-3)
    tri = [np.asarray(v) for v in j_fp.build_operator(d_f, g_c, g_f, da)]
    a = np.diag(tri[1]) + np.diag(tri[0][1:], -1) + np.diag(tri[2][:-1], 1)
    w, v = np.linalg.eigh(-(a + a.T) / 2.0)
    mode, t_end = np.abs(v[:, 0]), 0.5 / w[0]
    return [s.fp.evolve_cn(mode, tri, t_end / n, n) for n in (50, 100)]


def _thomas(s):
    rng = np.random.default_rng(7)
    n, batch = 40, 3
    lo = rng.standard_normal((batch, n))
    up = rng.standard_normal((batch, n))
    lo[:, 0] = 0.0
    up[:, -1] = 0.0
    dg = 2.0 + np.abs(lo) + np.abs(up) + rng.random((batch, n))
    return s.fp.thomas_solve(lo, dg, up, rng.standard_normal((batch, n)))


def _lifetime(s):
    daa, a_lc = _real_daa_profile(96)
    return [s.fp.precipitation_lifetime(daa, a_lc, n_cells=96),
            s.fp.eigen_lifetime(daa, a_lc, n_cells=96)]


def _lifetime_scaling(s):
    daa, a_lc = _real_daa_profile(64)
    return [s.fp.eigen_lifetime(k * daa, a_lc, n_cells=64) for k in (1, 4)]


def _lifetime_batched(s):
    daa, a_lc = _real_daa_profile(64)
    return [s.fp.precipitation_lifetime(np.stack([daa, 2.0 * daa]), a_lc,
                                        n_cells=64),
            s.fp.precipitation_lifetime(daa, a_lc, n_cells=64)]


def _grid(s, n, d0, q, l_in=1.5, l_out=6.5):
    centers, faces, dl = s.radial.make_l_grid(l_in, l_out, n)
    return centers, faces, dl, s.radial.dll_power_law(faces, d0=d0, q=q)


def _radial_steady(s):
    grid = _grid(s, 400, 3e-7, 10.0)
    return [grid[0], grid[1], grid[3],
            s.radial.steady_state(*grid, f_out=2.5)]


def _radial_slot(s):
    grid = _grid(s, 240, 3e-7, 10.0)
    c = np.asarray(grid[0])
    inv_tau = 2e-5 * np.exp(-((c - 3.0) / 0.4) ** 2)
    return [s.radial.steady_state(*grid, inv_tau_centers=inv_tau),
            s.radial.steady_state(*grid)]


def _radial_relax(s):
    grid = _grid(s, 120, 1e-6, 10.0)
    c = np.asarray(grid[0])
    inv_tau = 5e-6 * np.exp(-((c - 3.0) / 0.5) ** 2)
    return [s.radial.steady_state(*grid, f_out=1.0, inv_tau_centers=inv_tau),
            s.radial.evolve_radial(np.zeros(120), *grid, dt=2.0e4,
                                   n_steps=1600, f_out=1.0,
                                   inv_tau_centers=inv_tau)]


def _radial_crand(s):
    grid = _grid(s, 240, 3e-8, 10.0)
    c = np.asarray(grid[0])
    inv_tau = 1e-5 * np.exp(-((c - 3.2) / 0.5) ** 2)
    src = 1e-9 * np.exp(-((c - 1.9) / 0.2) ** 2)
    return [s.radial.steady_state(*grid, inv_tau_centers=inv_tau,
                                  source_centers=src),
            s.radial.steady_state(*grid, inv_tau_centers=inv_tau)]


def _radial_remainder(s):
    grid = _grid(s, 40, 3.0e-8, 10.0, 1.6, 6.4)
    return [s.radial.evolve_radial(np.zeros(40), *grid, dt=2.0e4,
                                   n_steps=11, f_out=1.0),
            s.radial.evolve_radial(np.zeros(40), *grid, dt=2.0e4,
                                   n_steps=11, f_out=1.0, save_every=4)]


def _drift_average(s):
    m1 = {"daa": np.array([1.0, 2.0]), "dpp": 4.0, "extra": 7.0}
    m2 = {"daa": np.array([3.0, 6.0]), "dpp": 0.0}
    return [s.drift.drift_average([m1, m2]),
            s.drift.drift_average([m1, m2], weights=[3.0, 1.0])]


# case name (the JAX test it mirrors, with its module) -> (function of a
# package side, relative tolerance)
CASES = {
    "fp/bounce_time_factor_limits": (lambda s: s.fp.bounce_time_factor(
        np.radians([5.0, 20.0, 45.0, 70.0, 89.999])), 1e-9),
    "fp/reflecting_walls_conserve_particles": (_conserve, 1e-12),
    "fp/operator_self_adjoint_in_g": (lambda s: s.fp.build_operator(
        *(lambda g: (1.0e-3 * (1.0 + 0.9 * np.cos(g[1])), g[3], g[4], g[2]))(
            _dipole_g(np.radians(8.0), 64))), 1e-12),
    "fp/constant_coefficient_slab_eigenvalue": (lambda s: [
        s.fp.make_grid(0.3, 256),
        s.fp.build_operator(*_slab(256, 2.5e-3))], 1e-12),
    "fp/cn_evolution_matches_exact_mode_decay_second_order": (_cn_mode, 1e-12),
    "fp/thomas_matches_dense_solve_batched": (_thomas, 1e-12),
    "fp/precipitation_lifetime_matches_dense_eigensolve": (_lifetime, 1e-9),
    "fp/lifetime_exceeds_weak_diffusion_estimate_scaling": (_lifetime_scaling,
                                                            1e-9),
    "fp/precipitation_lifetime_batched": (_lifetime_batched, 1e-9),
    "radial/steady_state_matches_flux_quadrature": (_radial_steady, 1e-12),
    "radial/resolution_convergence_second_order": (lambda s: [
        s.radial.steady_state(*_grid(s, n, 3e-7, 8.0)) for n in (100, 200,
                                                                 400)],
        1e-12),
    "radial/loss_carves_a_slot": (_radial_slot, 1e-12),
    "radial/cn_relaxes_to_steady_state": (_radial_relax, 1e-12),
    "radial/snapshots_fill_inward": (lambda s: s.radial.evolve_radial(
        np.zeros(100), *_grid(s, 100, 1e-6, 10.0), dt=5.0e3, n_steps=400,
        f_out=1.0, save_every=80), 1e-12),
    "radial/crand_source_builds_inner_belt": (_radial_crand, 1e-12),
    "radial/evolve_radial_remainder_steps": (_radial_remainder, 1e-12),
    "drift/equatorial_closed_form": (lambda s: [
        s.drift.drift_rate(e, math.radians(89.99), L)
        for L in (2.0, 4.0, 6.0) for e in (100.0, 1000.0)], 1e-12),
    "drift/pitch_angle_factor_is_hamlin_shaped": (lambda s: s.drift.drift_rate(
        1000.0, np.radians(np.linspace(8.0, 89.0, 12)), 4.0), 1e-12),
    "drift/scalings": (lambda s: [
        s.drift.drift_rate(e, math.radians(60.0), L)
        for e, L in ((500.0, 2.0), (500.0, 6.0), (100.0, 4.0),
                     (2000.0, 4.0))], 1e-12),
    "drift/drift_average_weighting": (_drift_average, 1e-12),
    "drift/boris_full_lorentz_matches_drift_rate": (
        lambda s: s.drift.drift_rate(
            1000.0, math.radians(45.0), 4.0, n_lat=128, n_bisect=50), 1e-12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tier_case_matches_jax(case):
    fn, rtol = CASES[case]
    assert_same(fn(PORT), fn(JAX), rtol)


def test_drift_average_refusals_and_devices():
    with pytest.raises(ValueError):
        t_drift.drift_average([])
    with pytest.raises(ValueError):
        t_drift.drift_average([{"a": 1.0}, {"a": 2.0}], weights=[1.0])
    maps = [{"daa": torch.tensor([1.0, 3.0], dtype=torch.float32)},
            {"daa": torch.tensor([3.0, 5.0], dtype=torch.float32)}]
    out = t_drift.drift_average(maps)
    assert out["daa"].dtype == torch.float32
    assert out["daa"].tolist() == [2.0, 4.0]


def test_thomas_broadcasts_one_operator_over_a_batch():
    rng = np.random.default_rng(11)
    n = 24
    lo, up = rng.standard_normal(n), rng.standard_normal(n)
    dg = 3.0 + np.abs(lo) + np.abs(up)
    b = rng.standard_normal((5, n))
    t = torch.as_tensor
    got = t_fp.thomas_solve(t(lo), t(dg), t(up), t(b)).numpy()
    want = np.asarray(j_fp.thomas_solve(jnp.asarray(np.tile(lo, (5, 1))),
                                        jnp.asarray(np.tile(dg, (5, 1))),
                                        jnp.asarray(np.tile(up, (5, 1))),
                                        jnp.asarray(b)))
    assert_same(got, want, 1e-12)


def test_graph_option_is_the_eager_loop_off_the_card():
    # graph=True replays a CUDA graph only on the card; on the CPU it is the
    # eager loop, value for value
    daa, a_lc = _real_daa_profile(32)
    kw = dict(n_cells=32, n_iter=16, device="cpu")
    assert_same(t_fp.precipitation_lifetime(daa, a_lc, graph=True, **kw),
                t_fp.precipitation_lifetime(daa, a_lc, graph=False, **kw),
                0.0)
    grid = t_radial.make_l_grid(1.6, 6.4, 30, device="cpu")
    dll = t_radial.dll_power_law(grid[1], d0=3e-8)
    a = t_radial.evolve_radial(np.zeros(30), *grid[:3], dll, dt=1e4,
                               n_steps=7, save_every=3, graph=True)
    b = t_radial.evolve_radial(np.zeros(30), *grid[:3], dll, dt=1e4,
                               n_steps=7, save_every=3, graph=False)
    assert_same(a, b, 0.0)


@pytest.mark.parametrize("check_every", [1, 3])
def test_graph_loop_off_the_card_is_the_eager_loop(check_every):
    # integrate.graph.GraphLoop, which the CN step, the inverse iteration
    # and trace_rhs's attempt loop replay: off the card it applies the body
    # eagerly to a static state (a tensor, or a tuple whose unchanged
    # fields come back as the state's own) and leaves on `until`, checked
    # before every check_every-th pass
    from raytrace_tpu_torch.integrate.graph import GraphLoop

    x = torch.zeros(3, dtype=torch.float64)
    assert GraphLoop(lambda s: s + 1.0, x, graph=True).run(5) is x
    assert x.tolist() == [5.0] * 3
    n, keep = torch.zeros((), dtype=torch.int64), torch.ones(2)
    state = (n, keep)
    loop = GraphLoop(lambda s: (s[0] + 1, s[1]), state, graph=True)
    out = loop.run(20, until=lambda s: s[0] >= 4, check_every=check_every)
    assert out is state and out[1] is keep
    assert int(n) == -(-4 // check_every) * check_every


def test_numpy_inputs_go_to_the_card_and_tensors_stay():
    if not torch.cuda.is_available():
        # the card is the default; nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_fp.make_grid(0.1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_radial.steady_state(np.linspace(1.1, 2.0, 4),
                                  np.linspace(1.0, 2.1, 5), 0.1, np.ones(5))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_drift.drift_rate(100.0, 0.5, 4.0)
    out = t_drift.drift_rate(torch.tensor(100.0, dtype=torch.float64), 0.5,
                             4.0)
    assert out["omega_d"].device.type == "cpu"
