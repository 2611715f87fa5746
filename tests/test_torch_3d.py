"""Port parity for the modules of the 3D slice, float64 on the CPU: the 3D
field and dispersion, the cos-form fused chain and rhs_3d, the 7-state
W-solve of the stiff pool, the ds_max arc ceiling in _step_one (2D and
3D), and the step kernel's plain version over rhs_3d."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import steppers as j_steppers
from raytrace_tpu.integrate.solve import _step_one as j_step_one
from raytrace_tpu.integrate.solve import init_carry as j_init_carry
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import dispersion as j_disp
from raytrace_tpu.ops import fused as j_fused
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate import steppers
from raytrace_tpu_torch.integrate.solve import RayCarry, _step_one, step_loop
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import dispersion, fused, gradients, rhs
from raytrace_tpu_torch.ops import step_chunk as sc

PARTIALS = ("dmu/dr", "dmu/dtheta", "dmu/dphi", "dmu/drho_r", "dmu/drho_t",
            "dmu/drho_p", "dmu/df")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _envs(**kw):
    je = j_make_env(b0=3.12e-5, **kw)
    return je, medium.make_env(b0=3.12e-5, **kw)


def _points(seed, n=512):
    """3D states (r, theta, phi, rho_r, rho_t, rho_p, f): a random half,
    and a half whose rho lies within 1e-9..1e-2 rad of +-B (near
    field-aligned psi, the natural whistler state)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.05, 5.0, n)
    th = rng.uniform(0.3, 2.8, n)
    ph = rng.uniform(-3.0, 3.0, n)
    f = rng.uniform(500.0, 8000.0, n)
    rho = rng.normal(size=(n, 3)) * 20.0
    lat = np.pi / 2 - th
    q = np.sqrt(1.0 + 3.0 * np.sin(lat) ** 2)
    bhat = np.stack([-2.0 * np.sin(lat) / q, -np.cos(lat) / q,
                     np.zeros(n)], 1)
    perp = np.stack([-bhat[:, 1], bhat[:, 0], np.zeros(n)], 1)
    h = n // 2
    eps = 10.0 ** rng.uniform(-9, -2, h)
    sign = np.where(rng.uniform(size=h) < 0.5, -1.0, 1.0)
    mag = rng.uniform(2.0, 40.0, h)
    rho[:h] = mag[:, None] * (sign[:, None] * bhat[:h] + eps[:, None]
                              * perp[:h])
    rho[:h, 2] += mag * eps * rng.normal(size=h)
    return r, th, ph, rho[:, 0], rho[:, 1], rho[:, 2], f


def _close(got, want, rtol, what):
    """Per output against its largest magnitude over the grid: the rho
    partials cancel to ~0 at field-aligned psi, where an elementwise
    relative error means nothing."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e}"


def test_field_and_frame_maps_match_jax():
    je, te = _envs()
    r, th, ph = _points(20)[:3]
    tt = [torch.tensor(x) for x in (r, th, ph)]
    jj = [jnp.asarray(x) for x in (r, th, ph)]
    for a, b in zip(medium.b_vec(*tt, te), j_medium.b_vec(*jj, je)):
        _close(a.numpy(), b, 1e-15, "b_vec")
    np.testing.assert_array_equal(medium.mlat_3d(*tt, te).numpy(),
                                  np.asarray(j_medium.mlat_3d(*jj, je)))
    np.testing.assert_array_equal(medium.mlon_3d(*tt, te).numpy(), ph)


@pytest.mark.parametrize("root", [1.0, -1.0])
def test_mu_3d_and_trig_match_jax(root):
    je, te = _envs()
    pts = _points(21)
    tt = [torch.tensor(x) for x in pts]
    jj = [jnp.asarray(x) for x in pts]
    for a, b in zip(dispersion.psi_trig_3d(*tt[:6], te),
                    j_disp.psi_trig_3d(*jj[:6], je)):
        _close(a.numpy(), b, 1e-15, "psi trig")
    np.testing.assert_allclose(dispersion.mu_3d(*tt, te, root).numpy(),
                               np.asarray(j_disp.mu_3d(*jj, je, root)),
                               rtol=1e-12)


def test_consistent_rho_3d_matches_jax():
    je, te = _envs()
    r, th, ph, kr, kt, kp, f = _points(22)
    got = dispersion.consistent_rho_3d(
        *map(torch.tensor, (r, th, ph)),
        tuple(map(torch.tensor, (kr, kt, kp))), torch.tensor(f), te)
    want = jax.vmap(lambda *a: jnp.stack(j_disp.consistent_rho_3d(
        a[0], a[1], a[2], a[3:6], a[6], je)))(
        *map(jnp.asarray, (r, th, ph, kr, kt, kp, f)))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("env_kw", [{}, dict(de_correction=True),
                                    dict(plasmasphere_on=False)])
def test_mu_and_grads_3d_matches_jax(env_kw):
    je, te = _envs(**env_kw)
    pts = _points(23)
    mu_t, g_t = fused.mu_and_grads_3d(*map(torch.tensor, pts), te)
    mu_j, g_j = j_fused.mu_and_grads_3d(*map(jnp.asarray, pts), je)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-12)
    for name, a, b in zip(PARTIALS, g_t, g_j):
        _close(a.numpy(), b, 1e-12, name)


def test_fused_3d_matches_own_autodiff():
    """The port's cos-form chain is the derivative of its own traced mu
    (torch.func.grad of dispersion.mu_3d), away from exactly aligned psi
    where the autodiff of sqrt(|Bhat x rhohat|^2) is 0/0."""
    _, te = _envs()
    pts = tuple(map(torch.tensor, _points(24)))
    mu_f, g_f = gradients.mu_grads_3d(*pts, te, grad_mode=gradients.FUSED)
    mu_a, g_a = gradients.mu_grads_3d(*pts, te,
                                      grad_mode=gradients.AUTODIFF)
    np.testing.assert_allclose(mu_f.numpy(), mu_a.numpy(), rtol=1e-12)
    for name, a, b in zip(PARTIALS, g_f, g_a):
        _close(a.numpy(), b.numpy(), 1e-9, name)


@pytest.mark.parametrize("root", [1.0, -1.0])
def test_rhs_3d_matches_jax(root):
    je, te = _envs()
    pts = _points(25)
    T = np.random.default_rng(26).uniform(0.0, 3.0, pts[0].size)
    u = np.stack([*pts[:6], T], axis=1)
    got = rhs.rhs_3d(torch.tensor(u), torch.tensor(pts[6]), te, root=root)
    want = jax.vmap(lambda uu, ff: j_rhs.rhs_3d(uu, ff, je, root=root))(
        jnp.asarray(u), jnp.asarray(pts[6]))
    for j in range(7):
        _close(got[:, j].numpy(), np.asarray(want)[:, j], 1e-12,
               f"du[{j}]/dt")


def test_3d_chains_take_fractional_weights_and_refuse_as_jax():
    """The multi-ion composition runs through the 3D chains
    (tests/test_torch_variants.py holds them to the JAX package), and so
    does a fractional plasmasphere weight (make_env gives 0 or 1; an env's
    _replace any other): mu and its partials as the JAX package's chain
    gives them at ps_weight = 0.5, within 1e-12 of each output's scale
    (tests/test_torch_any_medium.py holds every weight and medium); the
    reference gradient set (tests/test_torch_reference_mode.py) refuses
    the multi-ion media and the non-axial fields, as the JAX package
    does."""
    x = torch.ones(2, dtype=torch.float64)
    pts = _points(41, n=64)
    for kw, chain, j_chain in (
            (dict(ps_mlt=True, eta_he=0.1), fused.mu_and_grads_3d,
             j_fused.mu_and_grads_3d),
            (dict(b_model="tilted", eta_o=0.1),
             fused.mu_and_grads_3d_general,
             j_fused.mu_and_grads_3d_general)):
        je = j_make_env(**kw)
        env = env_from_numpy(je._asdict())
        mu, grads = chain(x, x, x, x, x, x, x * 1e3, env)
        assert bool(torch.isfinite(mu).all())
        half, j_half = env._replace(ps_weight=0.5), je._replace(ps_weight=0.5)
        mu, grads = chain(*map(torch.tensor, pts), half)
        jmu, jgrads = jax.vmap(lambda *a: j_chain(*a, j_half))(
            *map(jnp.asarray, pts))
        for got, want in zip((mu, *grads), (jmu, *jgrads)):
            want = np.asarray(want)
            assert float(np.abs(got.numpy() - want).max()) <= (
                1e-12 * float(np.abs(want).max()))
    mu, grads = gradients.mu_grads_3d(x, x, x, x, x, x, x * 1e3, _envs()[1],
                                      grad_mode="reference")
    assert bool(torch.isfinite(mu).all()) and bool((grads[0] == 0).all())
    for kw, match in ((dict(eta_he=0.1), "protons-only"),
                      (dict(b_model="tilted", b_tilt=0.2), "centered-dipole")):
        with pytest.raises(ValueError, match=match):
            gradients.mu_grads_3d(x, x, x, x, x, x, x * 1e3, _envs(**kw)[1],
                                  grad_mode="reference")


def test_solve_nopivot_matches_jax():
    rng = np.random.default_rng(27)
    W = np.eye(7) + 0.1 * rng.normal(size=(32, 7, 7))
    b = rng.normal(size=(32, 7))
    got = steppers._solve_w(torch.tensor(W), torch.tensor(b))
    want = jax.vmap(j_steppers._solve_w)(jnp.asarray(W), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", W, got.numpy()), b, rtol=1e-12, atol=1e-13)


def _launch_3d(dtype=np.float64, **over):
    """16 on-shell rays of the ensemble10k_3d launch (the JAX package's
    own launch, run._build_u0), with their config."""
    cfg = j_config.preset("ensemble10k_3d", lats=(0.6, 0.8, 1.0, 1.1),
                          chis=(-0.3, 0.3), freqs=(1000.0, 4000.0),
                          dtype="float64", **over)
    u0, f = j_run._build_u0(cfg, dtype)
    return cfg, u0, f


def test_ros3pr_7_state_step_matches_jax():
    """One ros3pr attempt in the 7-state frame: the jacfwd Jacobian and
    three W-solves through _solve_nopivot."""
    je, te = _envs()
    cfg, u0, f = _launch_3d()
    u0[:, 6] = 0.3
    dt = np.full(u0.shape[0], 0.01)
    rf = lambda u, ff: j_rhs.rhs_3d(u, ff, je)  # noqa: E731
    k1 = jax.vmap(rf)(jnp.asarray(u0), jnp.asarray(f))
    want = jax.vmap(lambda u, k, h, ff: j_steppers.ros3pr_step(
        lambda uu: rf(uu, ff), u, k, h, 1e-5, 1e-8))(
        jnp.asarray(u0), k1, jnp.asarray(dt), jnp.asarray(f))
    trf, _ = rhs.frame_rhs("3d", te)
    ft = torch.tensor(f)
    got = steppers.ros3pr_step(
        lambda u: trf(u, ft), torch.tensor(u0), trf(torch.tensor(u0), ft),
        torch.tensor(dt), 1e-5, 1e-8,
        jac_fn=lambda u: torch.func.vmap(torch.func.jacfwd(trf))(u, ft))
    for name in ("u_new", "k_end", "incr"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        for j in range(7):
            _close(a[:, j], b[:, j], 1e-12, f"{name}[{j}]")
    # the error norm is ~1e-8 here, its last bits rounding noise
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err),
                               rtol=1e-9, atol=1e-13)


def _jax_carry(frame, **over):
    """(rhs_fn, cfg, spec, carry0, f, env) of the JAX package for 16 rays:
    the 3D on-shell launch or the 2D ensemble fan, at the production
    ceilings (ds_max on)."""
    if frame == "3d":
        cfg_run, u0, f = _launch_3d(**over)
        env = cfg_run.medium.build()
        rf = lambda u, ff: j_rhs.rhs_3d(u, ff, env)  # noqa: E731
    else:
        cfg_run = j_config.preset("ensemble10k_production", dtype="float64",
                                  lats=(0.6, 0.8, 1.0, 1.1),
                                  chis=(-0.3, 0.3), freqs=(1000.0, 4000.0),
                                  **over)
        u0, f = j_run._build_u0(cfg_run, np.float64)
        env = j_make_env_lat()
        rf = lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env)  # noqa: E731
    cfg, spec = cfg_run.solver(), cfg_run.stop()
    assert cfg.ds_max > 0.0
    carry0 = jax.vmap(lambda u, ff: j_init_carry(rf, u, ff, cfg))(
        jnp.asarray(u0), jnp.asarray(f))
    return rf, cfg, spec, carry0, f, env


def _port_args(env, cfg, spec, carry0, f):
    return (carry_from_numpy({k: np.asarray(v) for k, v in
                              carry0._asdict().items()},
                             device="cpu", dtype=torch.float64),
            torch.tensor(np.asarray(f)), env_from_numpy(env._asdict()),
            solver_config_from(cfg), stop_spec_from(spec))


def _assert_carries(got, want, rtol):
    for name in RayCarry._fields:
        w = np.asarray(getattr(want, name))
        g = np.asarray(got[name])
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name == "u_lo":   # two-sum residuals (~1e-17)
            assert float(np.abs(g - w).max()) <= 1e-12
        elif w.ndim == 2:
            for j in range(w.shape[1]):
                _close(g[:, j], w[:, j], rtol, f"{name}[{j}]")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=name)


# The arc ceiling at ds_max = 0.005 RE binds on every one of the 24 steps
# (measured: all 384 ray-steps), so each step's dt is the ceiling, a
# smooth function of the state, and dopri5 is held to 1e-12. At the
# presets' 2e6 m the ceiling binds less often than dt_max, and where
# neither binds the controller feeds on an error estimate that is rounding
# noise at these tolerances (measured: the two packages then drift apart
# by ~1e-6 within 24 steps, ceiling on or off). bs3's estimate cancels to
# ~1e-9 of its terms, so the two packages' 1e-15 math-library differences
# reach ~1e-8 in dt and the states (test_torch_step_chunk.py), with
# identical statuses and counters
CEILING = dict(dt0=1e-4, ds_max=0.005)
@pytest.mark.parametrize("frame", ["2d_lat", "3d"])
@pytest.mark.parametrize("stepper,rtol", [("dopri5", 1e-12), ("bs3", 1e-6)])
def test_step_one_with_arc_ceiling_matches_jax(frame, stepper, rtol):
    rf, cfg, spec, carry0, f, env = _jax_carry(frame, **CEILING)
    gidx = 6 if frame == "3d" else 3
    step = jax.jit(jax.vmap(partial(j_step_one, rf, cfg=cfg, spec=spec,
                                    group_idx=gidx, adaptive=True,
                                    stepper=stepper)))
    want = carry0
    for _ in range(24):
        want = step(want, jnp.asarray(f))
    carry, ft, te, tcfg, tspec = _port_args(env, cfg, spec, carry0, f)
    trf, _ = rhs.frame_rhs(frame, te)
    got = step_loop(trf, carry, ft, tcfg, tspec, group_idx=gidx,
                    stepper=stepper, n_steps=24)
    _assert_carries(carry_to_numpy(got), want, rtol)
    # the ceiling is on the path: some step of the 24 ran at dt_cap < dt_max
    assert (np.asarray(want.dt) < cfg.dt_max).any()
    # the local ceiling is ported (test_torch_slice_variants.py), and every
    # stepper of the JAX package (test_torch_modes.py); an unknown
    # one is refused
    with pytest.raises(ValueError, match="unknown stepper"):
        _step_one(trf, carry, ft, tcfg, tspec, gidx, stepper="ros5")


@pytest.mark.parametrize("stepper,rtol", [("dopri5", 1e-12), ("bs3", 1e-6)])
def test_step_chunk_3d_cpu_matches_jax_steps(stepper, rtol):
    rf, cfg, spec, carry0, f, env = _jax_carry("3d", **CEILING)
    step = jax.jit(jax.vmap(partial(j_step_one, rf, cfg=cfg, spec=spec,
                                    group_idx=6, adaptive=True,
                                    stepper=stepper)))
    want = carry0
    for _ in range(24):
        want = step(want, jnp.asarray(f))
    launches, calls = sc.step_chunk.launches, sc.step_chunk_reference.calls
    got = sc.step_chunk(*_port_args(env, cfg, spec, carry0, f),
                        stepper=stepper, n_steps=24, frame="3d")
    assert sc.step_chunk.launches == launches          # no kernel on a CPU
    assert sc.step_chunk_reference.calls == calls + 1  # tensor
    _assert_carries(carry_to_numpy(got), want, rtol)


def test_step_chunk_3d_cpu_matches_pallas_interpret():
    """The plain version against the Pallas kernel itself, run as the JAX
    package's tests run it on the CPU (interpret mode), over rhs_3d."""
    from raytrace_tpu.ops import pallas_stepper

    rf, cfg, spec, carry0, f, env = _jax_carry("3d", **CEILING)
    n = 8
    carry0 = type(carry0)(*[x[:n] for x in carry0])
    f = f[:n]
    chunk = pallas_stepper.make_pallas_chunk(rf, cfg, spec, 6, True, n,
                                             interpret=True)
    want = chunk(carry0, jnp.asarray(f))
    got = sc.step_chunk(*_port_args(env, cfg, spec, carry0, f),
                        stepper="dopri5", n_steps=n, frame="3d")
    _assert_carries(carry_to_numpy(got), want, 1e-12)


def test_step_chunk_refuses_a_frame_mismatch():
    rf, cfg, spec, carry0, f, env = _jax_carry("3d", **CEILING)
    with pytest.raises(ValueError, match="frame"):
        sc.step_chunk(*_port_args(env, cfg, spec, carry0, f),
                      stepper="bs3", n_steps=4, frame="2d_lat")


def test_interop_carries_7_state():
    from raytrace_tpu.integrate.solve import RayCarry as JRayCarry

    rf, cfg, spec, carry0, f, env = _jax_carry("3d", **CEILING)
    carry = carry_from_numpy(carry0, device="cpu", dtype=torch.float64)
    assert carry.u.shape == (16, 7) and carry.status.dtype == torch.int32
    back = carry_to_numpy(carry)
    for name in RayCarry._fields:
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(carry0, name)))
    JRayCarry(**back)   # converts back field by field
    assert carry_from_numpy(back, device="cpu",
                            dtype=torch.float32).u.dtype == torch.float32
