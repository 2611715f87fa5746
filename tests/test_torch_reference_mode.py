"""Port parity for the reference scripts' modes, float64 on the CPU:
grad_mode="reference" (the closed-form dmu/dpsi, dmu/dr = 0 and in 3D the
Kimura rho partials) and legacy_freq_state (the 2D frequency read as
f + T), from ops/analytic.py through the gradient layer, the right-hand
sides, short trace legs and the rounds tracer, against the JAX package;
and the modes' refusals. Inputs come from numpy seeds; each comparison
states its tolerance.

The port takes mu and the angle and frequency partials of the reference
set from the fused chain, the JAX package from autodiff: the two agree
to ~1e-14 here (the JAX package documents 1e-11), so the gradients are
held at 1e-10 and dmu/dr to exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import trace as j_trace
from raytrace_tpu.models import dipole as j_dipole
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.models import make_env_raymain as j_make_env_raymain
from raytrace_tpu.ops import analytic as j_analytic
from raytrace_tpu.ops import gradients as j_gradients
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import (
    SolverConfig, init_carry, trace,
)
from raytrace_tpu_torch.models import dipole, make_env, make_env_lat
from raytrace_tpu_torch.models import make_env_raymain
from raytrace_tpu_torch.ops import analytic, gradients, rhs
from raytrace_tpu_torch.ops import step_chunk as sc
from raytrace_tpu_torch.parallel import ensemble

R0 = (RE + 1.0e6) / RE
B0_3D = 3.12e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(*xs):
    return tuple(torch.tensor(x) for x in xs)


def _rel(got, want):
    """Worst relative difference, against the largest magnitude where a
    value cancels to near zero."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 1e-300)
    return float(np.max(np.abs(got - want) / scale))


def _states_2d(seed, n=128):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.05, 4.0, n), rng.uniform(-1.0, 1.0, n),
            rng.uniform(-1.0, 1.0, n), rng.uniform(500.0, 8000.0, n))


def _states_3d(seed, n=128):
    rng = np.random.default_rng(seed)
    rho = rng.normal(size=(3, n))
    rho[2, ::4] = 0.0       # rho_phi = 0 exactly, as on the 3D launches
    return (rng.uniform(1.05, 4.0, n), rng.uniform(0.3, 2.8, n),
            rng.uniform(-3.0, 3.0, n), *rho, rng.uniform(500.0, 8000.0, n))


# ---- ops/analytic.py --------------------------------------------------


def test_mu_and_dmudpsi_matches_jax():
    """The closed form on random densities, fields, frequencies and
    angles, both roots: mu and dmu/dpsi at rtol 1e-13."""
    rng = np.random.default_rng(70)
    n = 256
    ne = 10.0 ** rng.uniform(6.0, 11.0, n)
    b = 10.0 ** rng.uniform(-7.5, -4.5, n)
    f = rng.uniform(300.0, 9000.0, n)
    psi = rng.uniform(0.05, 3.1, n)
    for root in (1.0, -1.0):
        want = j_analytic.mu_and_dmudpsi(ne, b, f, psi, root)
        got = analytic.mu_and_dmudpsi(*_t(ne, b, f, psi), root)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= 1e-13


def test_mu_dmudpsi_2d_lat_and_kimura_match_jax():
    """kimura_dmudrho over the dipole field (sign(0) = 0 on the rho_phi = 0
    quarter) at rtol 1e-13, and mu_dmudpsi_2d_lat over the canonical
    medium at 1e-12: it forms psi through tan and atan and the density
    through exp and log, whose last-ulp differences between the two math
    libraries the closed form's cancellation raises to ~3e-13; fd_grad as
    the reference's central difference."""
    je, te = j_make_env_lat(), make_env_lat()
    r, lat, chi, f = _states_2d(71)
    want = j_analytic.mu_dmudpsi_2d_lat(r, lat, chi, f, je)
    got = analytic.mu_dmudpsi_2d_lat(*_t(r, lat, chi, f), te)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-12

    r, th, ph, rr, rt, rp, f = _states_3d(72)
    rng = np.random.default_rng(73)
    mu = rng.uniform(5.0, 50.0, r.size)
    dmudpsi = rng.normal(size=r.size)
    psi = rng.uniform(0.05, 3.1, r.size)
    bj = j_dipole.b_vec_colat(r, th, ph, B0_3D)
    bt = dipole.b_vec_colat(*_t(r, th, ph), B0_3D)
    for g, w in zip(bt, bj):
        assert _rel(g.numpy(), w) <= 1e-15
    want = j_analytic.kimura_dmudrho(mu, dmudpsi, psi, bj, (rr, rt, rp))
    got = analytic.kimura_dmudrho(*_t(mu, dmudpsi, psi), bt, _t(rr, rt, rp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=1e-300)
    assert bool((got[2][::4] == 0).all())
    x = torch.tensor([0.3, 1.2], dtype=torch.float64)
    np.testing.assert_allclose(
        analytic.fd_grad(torch.sin, x, 1e-6).numpy(),
        np.cos(x.numpy()), rtol=1e-10)


# ---- ops/gradients.py -------------------------------------------------


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
@pytest.mark.parametrize("env_kw", [{}, dict(plasmasphere_on=False),
                                    dict(de_correction=True)])
def test_reference_gradients_2d_match_jax(frame, env_kw):
    je = j_make_env(b0=3.0696381e-5, **env_kw)
    te = make_env(b0=3.0696381e-5, **env_kw)
    r, lat, chi, f = _states_2d(74)
    ang = lat if frame == "2d_lat" else np.pi / 2 - lat
    jfn = (j_gradients.mu_grads_2d_lat if frame == "2d_lat"
           else j_gradients.mu_grads_2d_colat)
    tfn = (gradients.mu_grads_2d_lat if frame == "2d_lat"
           else gradients.mu_grads_2d_colat)
    want = jax.vmap(lambda *a: jfn(*a, je, "reference"))(
        *map(jnp.asarray, (r, ang, chi, f)))
    got = tfn(*_t(r, ang, chi, f), te, grad_mode="reference")
    assert bool((got[1] == 0).all()) and bool((np.asarray(want[1]) == 0).all())
    for k in (0, 2, 3, 4):
        assert _rel(got[k].numpy(), want[k]) <= 1e-10, k
    # the closed form differs from the true derivative that the fused set
    # carries (about -3x in the traced regime)
    fused = tfn(*_t(r, ang, chi, f), te)
    assert not np.allclose(fused[3].numpy(), got[3].numpy(), rtol=1e-3)


@pytest.mark.parametrize("env_kw", [{}, dict(ps_mlt=True)])
def test_reference_gradients_3d_match_jax(env_kw):
    """The axisymmetric medium, and the MLT-resolved one, whose closed form
    takes the density without longitude (as the JAX package's does) while
    mu and dmu/dphi carry it."""
    je, te = j_make_env(b0=B0_3D, **env_kw), make_env(b0=B0_3D, **env_kw)
    pts = _states_3d(75)
    mu_j, g_j = jax.vmap(lambda *a: j_gradients.mu_grads_3d(
        *a, je, "reference"))(*map(jnp.asarray, pts))
    mu_t, g_t = gradients.mu_grads_3d(*_t(*pts), te, grad_mode="reference")
    assert _rel(mu_t.numpy(), mu_j) <= 1e-10
    assert bool((g_t[0] == 0).all())
    assert bool((g_t[2] == 0).all()) == (not env_kw)
    for k in range(1, 7):
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]),
                                   rtol=1e-10, atol=1e-300, err_msg=str(k))
    # autograd of the traced mu stays the cross-check of the fused values
    # the reference set keeps (theta and f)
    mu_a, g_a = gradients.mu_grads_3d(*_t(*pts), te, grad_mode="autodiff")
    for k in (1, 6):
        assert _rel(g_t[k].numpy(), g_a[k].numpy()) <= 1e-10


# ---- ops/rhs.py -------------------------------------------------------


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
@pytest.mark.parametrize("grad_mode", ["fused", "reference"])
def test_legacy_rhs_matches_jax(frame, grad_mode):
    """The legacy right-hand sides (frequency f + T) at rtol 1e-10 of each
    component's largest magnitude, with either gradient set; legacy is
    live (differs from the clean form)."""
    je, te = j_make_env_lat(), make_env_lat()
    r, lat, chi, f = _states_2d(76)
    T = np.random.default_rng(77).uniform(0.0, 400.0, r.size)
    ang = lat if frame == "2d_lat" else np.pi / 2 - lat
    u = np.stack([r, ang, chi, T], 1)
    jfn = j_rhs.rhs_2d_lat if frame == "2d_lat" else j_rhs.rhs_2d_colat
    want = np.asarray(jax.vmap(lambda uu, ff: jfn(
        uu, ff, je, legacy_freq_state=True, grad_mode=grad_mode))(
        jnp.asarray(u), jnp.asarray(f)))
    fn, _ = rhs.frame_rhs(frame, te, grad_mode=grad_mode,
                          legacy_freq_state=True)
    got = fn(*_t(u, f)).numpy()
    scale = np.abs(want).max(axis=0)
    assert float(np.max(np.abs(got - want) / scale)) <= 1e-10
    clean = rhs.frame_rhs(frame, te, grad_mode=grad_mode)[0](*_t(u, f))
    assert not np.allclose(clean.numpy(), got, rtol=1e-6)


# ---- trace legs and the rounds tracer -----------------------------------


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
def test_trace_leg_matches_jax(frame):
    """The canonical launch through trace() in reference + legacy mode,
    dopri5 at rtol 1e-9, a short leg (t_max = 2e8 m, the leg of
    test_features.py::test_native_legacy_freq_vs_jax): status and counters
    equal, the final state at rtol 1e-12."""
    lat = frame == "2d_lat"
    je = j_make_env_lat() if lat else j_make_env_raymain()
    te = make_env_lat() if lat else make_env_raymain()
    f = 1000.0 if lat else 5000.0
    spec = dict(r_floor=1.0, t_max=2e8 / RE)
    if not lat:
        spec.update(lat_sign=-1.0, lat_offset=np.pi / 2)
    u0 = np.array([[R0, np.pi / 4, 0.0, 0.0]])
    jfn = j_rhs.rhs_2d_lat if lat else j_rhs.rhs_2d_colat
    want = j_trace(
        lambda u, ff: jfn(u, ff, je, legacy_freq_state=True,
                          grad_mode="reference"),
        jnp.asarray(u0), jnp.array([f]),
        cfg=JSolverConfig(rtol=1e-9, atol=1e-14, dt0=1e-4),
        spec=JStopSpec(**spec), max_steps=100000, chunk=256)
    got = trace(te, *_t(u0, np.array([f])), frame=frame,
                cfg=SolverConfig(rtol=1e-9, atol=1e-14, dt0=1e-4),
                spec=StopSpec(**spec), stepper="dopri5", max_steps=100000,
                chunk=256, grad_mode="reference", legacy_freq_state=True)
    for name in ("status", "n_accept", "n_reject"):
        assert int(getattr(got, name)[0]) == int(getattr(want, name)[0])
    assert int(got.status[0]) == events.MAX_PHASE_TIME
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-12)


# ---- refusals ---------------------------------------------------------


def _carry(env, frame="2d_lat", n=4):
    u0 = torch.tensor([[R0, 0.8, 0.1, 0.0]] * n, dtype=torch.float64)
    if frame == "3d":
        u0 = torch.tensor([[R0, 0.8, 0.0, 30.0, 30.0, 0.0, 0.0]] * n,
                          dtype=torch.float64)
    f = torch.full((n,), 2000.0, dtype=torch.float64)
    fn, _ = rhs.frame_rhs(frame, env)
    return init_carry(fn, u0, f, SolverConfig()), f


def test_reference_modes_refusals():
    """ValueError where the JAX package raises (the multi-ion medium and
    the non-axial fields under the reference set, legacy_freq_state in
    3D); NotImplementedError naming ROADMAP B7 where the step kernel has
    no instance (the autodiff set in the kernel and in the rounds tracer).
    Each holds on the CPU, where the plain version would otherwise run.
    The modes over the full-chain media take the ALTX instances and run."""
    x = torch.ones(2, dtype=torch.float64)
    ions = make_env_lat()._replace(eta_he=0.1)
    with pytest.raises(ValueError, match="protons-only"):
        gradients.mu_grads_2d_lat(x, x * 0.5, x * 0.1, x * 1000.0, ions,
                                  grad_mode="reference")
    tilted = make_env(b0=B0_3D, b_model="tilted", b_tilt=0.2)
    with pytest.raises(ValueError, match="centered-dipole"):
        gradients.mu_grads_3d(x, x, x, x, x, x, x * 1e3, tilted,
                              grad_mode="reference")
    with pytest.raises(ValueError, match="legacy_freq_state"):
        rhs.frame_rhs("3d", make_env(b0=B0_3D), legacy_freq_state=True)
    with pytest.raises(ValueError, match="legacy_freq_state"):
        ensemble.make_rounds_tracer(make_env(b0=B0_3D), device="cpu",
                                    dtype=torch.float64, frame="3d",
                                    legacy_freq_state=True)
    cfg, spec = SolverConfig(), StopSpec()
    plume = make_env(b0=B0_3D, ps_mlt=True)
    for env, frame, kw in (
        (plume, "3d", dict(grad_mode="reference")),
        (make_env_lat()._replace(ps_smooth=0.05), "2d_lat",
         dict(legacy_freq_state=True)),
    ):
        carry, f = _carry(env, frame)
        assert sc.medium_code(env, cfg, **kw) == sc.ALTX
        out = sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3",
                            n_steps=4, frame=frame, **kw)
        assert (out.n_accept + out.n_reject == 4).all()
    carry, f = _carry(make_env_lat())
    with pytest.raises(NotImplementedError, match="B7"):
        sc.step_chunk(carry, f, make_env_lat(), cfg, spec, stepper="bs3",
                      n_steps=4, grad_mode="autodiff")
    with pytest.raises(ValueError, match="protons-only"):
        sc.step_chunk(carry, f, ions, cfg, spec, stepper="bs3", n_steps=4,
                      grad_mode="reference")
    with pytest.raises(NotImplementedError, match="B7"):
        ensemble.make_rounds_tracer(make_env_lat(), device="cpu",
                                    dtype=torch.float64,
                                    grad_mode="autodiff")
    # the axisymmetric medium takes the ALT instances, whatever the frame
    for frame in ("2d_lat", "2d_colat"):
        assert sc.medium_code(make_env_lat(), cfg, "fused", True) == sc.ALT
    assert sc.medium_code(make_env(b0=B0_3D), cfg, "reference") == sc.ALT
    assert sc.medium_code(make_env(b0=B0_3D), cfg) == sc.AXI
