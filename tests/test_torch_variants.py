"""Port parity for the last variants of the step, float64 on the CPU: the
colatitude frame (mu_grads_2d_colat, rhs_2d_colat), the multi-ion
composition (ion_species, stix_rlp and the species sums of the three fused
chains, at both roots), the local arc ceiling and fixed-step rk4 (the
stepper, and trace with adaptive=False on the JAX package's toy problems,
tests/test_integrate.py), each against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import trace as j_trace
from raytrace_tpu.integrate.solve import _local_arc_ceiling as j_local
from raytrace_tpu.integrate.steppers import rk4_step as j_rk4_step
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import dispersion as j_disp
from raytrace_tpu.ops import fused as j_fused
from raytrace_tpu.ops import gradients as j_grad
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.constants import FCE_E, FCE_HE, FCE_P, FPE2_E, FPE2_P
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import (
    SolverConfig, _local_arc_ceiling, trace,
)
from raytrace_tpu_torch.integrate.steppers import rk4_step
from raytrace_tpu_torch.interop import env_from_numpy
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import dispersion, fused, gradients, rhs
from raytrace_tpu_torch.ops import step_chunk as sc

B0_2D = 3.0696381e-5
# the He+ and O+ fractions of the emic_heband preset, and a heavier mix
IONS = [(0.1, 0.02), (0.15, 0.05), (0.0, 0.05), (0.2, 0.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, rtol, what):
    """Against the output's largest magnitude over the grid (a partial
    that cancels to ~0 somewhere has no meaningful elementwise error)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e}"


def _envs(**kw):
    return j_medium.make_env(**kw), medium.make_env(**kw)


def _points_2d(seed, n=512, f_lo=500.0, f_hi=8000.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.05, 6.0, n), rng.uniform(-1.1, 1.1, n),
            rng.uniform(-1.5, 1.5, n), rng.uniform(f_lo, f_hi, n))


@pytest.mark.parametrize("eta", [(0.0, 0.0)] + IONS)
def test_ion_species_matches_jax(eta):
    assert dispersion.ion_species(*eta) == j_disp.ion_species(*eta)


@pytest.mark.parametrize("eta", IONS)
def test_stix_rlp_multiion_matches_jax(eta):
    rng = np.random.default_rng(60)
    ne = 10.0 ** rng.uniform(6.0, 11.0, 512)
    bm = 10.0 ** rng.uniform(-7.0, -4.5, 512)
    f = 10.0 ** rng.uniform(-0.5, 4.0, 512)
    got = dispersion.stix_rlp(*map(torch.tensor, (ne, bm, f)), *eta)
    want = j_disp.stix_rlp(*map(jnp.asarray, (ne, bm, f)), *eta)
    for name, a, b in zip("RLP", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   err_msg=name)


def test_zero_fractions_reduce_to_reference_algebra():
    """The mirror of tests/test_multiion.py's: protons alone are the
    two-species algebra, and fractions of 0 drop their species."""
    ne, b, f = 1.0e9, 1.0e-6, 3000.0
    r, l, p = (float(x) for x in dispersion.stix_rlp(
        *(torch.tensor(x, dtype=torch.float64) for x in (ne, b, f))))
    ncm = ne * 1e-6
    xe, xp = FPE2_E * ncm / f**2, FPE2_P * ncm / f**2
    ye, yp = FCE_E * b / f, FCE_P * b / f
    assert r == pytest.approx(1 - xe / (1 - ye) - xp / (1 + yp), rel=1e-14)
    assert l == pytest.approx(1 - xe / (1 + ye) - xp / (1 - yp), rel=1e-14)
    assert p == pytest.approx(1 - xe - xp, rel=1e-14)
    assert len(dispersion.ion_species(0.0, 0.0)) == 1


def test_helium_resonance_in_l():
    """L has a pole at the He+ gyrofrequency (the He+-band structure)."""
    t = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    ne, b = t(1.0e9), t(1.0e-6)
    fc_he = FCE_HE * 1.0e-6
    _, l_lo, _ = dispersion.stix_rlp(ne, b, t(fc_he * 0.999), 0.1)
    _, l_hi, _ = dispersion.stix_rlp(ne, b, t(fc_he * 1.001), 0.1)
    _, l_far, _ = dispersion.stix_rlp(ne, b, t(fc_he * 2.0), 0.1)
    assert float(l_lo) * float(l_hi) < 0.0
    assert abs(float(l_lo)) > 50.0 * abs(float(l_far))


@pytest.mark.parametrize("root", [1.0, -1.0])
@pytest.mark.parametrize("band", ["emic", "whistler"])
def test_fused_2d_multiion_matches_jax(band, root):
    """mu_and_grads_2d_lat over a He+/O+ plasma (the mirror of
    tests/test_multiion.py::test_fused_matches_autodiff_multiion, here
    against the JAX package's own chain): 1e-12 of each output's largest
    magnitude."""
    je, te = _envs(b0=B0_2D, eta_he=0.15, eta_o=0.05)
    lo, hi = (0.5, 40.0) if band == "emic" else (200.0, 8000.0)
    pts = _points_2d(61, f_lo=lo, f_hi=hi)
    got = fused.mu_and_grads_2d_lat(*map(torch.tensor, pts), te, root)
    want = j_fused.mu_and_grads_2d_lat(*map(jnp.asarray, pts), je, root)
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy(), b, 1e-12, f"output {k}")


def _points_3d(seed, n=512):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.05, 5.0, n), rng.uniform(0.3, 2.8, n),
            rng.uniform(-3.0, 3.0, n), *(rng.normal(size=(3, n)) * 20.0),
            rng.uniform(200.0, 8000.0, n))


@pytest.mark.parametrize("root", [1.0, -1.0])
@pytest.mark.parametrize("field", ["dipole", "tilted", "igrf"])
def test_fused_3d_multiion_matches_jax(field, root):
    """The 3D chains (mu_and_grads_3d over the dipole and the MLT medium,
    mu_and_grads_3d_general over the tilted and IGRF fields) with He+ and
    O+: mu and its seven partials at 1e-12 of each one's largest
    magnitude."""
    kw = dict(b0=3.12e-5, ps_mlt=True, eta_he=0.1, eta_o=0.02)
    if field == "tilted":
        kw.update(b_model="tilted", b_tilt=0.2, b_tilt_phi=0.5)
    elif field == "igrf":
        kw.update(b_model="igrf")
    je, te = _envs(**kw)
    pts = _points_3d(62)
    t_fn, j_fn = ((fused.mu_and_grads_3d, j_fused.mu_and_grads_3d)
                  if field == "dipole" else
                  (fused.mu_and_grads_3d_general,
                   j_fused.mu_and_grads_3d_general))
    mu_t, g_t = t_fn(*map(torch.tensor, pts), te, root)
    mu_j, g_j = jax.vmap(lambda *a: j_fn(*a, je, root))(
        *map(jnp.asarray, pts))
    _close(mu_t.numpy(), mu_j, 1e-12, "mu")
    for k, (a, b) in enumerate(zip(g_t, g_j)):
        _close(a.numpy(), b, 1e-12, f"partial {k}")


@pytest.mark.parametrize("freq", [30.0, 400.0, 3000.0],
                         ids=["emic_band", "ion_whistler", "whistler"])
def test_fused_matches_autodiff_multiion(freq):
    """The port's fused chain is the derivative of its own traced mu in a
    multi-ion plasma (torch.func autodiff), as test_multiion.py holds the
    JAX package's."""
    _, te = _envs(eta_he=0.15, eta_o=0.05)
    r, lat, chi, _ = _points_2d(63, n=128)
    pts = (r, lat, chi, np.full(r.size, freq))
    tt = tuple(map(torch.tensor, pts))
    fz = gradients.mu_grads_2d_lat(*tt, te, grad_mode=gradients.FUSED)
    ad = gradients.mu_grads_2d_lat(*tt, te, grad_mode=gradients.AUTODIFF)
    for k, (a, b) in enumerate(zip(fz, ad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-12, err_msg=str(k))


def test_make_env_takes_ion_fractions_and_validates_them():
    with pytest.raises(ValueError):
        medium.make_env(eta_he=0.7, eta_o=0.4)   # fractions sum >= 1
    with pytest.raises(ValueError):
        medium.make_env(eta_he=-0.1)
    je, te = _envs(b0=B0_2D, eta_he=0.1, eta_o=0.02)
    assert env_from_numpy(je._asdict()) == te
    assert medium.make_env_raymain() == env_from_numpy(
        j_medium.make_env_raymain()._asdict())


@pytest.mark.parametrize("grad_mode", ["fused", "autodiff"])
@pytest.mark.parametrize("root", [1.0, -1.0])
def test_mu_grads_2d_colat_matches_jax(root, grad_mode):
    je, te = _envs(b0=B0_2D, eta_he=0.1, eta_o=0.02)
    r, lat, chi, f = _points_2d(64)
    pts = (r, np.pi / 2 - lat, chi, f)
    got = gradients.mu_grads_2d_colat(*map(torch.tensor, pts), te,
                                      grad_mode, root)
    want = jax.vmap(lambda *a: j_grad.mu_grads_2d_colat(
        *a, je, grad_mode, root))(*map(jnp.asarray, pts))
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy(), b, 1e-12, f"output {k}")
    # the fused chain's mu is the dispersion relation's in this frame
    mu = dispersion.mu_2d_colat(*map(torch.tensor, pts), te, root)
    np.testing.assert_allclose(got[0].numpy(), mu.numpy(), rtol=1e-12)


@pytest.mark.parametrize("root,ions", [(1.0, (0.0, 0.0)), (-1.0, (0.0, 0.0)),
                                       (1.0, (0.1, 0.02)),
                                       (-1.0, (0.1, 0.02))])
def test_rhs_2d_colat_matches_jax(root, ions):
    je, te = _envs(b0=B0_2D, eta_he=ions[0], eta_o=ions[1])
    r, lat, chi, f = _points_2d(65)
    T = np.random.default_rng(66).uniform(0.0, 3.0, r.size)
    u = np.stack([r, np.pi / 2 - lat, chi, T], axis=1)
    got = rhs.rhs_2d_colat(torch.tensor(u), torch.tensor(f), te, root=root)
    want = jax.vmap(lambda uu, ff: j_rhs.rhs_2d_colat(uu, ff, je,
                                                      root=root))(
        jnp.asarray(u), jnp.asarray(f))
    for j in range(4):
        _close(got[:, j].numpy(), np.asarray(want)[:, j], 1e-12,
               f"du[{j}]/dt")
    assert rhs.frame_rhs("2d_colat", te, root)[1] == 3


@pytest.mark.parametrize("frame,shells,frac", [
    ("2d_lat", (), 1.0), ("2d_lat", ((3.0, 0.1),), 0.5),
    ("2d_colat", ((2.5, 0.05), (3.5, 0.2)), 1.0), ("3d", ((3.0, 0.1),), 2.0),
])
def test_local_arc_ceiling_matches_jax(frame, shells, frac):
    rng = np.random.default_rng(67)
    n = 512
    lat = rng.uniform(-1.2, 1.2, n)
    u = np.zeros((n, 7 if frame == "3d" else 4))
    u[:, 0] = rng.uniform(1.0, 6.0, n)
    u[:, 1] = lat if frame == "2d_lat" else np.pi / 2 - lat
    spec = (JStopSpec() if frame == "2d_lat"
            else JStopSpec(lat_sign=-1.0, lat_offset=np.pi / 2))
    cfg = JSolverConfig(ds_local_knee=4.4, ds_local_w=0.1,
                        ds_local_frac=frac, ds_local_shells=shells)
    tspec = StopSpec(*map(float, spec))
    tcfg = SolverConfig(**{k: v if isinstance(v, tuple) else float(v)
                           for k, v in cfg._asdict().items()})
    got = _local_arc_ceiling(torch.tensor(u), tspec, tcfg)
    want = jax.vmap(lambda uu: j_local(uu, spec, cfg))(jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    # tight at a shell, open (r/4.5) far from every shell
    assert float(got.min()) < 0.2 * frac and float(got.max()) > 0.5 * frac


def test_rk4_step_matches_jax():
    _, te = _envs(b0=B0_2D)
    je = j_medium.make_env(b0=B0_2D)
    r, lat, chi, f = _points_2d(68, n=256)
    u = np.stack([r, lat, chi, np.zeros_like(r)], axis=1)
    dt = np.random.default_rng(69).uniform(1e-4, 0.1, r.size)
    tf = torch.tensor(f)
    got = rk4_step(lambda uu: rhs.rhs_2d_lat(uu, tf, te), torch.tensor(u),
                   rhs.rhs_2d_lat(torch.tensor(u), tf, te), torch.tensor(dt))
    jfn = lambda uu, ff: j_rhs.rhs_2d_lat(uu, ff, je)  # noqa: E731
    want = jax.vmap(lambda uu, ff, hh: j_rk4_step(
        lambda x: jfn(x, ff), uu, jfn(uu, ff), hh))(
        jnp.asarray(u), jnp.asarray(f), jnp.asarray(dt))
    for name in ("u_new", "k_end", "incr"):
        w = np.asarray(getattr(want, name))
        for j in range(4):
            _close(getattr(got, name)[:, j].numpy(), w[:, j], 1e-12,
                   f"{name}[{j}]")
    assert float(got.err.abs().max()) == 0.0


def _toy(monkeypatch, fn):
    """Serve the rhs `fn(u (B, 4), f (B,))` as a frame of the port's trace
    (its plain version on the CPU steps any frame's right-hand side)."""
    monkeypatch.setitem(rhs.FRAMES, "toy",
                        (lambda u, f, env, root=1.0: fn(u, f), 3))
    monkeypatch.setitem(sc._FRAME_CODE, "toy", (0, 4))


def _oscillator(u, f):
    return torch.stack([u[..., 1], -u[..., 0], torch.zeros_like(u[..., 0]),
                        torch.ones_like(u[..., 0])], dim=-1)


def test_rk4_order_through_trace(monkeypatch):
    """Fixed rk4 through trace(adaptive=False) on x'' = -x: at least 4th
    order (the mirror of test_integrate.py::test_rk4_order)."""
    _toy(monkeypatch, _oscillator)
    errs = []
    for n in (100, 200):
        dt = float(2.0 * np.pi / n)
        res = trace(medium.make_env_lat(),
                    torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float64),
                    torch.zeros(1, dtype=torch.float64),
                    frame="toy", cfg=SolverConfig(dt0=dt, dt_max=dt),
                    spec=StopSpec(r_floor=-2.0, t_max=2.0 * np.pi),
                    adaptive=False, max_steps=n + 8, chunk=n + 8)
        # n steps of dt, and at most one more to close a rounding gap
        # to t_max
        assert int(res.status[0]) == events.MAX_PHASE_TIME
        assert int(res.n_accept[0]) in (n, n + 1)
        assert int(res.n_reject[0]) == 0
        assert float(res.t[0]) == pytest.approx(2.0 * np.pi, rel=1e-14)
        errs.append(abs(float(res.u[0, 0]) - 1.0))
    assert errs[0] / errs[1] > 12.0


def _decay(u, f):
    z = torch.zeros_like(u[..., 0])
    return torch.stack([z - 1.0, z, z, z], dim=-1)


def _southward(u, f):
    z = torch.zeros_like(u[..., 0])
    return torch.stack([z, z - 1.0, z, z], dim=-1)


def _mixed(u, f):
    z = torch.zeros_like(u[..., 0])
    dr = torch.where(u[..., 1] > 10.0, torch.full_like(z, float("nan")),
                     z - 0.1)
    return torch.stack([dr, z, z, z], dim=-1)


def _j_decay(u, f):
    return jnp.stack([-jnp.ones_like(u[0]), jnp.zeros_like(u[0]),
                      jnp.zeros_like(u[0]), jnp.zeros_like(u[0])])


def _j_southward(u, f):
    return jnp.stack([jnp.zeros_like(u[0]), -jnp.ones_like(u[0]),
                      jnp.zeros_like(u[0]), jnp.zeros_like(u[0])])


def _j_mixed(u, f):
    dr = jnp.where(u[1] > 10.0, jnp.nan, -0.1)
    return jnp.stack([jnp.full_like(u[0], dr), jnp.zeros_like(u[0]),
                      jnp.zeros_like(u[0]), jnp.zeros_like(u[0])])


# the three fixed-step toy problems of tests/test_integrate.py: a linear
# decay localized at the surface (HIT_EARTH at t = 1), a southward drift
# localized at the equator (HIT_EQUATOR at t = 0.35), and a batch in which
# one ray goes non-finite (INVALID) without touching its neighbour
TOYS = {
    "decay": (_decay, _j_decay, [[2.0, 0.5, 0.0, 0.0]], 0.3,
              dict(r_floor=1.0, t_max=10.0), [events.HIT_EARTH]),
    "equator": (_southward, _j_southward, [[2.0, 0.35, 0.0, 0.0]], 0.1,
                dict(r_floor=1.0, t_max=10.0, stop_at_equator=1.0),
                [events.HIT_EQUATOR]),
    "isolation": (_mixed, _j_mixed, [[2.0, 0.5, 0.0, 0.0],
                                     [2.0, 20.0, 0.0, 0.0]], 0.5,
                  dict(r_floor=1.0, t_max=100.0),
                  [events.HIT_EARTH, events.INVALID]),
}


@pytest.mark.parametrize("name", sorted(TOYS))
def test_fixed_step_trace_on_toy_problems_matches_jax(monkeypatch, name):
    fn, jfn, u0, dt, stop, want_status = TOYS[name]
    _toy(monkeypatch, fn)
    n = len(u0)
    res = trace(medium.make_env_lat(), torch.tensor(u0, dtype=torch.float64),
                torch.zeros(n, dtype=torch.float64), frame="toy",
                cfg=SolverConfig(dt0=dt, dt_max=dt), spec=StopSpec(**stop),
                adaptive=False, stepper="ros3pr", max_steps=100)
    want = j_trace(jfn, jnp.asarray(u0), jnp.zeros(n),
                   cfg=JSolverConfig(dt0=dt, dt_max=dt),
                   spec=JStopSpec(**stop), adaptive=False, max_steps=100)
    assert res.status.tolist() == want_status
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(res.n_accept.numpy(),
                                  np.asarray(want.n_accept))
    assert res.n_reject.tolist() == [0] * n
    ok = np.isfinite(np.asarray(want.u)).all(axis=1)
    np.testing.assert_allclose(res.u.numpy()[ok], np.asarray(want.u)[ok],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(res.t.numpy()[ok], np.asarray(want.t)[ok],
                               rtol=1e-12, atol=1e-12)
    if name == "decay":
        assert float(res.t[0]) == pytest.approx(1.0, abs=1e-9)
    elif name == "equator":
        assert float(res.t[0]) == pytest.approx(0.35, abs=1e-9)
