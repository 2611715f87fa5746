"""Port parity for the full density medium, float64 on the CPU: the MLT
plasmapause shape (convection.py), make_env over every medium gate, the
MLT-resolved parameters, ne_total_m3 with phi, the fused density chain
_ne_and_grads over every medium, mu_and_grads_3d with d mu/d phi, and the
on-shell launch over the MLT medium. Inputs from numpy.random.default_rng;
every tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import convection as j_conv
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import dispersion as j_disp
from raytrace_tpu.ops import fused as j_fused
from raytrace_tpu_torch import convection
from raytrace_tpu_torch.interop import env_from_numpy
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import dispersion, fused, gradients

B0 = 3.12e-5
# (make_env kwargs) of every medium gate this slice ports, alone and under
# the MLT-resolved plasmasphere
MEDIA = {
    "mlt_ca1992": dict(ps_mlt=True),
    "mlt_gcpm": dict(ps_mlt=True, ps_model="gcpm"),
    "gcpm": dict(ps_model="gcpm", gcpm_bpow=0.5, gcpm_knee=0.3),
    "iono_mlt": dict(iono_mlt=True, mlt=15.0),
    "smooth": dict(ps_smooth=0.05),
    "refill": dict(ps_refill=0.5),
    "refill_q": dict(ps_refill=0.5, ps_refill_q=4.0),
    "duct": dict(duct_amp=0.5, duct_l0=3.0, duct_w=0.2),
    "mlt_smooth_refill_duct_de": dict(
        ps_mlt=True, ps_smooth=0.05, ps_refill=0.3, ps_refill_q=2.0,
        duct_amp=-0.4, duct_l0=3.5, duct_w=0.3, de_correction=True,
        iono_mlt=True),
    "mlt_gcpm_duct_5harm": dict(ps_mlt=True, ps_model="gcpm", duct_amp=0.5,
                                ps_mlt_harmonics=5, ps_mlt_tamp=900.0),
}
PARTIALS = ("dmu/dr", "dmu/dtheta", "dmu/dphi", "dmu/drho_r", "dmu/drho_t",
            "dmu/drho_p", "dmu/df")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _envs(name):
    kw = MEDIA[name]
    return j_medium.make_env(b0=B0, **kw), medium.make_env(b0=B0, **kw)


def _close(got, want, rtol, what):
    """Per output against its largest magnitude over the grid (partials
    that cancel to ~0 somewhere have no meaningful elementwise error)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e}"


def _grid(seed, n=256, th_lo=0.4):
    """3D states across the plasmasphere, the knee and the trough (out to
    L ~ 45 at th_lo=0.4, where branch 2 underflows and the sigmoid tails
    saturate), all local times (phi beyond one turn too)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.05, 7.0, n)
    th = rng.uniform(th_lo, np.pi - th_lo, n)
    ph = rng.uniform(-4.0, 7.0, n)
    rho = rng.normal(size=(3, n))
    rho = rng.uniform(2.0, 40.0, n) * rho / np.linalg.norm(rho, axis=0)
    f = rng.uniform(500.0, 8000.0, n)
    return r, th, ph, rho[0], rho[1], rho[2], f


@pytest.mark.parametrize("kp,mlt0,n_harm", [
    (3.0, 2.0, 3), (1.0, 18.0, 2), (5.0, 7.5, 5), (2.0, 0.0, 8),
])
def test_mlt_shape_fourier_matches_jax(kp, mlt0, n_harm):
    a0_t, c_t = convection.mlt_shape_fourier(kp, mlt0, n_harm=n_harm)
    a0_j, c_j = j_conv.mlt_shape_fourier(kp, mlt0, n_harm=n_harm)
    assert a0_t == a0_j and len(c_t) == len(c_j) == 1 + 2 * n_harm
    np.testing.assert_allclose(c_t, c_j, rtol=1e-13, atol=1e-13)
    assert convection.stagnation_point(kp) == j_conv.stagnation_point(kp)


@pytest.mark.parametrize("name", sorted(MEDIA))
def test_make_env_matches_jax(name):
    """Field for field: strings and tuple lengths exactly, every number
    to 1e-15 (day_weight's cosine is XLA's in the JAX package, libm's
    here)."""
    je, te = _envs(name)
    assert je._fields == te._fields
    for field in je._fields:
        a, b = getattr(je, field), getattr(te, field)
        if isinstance(a, str):
            assert a == b, field
        else:
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64),
                                       rtol=1e-15, atol=0, err_msg=field)
    # the JAX env converts field for field into the port's
    ce = env_from_numpy(je._asdict())
    assert isinstance(ce.ps_mlt_c, tuple) and ce._fields == te._fields
    assert bool(torch.isfinite(medium.ne_total_m3(
        torch.full((2,), 2.0), torch.zeros(2), ce)).all())
    # ... and so does a cast_env one, whose ps_mlt_c is an array
    assert env_from_numpy(j_medium.cast_env(je, jnp.float64)._asdict()) == ce


@pytest.mark.parametrize("name", ["mlt_ca1992", "mlt_gcpm",
                                  "mlt_gcpm_duct_5harm",
                                  "mlt_smooth_refill_duct_de"])
def test_mlt_params_and_ne_total_match_jax(name):
    je, te = _envs(name)
    r, th, ph = _grid(1)[:3]
    lat = np.pi / 2 - th
    pj, pt = jnp.asarray(ph), torch.tensor(ph)
    if te.ps_model == "gcpm":
        want = j_medium.mlt_gcpm_params(pj, je, with_grads=True)
        got = medium.mlt_gcpm_params(pt, te, with_grads=True)
    else:
        want = j_medium.mlt_ps_params(pj, je, with_grads=True)
        got = medium.mlt_ps_params(pt, te, with_grads=True)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                       atol=1e-13 * float(np.abs(w).max()))
    ne_j = j_medium.ne_total_m3(jnp.asarray(r), jnp.asarray(lat), je, phi=pj)
    ne_t = medium.ne_total_m3(torch.tensor(r), torch.tensor(lat), te, phi=pt)
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=1e-13)
    # without phi (the 2D frames) the medium is its phi = 0 meridian
    np.testing.assert_allclose(
        medium.ne_total_m3(torch.tensor(r), torch.tensor(lat), te).numpy(),
        np.asarray(j_medium.ne_total_m3(jnp.asarray(r), jnp.asarray(lat),
                                        je)), rtol=1e-13)


@pytest.mark.parametrize("with_mlt", [False, True])
@pytest.mark.parametrize("name", sorted(MEDIA))
def test_ne_and_grads_matches_jax(name, with_mlt):
    """The fused density chain and its partials at 1e-12 of each output's
    scale; with_mlt passes the MLT parameters at phi (the 3D path), which
    an axisymmetric medium's chain takes too."""
    je, te = _envs(name)
    if with_mlt and not medium.mlt_on(te):
        je = j_medium.make_env(b0=B0, ps_mlt=True, **MEDIA[name])
        te = medium.make_env(b0=B0, ps_mlt=True, **MEDIA[name])
    r, th, ph = _grid(2)[:3]
    lat = np.pi / 2 - th
    if with_mlt:
        mlt_j = (j_medium.mlt_gcpm_params if je.ps_model == "gcpm"
                 else j_medium.mlt_ps_params)(jnp.asarray(ph), je,
                                              with_grads=True)
        want = j_fused._ne_and_grads(jnp.asarray(r), jnp.asarray(lat), je,
                                     mlt=mlt_j)
        got = fused._ne_and_grads(torch.tensor(r), torch.tensor(lat), te,
                                  mlt=fused.mlt_params(torch.tensor(ph), te))
        assert len(got) == len(want) == 4
        assert float(np.abs(np.asarray(want[3])).max()) > 0.0
    else:
        want = j_fused._ne_and_grads(jnp.asarray(r), jnp.asarray(lat), je)
        got = fused._ne_and_grads(torch.tensor(r), torch.tensor(lat), te)
        assert len(got) == len(want) == 3
    for what, g, w in zip(("ne", "dne/dr", "dne/dlat", "dne/dphi"), got,
                          want):
        _close(g.numpy(), w, 1e-12, what)


@pytest.mark.parametrize("name", ["mlt_ca1992", "mlt_gcpm",
                                  "mlt_smooth_refill_duct_de",
                                  "mlt_gcpm_duct_5harm"])
def test_mu_and_grads_3d_mlt_matches_jax_and_autodiff(name):
    """mu and its seven partials with d mu/d phi != 0: against the JAX
    package's fused chain at 1e-11 of each partial's scale, and against the
    port's own autodiff of mu_3d (torch.func.grad) at 1e-11 too, out to
    L ~ 30: beyond, the autodiff of the written-out logistic meets
    0 * inf in a saturated tail (exp(-x) overflows), where the fused
    chain stays finite (test_ne_and_grads_matches_jax holds it to L ~ 45)."""
    je, te = _envs(name)
    pts = _grid(3, th_lo=0.5)
    mu_j, g_j = jax.vmap(lambda *a: j_fused.mu_and_grads_3d(*a, je))(
        *map(jnp.asarray, pts))
    tt = tuple(map(torch.tensor, pts))
    mu_t, g_t = fused.mu_and_grads_3d(*tt, te)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-12)
    for what, a, b in zip(PARTIALS, g_t, g_j):
        _close(a.numpy(), b, 1e-11, what)
    mu_a, g_a = gradients.mu_grads_3d(*tt, te, grad_mode=gradients.AUTODIFF)
    np.testing.assert_allclose(mu_t.numpy(), mu_a.numpy(), rtol=1e-12)
    for what, a, b in zip(PARTIALS, g_t, g_a):
        _close(a.numpy(), b.numpy(), 1e-11, what)
    assert float(np.abs(np.asarray(g_j[2])).max()) > 1e-2   # alive


def test_phi0_is_the_axisymmetric_medium():
    """The port's analogue of test_mlt3d.py::
    test_phi0_is_the_axisymmetric_medium_exactly: at phi = 0 the MLT
    parameters are the env's (the shape is normalized to S(a0) == 1; the
    Fourier sum rounds, hence 1e-12), and so is the density."""
    _, te = _envs("mlt_ca1992")
    ta = medium.make_env(b0=B0)
    z = torch.zeros(1, dtype=torch.float64)
    lppi_e, lppo_e, ne_lppi_e, trough_e = medium.mlt_ps_params(z, te)
    for got, want in ((lppi_e, ta.lppi), (lppo_e, ta.lppo),
                      (ne_lppi_e, ta.ne_lppi), (trough_e, ta.ps_trough)):
        np.testing.assert_allclose(float(got), want, rtol=1e-12)
    r = torch.tensor([1.5, 3.0, 4.3, 6.5], dtype=torch.float64)
    lat = torch.tensor([0.3, 0.6, 0.0, 0.9], dtype=torch.float64)
    np.testing.assert_allclose(
        medium.ne_total_m3(r, lat, te, phi=torch.zeros_like(r)).numpy(),
        medium.ne_total_m3(r, lat, ta).numpy(), rtol=1e-12)


def test_dmudphi_zero_iff_axisymmetric():
    """The analogue of test_mlt3d.py::test_dmudphi_zero_iff_axisymmetric:
    d mu/d phi != 0 from the density alone in the knee, exactly 0 over the
    axisymmetric medium, and the fused chain equals the port's autodiff
    there (1e-10, the JAX test's tolerance)."""
    _, te = _envs("mlt_ca1992")
    ta = medium.make_env(b0=B0)
    th = torch.tensor([np.pi / 2 - 1.05], dtype=torch.float64)
    one = torch.ones_like(th)
    rho = dispersion.consistent_rho_3d(4.0 * one, th, one,
                                       (one, one, 0.0 * one), 1000.0 * one,
                                       te)
    args = (4.0 * one, th, one, *rho, 1000.0 * one)
    _, g_mlt = gradients.mu_grads_3d(*args, te, grad_mode=gradients.AUTODIFF)
    _, g_axi = gradients.mu_grads_3d(*args, ta, grad_mode=gradients.AUTODIFF)
    _, f_axi = fused.mu_and_grads_3d(*args, ta)
    _, f_mlt = fused.mu_and_grads_3d(*args, te)
    assert float(g_axi[2]) == 0.0 and float(f_axi[2]) == 0.0
    assert abs(float(g_mlt[2])) > 1e-3
    np.testing.assert_allclose(float(f_mlt[2]), float(g_mlt[2]), rtol=1e-10)


@pytest.mark.parametrize("name", ["mlt_ca1992", "mlt_gcpm"])
def test_consistent_rho_3d_with_phi_matches_jax(name):
    """The on-shell launch over the MLT medium: |rho| = mu(psi) at the
    launch longitude, to 1e-12 of the JAX package's."""
    je, te = _envs(name)
    r, th, ph, kr, kt, kp, f = _grid(4)
    got = dispersion.consistent_rho_3d(
        *map(torch.tensor, (r, th, ph)),
        tuple(map(torch.tensor, (kr, kt, kp))), torch.tensor(f), te)
    want = jax.vmap(lambda *a: jnp.stack(j_disp.consistent_rho_3d(
        a[0], a[1], a[2], a[3:6], a[6], je)))(
        *map(jnp.asarray, (r, th, ph, kr, kt, kp, f)))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               np.asarray(want), rtol=1e-12)
    # and the launch depends on the longitude
    flat = dispersion.consistent_rho_3d(
        *map(torch.tensor, (r, th, 0.0 * ph)),
        tuple(map(torch.tensor, (kr, kt, kp))), torch.tensor(f), te)
    assert not np.allclose(flat[0].numpy(), got[0].numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["mlt_ca1992", "mlt_gcpm"])
def test_rhs_3d_with_dmudphi_matches_jax(name):
    """rhs_3d consumes d mu/d phi (the rho_phi equation): over the MLT
    medium it matches the JAX package's rhs_3d at 1e-12 of each
    component's scale, and its drho_phi/dt is alive."""
    from raytrace_tpu.ops import rhs as j_rhs
    from raytrace_tpu_torch.ops import rhs

    je, te = _envs(name)
    pts = _grid(5, th_lo=0.5)
    T = np.random.default_rng(6).uniform(0.0, 3.0, pts[0].size)
    u = np.stack([*pts[:6], T], axis=1)
    got = rhs.rhs_3d(torch.tensor(u), torch.tensor(pts[6]), te)
    want = jax.vmap(lambda uu, ff: j_rhs.rhs_3d(uu, ff, je))(
        jnp.asarray(u), jnp.asarray(pts[6]))
    for j in range(7):
        _close(got[:, j].numpy(), np.asarray(want)[:, j], 1e-12,
               f"du[{j}]/dt")
    axi = rhs.rhs_3d(torch.tensor(u), torch.tensor(pts[6]),
                     medium.make_env(b0=B0))
    assert float((got[:, 5] - axi[:, 5]).abs().max()) > 0.0
