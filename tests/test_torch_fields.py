"""Port parity for the non-axial fields, float64 on the CPU: the tilted
dipole and the IGRF truncation (models/dipole.py), make_env over both,
the magnetic latitude and longitude that organize the density, mu_3d and
the on-shell launch, the general gradient chain mu_and_grads_3d_general
(against the JAX package's, against the port's own autodiff, its hand
tangents against torch.func.jvp), rhs_3d, and the C++ oracle. Inputs from
numpy.random.default_rng; every tolerance is stated where it is used."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.models import dipole as j_dipole
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import dispersion as j_disp
from raytrace_tpu.ops import fused as j_fused
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.interop import env_from_numpy
from raytrace_tpu_torch.models import dipole, medium
from raytrace_tpu_torch.ops import dispersion, fused, gradients, rhs

B0 = 3.12e-5
TILT, PHI0 = 0.3, 0.7
FIELDS = {
    "tilted": dict(b_model="tilted", b_tilt=0.2, b_tilt_phi=0.5),
    "igrf": dict(b_model="igrf"),
}
PARTIALS = ("dmu/dr", "dmu/dtheta", "dmu/dphi", "dmu/drho_r", "dmu/drho_t",
            "dmu/drho_p", "dmu/df")
GEOM = ("B_r", "B_theta", "B_phi", "mlat", "mlon")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _envs(**kw):
    return j_medium.make_env(b0=B0, **kw), medium.make_env(b0=B0, **kw)


def _close(got, want, rtol, what):
    """Per output against its largest magnitude over the grid (partials
    that cancel to ~0 somewhere have no meaningful elementwise error)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e}"


def _points(seed, n=200):
    """(r, theta, phi) over the shells and all longitudes (phi beyond one
    turn too), clear of the geographic axis."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.05, 7.0, n), rng.uniform(0.3, np.pi - 0.3, n),
            rng.uniform(-4.0, 7.0, n))


def _grid(seed=0, n=160):
    """The grid of tests/test_mlt3d.py::_parity_grid: all three CA1992
    branches, every local time, |rho| = 20."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.2, 7.0, n)
    th = rng.uniform(0.4, 2.6, n)
    phi = rng.uniform(-4.0, 7.0, n)
    f = rng.uniform(500.0, 8000.0, n)
    k = rng.normal(size=(3, n))
    k = 20.0 * k / np.linalg.norm(k, axis=0)
    return r, th, phi, k[0], k[1], k[2], f


# ---- the six field functions, 1e-14 relative ---------------------------

def _field_pair(name):
    """(port value, JAX value) of one field function on _points(1)."""
    r, th, ph = _points(1)
    tt = tuple(map(torch.tensor, (r, th, ph)))
    jj = tuple(map(jnp.asarray, (r, th, ph)))
    if name == "moment_unit":
        return dipole.moment_unit(TILT, PHI0), j_dipole.moment_unit(TILT, PHI0)
    if name == "b_vec_tilted":
        return (dipole.b_vec_tilted(*tt, B0, TILT, PHI0),
                j_dipole.b_vec_tilted(*jj, B0, TILT, PHI0))
    if name == "mlat_sin_tilted":
        return ((dipole.mlat_sin_tilted(tt[1], tt[2], TILT, PHI0),),
                (j_dipole.mlat_sin_tilted(jj[1], jj[2], TILT, PHI0),))
    if name == "mlon_tilted":
        return ((dipole.mlon_tilted(tt[1], tt[2], TILT, PHI0),),
                (j_dipole.mlon_tilted(jj[1], jj[2], TILT, PHI0),))
    if name == "igrf_dipole":
        return (dipole.igrf_dipole(dipole.IGRF13_2020),
                j_dipole.igrf_dipole(j_dipole.IGRF13_2020))
    if name == "b_vec_igrf":
        return (dipole.b_vec_igrf(*tt, dipole.IGRF13_2020),
                j_dipole.b_vec_igrf(*jj, j_dipole.IGRF13_2020))
    return ((dipole.igrf_potential(*tt, dipole.IGRF13_2020),),
            (j_dipole.igrf_potential(*jj, j_dipole.IGRF13_2020),))


@pytest.mark.parametrize("name", [
    "moment_unit", "b_vec_tilted", "mlat_sin_tilted", "mlon_tilted",
    "igrf_dipole", "b_vec_igrf", "igrf_potential"])
def test_field_function_matches_jax(name):
    """Each component at 1e-14 of its largest magnitude over the points
    (the port forms 1/r^3 as a product of reciprocals, the tilt's sines
    with libm: a few ulp)."""
    got, want = _field_pair(name)
    assert dipole.IGRF13_2020 == j_dipole.IGRF13_2020
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(np.asarray(g, np.float64), np.asarray(w, np.float64), 1e-14,
               f"{name}[{i}]")


# ---- make_env and the medium's dispatch ---------------------------------

@pytest.mark.parametrize("kw", [
    dict(b_model="tilted", b_tilt=0.2, b_tilt_phi=0.5),
    dict(b_model="igrf"),
    dict(b_model="igrf", ps_mlt=True, ps_model="gcpm"),
    dict(b_model="tilted", b_tilt=0.2007, b_tilt_phi=1.0, ps_mlt=True,
         duct_amp=0.5, iono_mlt=True),
    dict(b_model="igrf",
         igrf_coeffs=tuple(1.1 * c for c in j_dipole.IGRF13_2020)),
], ids=["tilted", "igrf", "igrf_mlt_gcpm", "tilted_mlt_duct", "igrf_coeffs"])
def test_make_env_fields_match_jax(kw):
    """Field for field: strings and tuple lengths exactly, every number
    to 1e-15; a JAX env converts into the port's through env_from_numpy,
    igrf_coeffs as a tuple of 15 Python floats."""
    je, te = _envs(**kw)
    assert je._fields == te._fields and te.b_model == kw["b_model"]
    for field in je._fields:
        a, b = getattr(je, field), getattr(te, field)
        if isinstance(a, str):
            assert a == b, field
        else:
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64),
                                       rtol=1e-15, atol=0, err_msg=field)
    ce = env_from_numpy(je._asdict())
    assert ce == te
    assert bool(torch.isfinite(medium.ne_total_m3(
        torch.full((2,), 2.0), torch.zeros(2), ce)).all())
    assert isinstance(ce.igrf_coeffs, tuple)
    assert all(type(c) is float for c in ce.igrf_coeffs)
    assert len(ce.igrf_coeffs) == (15 if te.b_model == "igrf" else 0)
    assert env_from_numpy(j_medium.cast_env(je, jnp.float64)._asdict()) == ce
    if te.b_model == "igrf":
        # the degree-1 moment replaces b0 and sets the tilted frame
        b0, tilt, phi0 = dipole.igrf_dipole(te.igrf_coeffs)
        assert (te.b0, te.b_tilt, te.b_tilt_phi) == (b0, tilt, phi0)
        assert te.b0 != B0


def test_make_env_refuses_bad_fields():
    with pytest.raises(ValueError, match="unknown b_model"):
        medium.make_env(b_model="t96")
    with pytest.raises(ValueError, match="15 Schmidt"):
        medium.make_env(b_model="igrf", igrf_coeffs=(1.0, 2.0, 3.0))


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_medium_dispatch_matches_jax(field):
    """b_vec, mlat_3d (asin of the clipped sine) and mlon_3d at 1e-14."""
    je, te = _envs(ps_mlt=True, **FIELDS[field])
    r, th, ph = _points(2)
    tt = tuple(map(torch.tensor, (r, th, ph)))
    jj = tuple(map(jnp.asarray, (r, th, ph)))
    for what, g, w in zip(GEOM, (*medium.b_vec(*tt, te),
                                 medium.mlat_3d(*tt, te),
                                 medium.mlon_3d(*tt, te)),
                          (*j_medium.b_vec(*jj, je),
                           j_medium.mlat_3d(*jj, je),
                           j_medium.mlon_3d(*jj, je))):
        _close(g.numpy(), w, 1e-14, what)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_2d_entries_refuse_the_field(field):
    """The JAX package's ValueError at the 2D entries: b_mag (and so
    mu_2d_lat's autodiff) and the fused 2D gradient entry."""
    je, te = _envs(**FIELDS[field])
    x = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="3D-only"):
        medium.b_mag(2.0 * x, 0.3 * x, te)
    with pytest.raises(ValueError, match="3D-only"):
        j_medium.b_mag(2.0, 0.3, je)
    for mode in (gradients.FUSED, gradients.AUTODIFF):
        with pytest.raises(ValueError, match="3D-only"):
            gradients.mu_grads_2d_lat(2.0 * x, 0.3 * x, 0.1 * x, 1e3 * x,
                                      te, grad_mode=mode)
    with pytest.raises(ValueError, match="3D-only"):
        rhs.rhs_2d_lat(torch.ones(2, 4, dtype=torch.float64), 1e3 * x, te)


# ---- mu_3d and the on-shell launch, 1e-12 --------------------------------

@pytest.mark.parametrize("field", sorted(FIELDS))
def test_mu_3d_and_consistent_rho_match_jax(field):
    je, te = _envs(ps_mlt=True, **FIELDS[field])
    pts = _grid(3)
    mu_t = dispersion.mu_3d(*map(torch.tensor, pts), te)
    mu_j = jax.vmap(lambda *a: j_disp.mu_3d(*a, je))(*map(jnp.asarray, pts))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-12)
    r, th, ph, kr, kt, kp, f = pts
    got = dispersion.consistent_rho_3d(
        *map(torch.tensor, (r, th, ph)),
        tuple(map(torch.tensor, (kr, kt, kp))), torch.tensor(f), te)
    want = jax.vmap(lambda *a: jnp.stack(j_disp.consistent_rho_3d(
        a[0], a[1], a[2], a[3:6], a[6], je)))(*map(jnp.asarray, pts))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               np.asarray(want), rtol=1e-12)


# ---- the general chain ---------------------------------------------------

@pytest.mark.parametrize("b_model", ["tilted", "igrf"])
@pytest.mark.parametrize("mlt", [False, True])
@pytest.mark.parametrize("ps_model", ["ca1992", "gcpm"])
def test_fused_general_matches_jax_and_autodiff_grid(b_model, mlt, ps_model):
    """The grid of tests/test_mlt3d.py::
    test_fused_general_matches_autodiff_grid (tilted/IGRF x MLT on/off x
    CA1992/GCPM): mu and its seven partials against the JAX package's
    general chain at 1e-11 of each partial's scale, and against the
    port's own autodiff of mu_3d at that test's tolerance, 1e-9 (|A| +
    max |A|) per entry."""
    je, te = _envs(b_model=b_model, b_tilt=0.2, ps_mlt=mlt,
                   ps_model=ps_model)
    pts = _grid()
    mu_j, g_j = jax.vmap(lambda *a: j_fused.mu_and_grads_3d_general(*a, je))(
        *map(jnp.asarray, pts))
    tt = tuple(map(torch.tensor, pts))
    mu_t, g_t = fused.mu_and_grads_3d_general(*tt, te)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-12)
    for what, a, b in zip(PARTIALS, g_t, g_j):
        _close(a.numpy(), b, 1e-11, what)
    # gradients.mu_grads_3d routes a non-dipole field to the general chain
    mu_r, g_r = gradients.mu_grads_3d(*tt, te)
    assert torch.equal(mu_r, mu_t)
    assert all(torch.equal(a, b) for a, b in zip(g_r, g_t))
    mu_a, g_a = gradients.mu_grads_3d(*tt, te, grad_mode=gradients.AUTODIFF)
    A = np.stack([mu_a.numpy(), *(g.numpy() for g in g_a)], axis=1)
    B = np.stack([mu_t.numpy(), *(g.numpy() for g in g_t)], axis=1)
    assert np.isfinite(A).all() and np.isfinite(B).all()
    tol = 1e-9 * (np.abs(A) + np.max(np.abs(A), axis=0))
    assert (np.abs(A - B) <= tol).all(), float(np.abs(A - B).max())
    # the phi-gradient is alive (the field alone breaks the axisymmetry)
    assert float(np.abs(A[:, 3]).max()) > 1e-4


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_hand_tangents_match_jvp_of_the_geometry(field):
    """The fifteen hand-written tangents against torch.func.jvp of the
    geometry (medium.b_vec, mlat_3d, mlon_3d) along r, theta and phi, at
    1e-12 of each tangent's scale; the values are those functions' own,
    bit for bit."""
    _, te = _envs(ps_mlt=True, **FIELDS[field])
    tt = tuple(map(torch.tensor, _points(4)))

    def geom(r, th, ph):
        return (*medium.b_vec(r, th, ph, te), medium.mlat_3d(r, th, ph, te),
                medium.mlon_3d(r, th, ph, te))

    vals, *tans = fused.field_geometry(*tt, te)
    for g, w in zip(vals, geom(*tt)):
        assert torch.equal(g, w)
    one, zero = torch.ones_like(tt[0]), torch.zeros_like(tt[0])
    for x, hand, seed in zip("r theta phi".split(), tans,
                             ((one, zero, zero), (zero, one, zero),
                              (zero, zero, one))):
        _, jvp = torch.func.jvp(geom, tt, seed)
        for what, h, w in zip(GEOM, hand, jvp):
            if float(w.abs().max()) == 0.0:     # mlat, mlon along r
                assert float(h.abs().max()) == 0.0
            else:
                _close(h.numpy(), w.numpy(), 1e-12, f"d{what}/d{x}")


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_geometry_matches_jax_linearize_at_the_clips(field):
    """Where a clip is active its tangent is 0, as jax.linearize has it:
    on the geographic axis (sin theta below B_phi's 1e-12 floor, and just
    above it) and within 1e-6 rad of the magnetic pole, where 1/cos(mlat)
    and 1/(x^2 + y^2) are large but finite. Values and tangents at 1e-5
    of the JAX package's (a tangent of the other convention would differ
    by its whole size; the rest is cancellation: B_phi's theta-tangent on
    the axis and mlon's near the pole subtract terms 1e6-1e9 times the
    result), everything finite; mu and its partials finite there too."""
    je, te = _envs(ps_mlt=True, **FIELDS[field])
    mx, my, mz = dipole.moment_unit(te.b_tilt, te.b_tilt_phi)
    th_pole = math.acos(-mz) + 1e-6          # magnetic north is -m
    ph_pole = math.atan2(-my, -mx)
    th = np.array([1e-13, 1e-9, np.pi - 1e-9, th_pole, th_pole - 2e-6])
    ph = np.array([0.3, -2.0, 1.0, ph_pole, ph_pole])
    r = np.array([1.5, 2.0, 3.0, 1.2, 2.5])
    tt = tuple(map(torch.tensor, (r, th, ph)))

    def j_geom(r_, th_, ph_):
        return (*j_medium.b_vec(r_, th_, ph_, je),
                j_medium.mlat_3d(r_, th_, ph_, je),
                j_medium.mlon_3d(r_, th_, ph_, je))

    vals, *tans = fused.field_geometry(*tt, te)
    for i in range(r.size):
        prim, lin = jax.linearize(j_geom, r[i], th[i], ph[i])
        want = [prim, lin(1.0, 0.0, 0.0), lin(0.0, 1.0, 0.0),
                lin(0.0, 0.0, 1.0)]
        # a tangent that vanishes by symmetry is rounding noise: absolute
        # floor at 1e-9 of the quantity's largest tangent at the point
        floor = 1e-9 * np.abs(np.array(want[1:], np.float64)).max(axis=0)
        for which, hand, w in zip(("", "/dr", "/dtheta", "/dphi"),
                                  [vals, *tans], want):
            for what, h, ww, atol in zip(GEOM, hand, w, floor):
                assert np.isfinite(float(h[i])), (i, what, which)
                np.testing.assert_allclose(
                    float(h[i]), float(ww), rtol=1e-5, atol=atol,
                    err_msg=f"point {i} {what}{which}")
    k = torch.ones_like(tt[0])
    mu, grads = fused.mu_and_grads_3d_general(*tt, 20.0 * k, 5.0 * k, k,
                                              2000.0 * k, te)
    assert bool(torch.isfinite(mu).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("mlt", [False, True])
def test_tilt_zero_reduces_to_the_dipole_chain(mlt):
    """tilt -> 0 through the general chain against mu_and_grads_3d at
    1e-12 of each partial's scale (the magnetic coordinates still pass
    through asin and atan2; phi within one turn, where mlon == phi)."""
    _, te0 = _envs(b_model="tilted", b_tilt=0.0, ps_mlt=mlt)
    _, td = _envs(ps_mlt=mlt)
    r, th, ph, kr, kt, kp, f = _grid(5)
    ph = np.random.default_rng(6).uniform(-3.1, 3.1, ph.size)
    tt = tuple(map(torch.tensor, (r, th, ph, kr, kt, kp, f)))
    mu_g, g_g = fused.mu_and_grads_3d_general(*tt, te0)
    mu_d, g_d = fused.mu_and_grads_3d(*tt, td)
    np.testing.assert_allclose(mu_g.numpy(), mu_d.numpy(), rtol=1e-12)
    for what, a, b in zip(PARTIALS, g_g, g_d):
        if float(b.abs().max()) == 0.0:      # dmu/dphi, axisymmetric
            assert float(a.abs().max()) <= 1e-12 * float(mu_d.abs().max())
        else:
            _close(a.numpy(), b.numpy(), 1e-12, what)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_rhs_3d_over_the_field_matches_jax(field):
    """rhs_3d at 1e-11 of each component's scale, and the field turns
    d mu/d phi on (drho_phi/dt differs from the centered dipole's)."""
    je, te = _envs(ps_mlt=True, **FIELDS[field])
    pts = _grid(7)
    T = np.random.default_rng(8).uniform(0.0, 3.0, pts[0].size)
    u = np.stack([*pts[:6], T], axis=1)
    got = rhs.rhs_3d(torch.tensor(u), torch.tensor(pts[6]), te)
    want = jax.vmap(lambda uu, ff: j_rhs.rhs_3d(uu, ff, je))(
        jnp.asarray(u), jnp.asarray(pts[6]))
    for j in range(7):
        _close(got[:, j].numpy(), np.asarray(want)[:, j], 1e-11,
               f"du[{j}]/dt")
    axi = rhs.rhs_3d(torch.tensor(u), torch.tensor(pts[6]),
                     medium.make_env(b0=B0, ps_mlt=True))
    assert float((got[:, 5] - axi[:, 5]).abs().max()) > 0.0


# ---- the C++ oracle (tests/test_native.py:214-251, same sweep and
# tolerance) over the port's rhs_3d ---------------------------------------

@pytest.mark.parametrize("kw,seed", [
    (dict(b_model="tilted", b_tilt=0.2007, b_tilt_phi=1.0), 11),
    (dict(b_model="igrf"), 12),
], ids=["tilted", "igrf"])
def test_native_oracle_rhs_3d_parity(kw, seed):
    """The independent C++ finite-difference chain through its own tilted
    field / Schmidt harmonics against the port's fused rhs_3d: worst
    relative component error under 5e-5 over random states launched on
    the dispersion surface."""
    from raytrace_tpu import native

    je = j_medium.make_env(**kw)
    te = env_from_numpy(je._asdict())
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(10):
        r = rng.uniform(1.5, 5.5)
        th = rng.uniform(0.7, 2.1)
        ph = rng.uniform(-3.0, 3.0)
        fq = rng.uniform(800.0, 4000.0)
        one = torch.ones(1, dtype=torch.float64)
        rho = dispersion.consistent_rho_3d(
            r * one, th * one, ph * one, (one, one, 0.2 * one), fq * one, te)
        u = np.array([r, th, ph, *(float(x) for x in rho), 0.0])
        du_n = native.rhs_3d(u, fq, je)
        du_t = rhs.rhs_3d(torch.tensor(u)[None], fq * one, te)[0].numpy()
        rel = np.abs(du_n - du_t) / np.maximum(np.abs(du_t), 1e-10)
        worst = max(worst, float(rel.max()))
    assert worst < 5e-5, worst


# ---- mirrors of tests/test_igrf.py against the port ---------------------

R0 = (RE + 1.0e6) / RE


def _rand_points(n, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(x) for x in (
        rng.uniform(1.2, 6.0, n), rng.uniform(0.3, 2.8, n),
        rng.uniform(-np.pi, np.pi, n)))


def test_igrf_equals_minus_grad_potential():
    coeffs = dipole.IGRF13_2020
    r, th, ph = _rand_points(40)
    dv = torch.func.grad(
        lambda a, b, c: dipole.igrf_potential(a, b, c, coeffs).sum(),
        argnums=(0, 1, 2))(r, th, ph)
    br, bt, bp = dipole.b_vec_igrf(r, th, ph, coeffs)
    scale = torch.maximum(torch.maximum(br.abs(), bt.abs()), bp.abs())
    assert bool(((br + dv[0]).abs() <= 1e-9 * scale).all())
    assert bool(((bt + dv[1] / r).abs() <= 1e-9 * scale).all())
    assert bool(((bp + dv[2] / (r * torch.sin(th))).abs()
                 <= 1e-9 * scale).all())


def test_igrf_axial_reduction():
    """Only g10 set: the centered axial dipole."""
    coeffs = (-B0 * 1.0e9,) + (0.0,) * 14
    pts = _rand_points(25, seed=5)
    for g, w in zip(dipole.b_vec_igrf(*pts, coeffs),
                    dipole.b_vec_colat(*pts, B0)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-20)


def test_igrf_degree1_is_tilted_dipole():
    """Only degree-1 terms: the tilted centered dipole with the moment
    igrf_dipole extracts."""
    coeffs = dipole.IGRF13_2020[:3] + (0.0,) * 12
    b0, tilt, phi0 = dipole.igrf_dipole(coeffs)
    assert b0 == pytest.approx(2.979e-5, rel=2e-3)   # ~29790 nT epoch 2020
    assert np.degrees(tilt) == pytest.approx(9.41, abs=0.3)
    pts = _rand_points(25, seed=7)
    for g, w in zip(dipole.b_vec_igrf(*pts, coeffs),
                    dipole.b_vec_tilted(*pts, b0, tilt, phi0)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-14)


def test_igrf_surface_magnitude_sane():
    """Full IGRF-13 truncation: surface field between ~22 and ~67 uT."""
    th = np.linspace(0.05, np.pi - 0.05, 40)
    ph = np.linspace(-np.pi, np.pi, 40)
    tt, pp = np.meshgrid(th, ph)
    br, bt, bp = dipole.b_vec_igrf(
        torch.ones(tt.size, dtype=torch.float64), torch.tensor(tt.ravel()),
        torch.tensor(pp.ravel()), dipole.IGRF13_2020)
    bm = torch.sqrt(br * br + bt * bt + bp * bp)
    assert 1.8e-5 < float(bm.min()) < 3.0e-5
    assert 5.0e-5 < float(bm.max()) < 7.5e-5


def test_igrf_env_and_mu():
    env = medium.make_env(b_model="igrf")
    assert env.b_model == "igrf" and len(env.igrf_coeffs) == 15
    r, th, ph = _rand_points(10, seed=9)
    one = torch.ones_like(r)
    rho = dispersion.consistent_rho_3d(r, th, ph, (one, one, 0.0 * one),
                                       1000.0 * one, env)
    mu = dispersion.mu_3d(r, th, ph, *rho, 1000.0 * one, env)
    assert bool(torch.isfinite(mu).all()) and bool((mu > 1.0).all())


def test_igrf_rhs_and_short_trace():
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import SolverConfig, trace

    env = medium.make_env(b_model="igrf")
    one = torch.ones(1, dtype=torch.float64)
    th0 = np.pi / 4
    rho0 = dispersion.consistent_rho_3d(
        R0 * one, th0 * one, 0.3 * one, (one, one, 0.0 * one), 1000.0 * one,
        env)
    u0 = torch.tensor([[R0, th0, 0.3, *(float(x) for x in rho0), 0.0]],
                      dtype=torch.float64)
    du = rhs.rhs_3d(u0, 1000.0 * one, env)
    assert bool(torch.isfinite(du).all())
    res = trace(env, u0, 1000.0 * one, frame="3d",
                cfg=SolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4),
                spec=StopSpec(r_floor=1.0, t_max=3.0), max_steps=400)
    assert bool(torch.isfinite(res.u).all())
    assert int(res.n_accept[0]) > 10
    # a genuinely non-axisymmetric medium: dmu/dphi != 0
    _, g = gradients.mu_grads_3d(
        2.5 * one, np.pi / 3 * one, 0.7 * one, *rho0, 1000.0 * one, env,
        grad_mode=gradients.AUTODIFF)
    assert abs(float(g[2])) > 0.0


# ---- mirrors of tests/test_models.py::test_tilted_* ----------------------

def test_tilted_dipole_reduces_to_centered():
    """tilt = 0 reproduces b_vec_colat everywhere."""
    rng = np.random.default_rng(3)
    r = torch.tensor(rng.uniform(1.0, 6.0, 30))
    th = torch.tensor(rng.uniform(0.1, np.pi - 0.1, 30))
    ph = torch.tensor(rng.uniform(-np.pi, np.pi, 30))
    for a, b in zip(dipole.b_vec_colat(r, th, ph, B0),
                    dipole.b_vec_tilted(r, th, ph, B0, 0.0)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12,
                                   atol=1e-30)


def test_tilted_dipole_rotation_consistency():
    """|B| of the tilted dipole at a point equals the centered |B| at the
    same magnetic latitude, and the magnetic-latitude helper agrees with
    the geometry."""
    rng = np.random.default_rng(5)
    r = torch.tensor(rng.uniform(1.0, 6.0, 30))
    th = torch.tensor(rng.uniform(0.1, np.pi - 0.1, 30))
    ph = torch.tensor(rng.uniform(-np.pi, np.pi, 30))
    br, bt, bp = dipole.b_vec_tilted(r, th, ph, B0, TILT, PHI0)
    bmag = torch.sqrt(br * br + bt * bt + bp * bp)
    slat = dipole.mlat_sin_tilted(th, ph, TILT, PHI0)
    lat_m = torch.asin(torch.clamp(slat, -1.0, 1.0))
    np.testing.assert_allclose(
        bmag.numpy(), dipole.b_mag_lat(r, lat_m, B0).numpy(), rtol=1e-10)
    assert torch.equal(lat_m, dipole.magnetic_coords(th, ph, TILT, PHI0)[0])


def test_tilted_medium_guards_and_dispatch():
    env = medium.make_env(b_model="tilted", b_tilt=0.2)
    assert env.b_model == "tilted"
    x = torch.tensor([2.0], dtype=torch.float64)
    with pytest.raises(ValueError):
        medium.b_mag(x, 0.3 * x, env)
    a = medium.b_vec(x, 0.5 * x, 0.25 * x, env)
    b = dipole.b_vec_tilted(x, 0.5 * x, 0.25 * x, env.b0, env.b_tilt,
                            env.b_tilt_phi)
    for g, w in zip(a, b):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-14)
    with pytest.raises(ValueError):
        medium.make_env(b_model="t96")
