"""Port parity: the medium of raytrace_tpu_torch (models/) against the JAX
package, float64 on the CPU, inputs from numpy.random.default_rng."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import dipole as j_dipole
from raytrace_tpu.models import ionosphere as j_iono
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.models import plasmasphere as j_ps
from raytrace_tpu_torch.interop import env_from_numpy
from raytrace_tpu_torch.models import dipole, ionosphere, medium, plasmasphere

RTOL = 1e-13


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _points(seed, n=256):
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 6.0, n), rng.uniform(-1.2, 1.2, n)


# (JAX-package make_env kwargs) for media inside the port's feature set
MEDIA = {
    "lat": dict(b0=3.0696381e-5),
    "iono_only": dict(b0=3.0696381e-5, plasmasphere_on=False),
    "de": dict(de_correction=True),
    "storm": dict(kp_max=5.0, day=100.0, rbar=150.0, mlt=10.0),
}


def test_make_env_lat_fields():
    je, te = j_medium.make_env_lat(), medium.make_env_lat()
    assert je._fields == te._fields
    for name in je._fields:
        a, b = getattr(je, name), getattr(te, name)
        if isinstance(a, (str, tuple)):
            assert a == b, name
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("medium_name", sorted(MEDIA))
def test_ne_total_and_b_mag(medium_name):
    kw = MEDIA[medium_name]
    je, te = j_medium.make_env(**kw), medium.make_env(**kw)
    assert env_from_numpy(je._asdict()) == te
    r, lat = _points(1)
    ne_j = np.asarray(j_medium.ne_total_m3(jnp.asarray(r), jnp.asarray(lat), je))
    ne_t = medium.ne_total_m3(torch.tensor(r), torch.tensor(lat), te).numpy()
    np.testing.assert_allclose(ne_t, ne_j, rtol=RTOL)
    b_j = np.asarray(j_medium.b_mag(jnp.asarray(r), jnp.asarray(lat), je))
    b_t = medium.b_mag(torch.tensor(r), torch.tensor(lat), te).numpy()
    np.testing.assert_allclose(b_t, b_j, rtol=RTOL)


def test_dipole_and_ionosphere():
    r, lat = _points(2)
    rt, lt = torch.tensor(r), torch.tensor(lat)
    rj, lj = jnp.asarray(r), jnp.asarray(lat)
    for fn_t, fn_j in (
        (lambda: dipole.b_mag_lat(rt, lt, 3.12e-5),
         lambda: j_dipole.b_mag_lat(rj, lj, 3.12e-5)),
        (lambda: dipole.dip_angle_lat(lt), lambda: j_dipole.dip_angle_lat(lj)),
        (lambda: dipole.l_shell(rt, lt), lambda: j_dipole.l_shell(rj, lj)),
        (lambda: ionosphere.ne_iono_cm3(rt, *ionosphere.TRACED_FIT),
         lambda: j_iono.ne_iono_cm3(rj, *j_iono.TRACED_FIT)),
    ):
        np.testing.assert_allclose(fn_t().numpy(), np.asarray(fn_j()),
                                   rtol=RTOL)


@pytest.mark.parametrize("kp,day,rbar,mlt", [
    (3.0, 0.0, 90.0, 2.0), (1.0, 200.0, 60.0, 20.0), (6.0, 45.0, 180.0, 0.0),
])
def test_plasmapause_presolve(kp, day, rbar, mlt):
    assert plasmasphere.season_coeff(day, rbar) == j_ps.season_coeff(day, rbar)
    assert plasmasphere.lppi_from_kp(kp) == j_ps.lppi_from_kp(kp)
    lppi = plasmasphere.lppi_from_kp(kp)
    assert plasmasphere.initialize_plasmasphere(lppi, day, rbar, mlt) == (
        j_ps.initialize_plasmasphere(lppi, day, rbar, mlt)
    )


def test_plasmasphere_density_and_de_factor():
    env = medium.make_env_lat()
    rng = np.random.default_rng(3)
    L = rng.uniform(1.0, 8.0, 256)
    args = (env.lppi, env.lppo, env.ne_lppi, env.ps_season, env.ps_trough)
    np.testing.assert_allclose(
        plasmasphere.ne_plasma_cm3(torch.tensor(L), *args).numpy(),
        np.asarray(j_ps.ne_plasma_cm3(jnp.asarray(L), *args)), rtol=RTOL,
    )
    r = rng.uniform(1.0, 6.0, 256)
    np.testing.assert_allclose(
        plasmasphere.diffusive_equilibrium_factor(torch.tensor(r)).numpy(),
        np.asarray(j_ps.diffusive_equilibrium_factor(jnp.asarray(r))),
        rtol=RTOL,
    )


# the multi-ion composition, alone and under the other media and the
# fields: make_env builds it as the JAX package does, and the density takes
# a fractional plasmasphere weight (make_env gives 0 or 1; an env's
# _replace any other) as the JAX package does, with the longitude of the
# MLT-resolved medium where it has one
@pytest.mark.parametrize("kw", [
    dict(eta_o=0.1), dict(b_model="igrf", eta_he=0.2),
    dict(ps_model="gcpm", eta_he=0.1),
    dict(duct_amp=0.5, b_model="tilted", b_tilt=0.2, eta_he=0.1),
    dict(eta_he=0.1), dict(ps_refill=0.5, eta_o=0.02),
    dict(ps_mlt=True, b_model="tilted", b_tilt=0.2, b_tilt_phi=0.5,
         eta_o=0.1),
    dict(eta_he=0.05, eta_o=0.05),
])
def test_fractional_plasmasphere_weight_matches_jax(kw):
    env = medium.make_env(**kw)
    je = j_medium.make_env(**kw)
    assert env == env_from_numpy(je._asdict())
    r, lat = _points(9)
    phi = np.random.default_rng(10).uniform(-3.0, 3.0, r.size)
    for w in (0.5, 1.0):
        got = medium.ne_total_m3(torch.tensor(r), torch.tensor(lat),
                                 env._replace(ps_weight=w),
                                 phi=torch.tensor(phi))
        want = j_medium.ne_total_m3(jnp.asarray(r), jnp.asarray(lat),
                                    je._replace(ps_weight=w),
                                    phi=jnp.asarray(phi))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL)
        if w == 0.5:
            half = got
    assert bool((half < got).all())     # half the plasmasphere


# ---- the colatitude magnitude and the signed mu^2 (tests/test_models.py:
# 28, 38 and raytrace_tpu/ops/dispersion.py::mu2_signed) -----------------

def test_b_mag_colat_matches_jax_and_the_lat_form():
    b0 = 3.0696381e-5
    rng = np.random.default_rng(21)
    r = rng.uniform(1.0, 6.0, 64)
    theta = rng.uniform(0.05, np.pi - 0.05, 64)
    got = dipole.b_mag_colat(torch.tensor(r), torch.tensor(theta), b0)
    want = np.asarray(j_dipole.b_mag_colat(jnp.asarray(r), jnp.asarray(theta),
                                           b0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0.0)
    # test_dipole_lat_colat_consistency and the vector's magnitude
    lat = torch.tensor(np.pi / 2 - theta)
    np.testing.assert_allclose(
        got.numpy(), dipole.b_mag_lat(torch.tensor(r), lat, b0).numpy(),
        rtol=1e-12)
    br, bt, bp = dipole.b_vec_colat(torch.tensor(r), torch.tensor(theta),
                                    torch.zeros(64), b0)
    np.testing.assert_allclose(torch.sqrt(br**2 + bt**2 + bp**2).numpy(),
                               got.numpy(), rtol=1e-12)


@pytest.mark.parametrize("root", [1.0, -1.0], ids=["whistler", "emic"])
def test_mu2_signed_matches_jax(root):
    from raytrace_tpu.ops import dispersion as j_disp
    from raytrace_tpu_torch.ops import dispersion

    rng = np.random.default_rng(22 if root > 0 else 23)
    f = rng.uniform(0.5, 8.0, 96) * (1e3 if root > 0 else 1e-1)
    bmag = rng.uniform(2e-7, 2e-5, 96)
    ne = rng.uniform(1e7, 5e9, 96)
    psi = rng.uniform(-1.4, 1.4, 96)
    kw = dict(eta_he=0.1, eta_o=0.05)
    rlp = dispersion.stix_rlp(torch.tensor(ne), torch.tensor(bmag),
                              torch.tensor(f), **kw)
    got = dispersion.mu2_signed(*rlp, torch.tensor(psi), root)
    jrlp = j_disp.stix_rlp(jnp.asarray(ne), jnp.asarray(bmag), jnp.asarray(f),
                           **kw)
    want = np.asarray(j_disp.mu2_signed(*jrlp, jnp.asarray(psi), root))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0.0)
