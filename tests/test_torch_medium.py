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


@pytest.mark.parametrize("kw", [
    dict(ps_smooth=0.1), dict(iono_mlt=True), dict(ps_model="gcpm"),
    dict(duct_amp=0.5), dict(eta_he=0.1), dict(ps_refill=0.5),
    dict(ps_mlt=True), dict(b_model="tilted"),
])
def test_unported_medium_gates_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        medium.make_env(**kw)
    # an env carried over from the JAX package is refused where it is used
    env = env_from_numpy(j_medium.make_env(**kw)._asdict())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        medium.ne_total_m3(torch.ones(2), torch.zeros(2), env)
