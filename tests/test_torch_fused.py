"""Port parity: dispersion, the fused gradient chain and the Haselgrove RHS
of raytrace_tpu_torch against the JAX package, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import dispersion as j_disp
from raytrace_tpu.ops import fused as j_fused
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import dispersion, fused, gradients, rhs

OUTPUTS = ("mu", "dmu/dr", "dmu/dlat", "dmu/dpsi", "dmu/df")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _points(seed, n=512):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.05, 6.0, n), rng.uniform(-1.1, 1.1, n),
            rng.uniform(-0.5, 0.5, n), rng.uniform(500.0, 8000.0, n))


def _envs(name):
    kw = {"lat": {}, "de": dict(de_correction=True),
          "iono_only": dict(plasmasphere_on=False)}[name]
    return (j_medium.make_env(b0=3.0696381e-5, **kw),
            medium.make_env(b0=3.0696381e-5, **kw))


@pytest.mark.parametrize("env_name", ["lat", "de", "iono_only"])
def test_mu_and_grads_2d_lat_matches_jax(env_name):
    je, te = _envs(env_name)
    pts = _points(10)
    got = fused.mu_and_grads_2d_lat(*map(torch.tensor, pts), te)
    ref = j_fused.mu_and_grads_2d_lat(*map(jnp.asarray, pts), je)
    for name, a, b in zip(OUTPUTS, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11,
                                   err_msg=name)


@pytest.mark.parametrize("root", [1.0, -1.0])
def test_rhs_2d_lat_matches_jax(root):
    je, te = _envs("lat")
    r, lat, chi, f = _points(11)
    T = np.random.default_rng(12).uniform(0.0, 3.0, r.size)
    u = np.stack([r, lat, chi, T], axis=1)
    got = rhs.rhs_2d_lat(torch.tensor(u), torch.tensor(f), te, root=root)
    ref = jax.vmap(lambda uu, ff: j_rhs.rhs_2d_lat(uu, ff, je, root=root))(
        jnp.asarray(u), jnp.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-11)


def test_fused_matches_own_autodiff():
    """The port's fused chain is the exact derivative of its own traced
    mu = sqrt(|mu^2|) (torch.func.grad of dispersion.mu_2d_lat)."""
    _, te = _envs("lat")
    pts = tuple(map(torch.tensor, _points(13)))
    fz = gradients.mu_grads_2d_lat(*pts, te, grad_mode=gradients.FUSED)
    ad = gradients.mu_grads_2d_lat(*pts, te, grad_mode=gradients.AUTODIFF)
    for name, a, b in zip(OUTPUTS, fz, ad):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   err_msg=name)


def test_dispersion_matches_jax():
    je, te = _envs("lat")
    r, lat, chi, f = _points(14)
    tt = [torch.tensor(x) for x in (r, lat, chi, f)]
    jj = [jnp.asarray(x) for x in (r, lat, chi, f)]
    sp_t = dispersion.psi_trig_lat(tt[1], tt[2])
    sp_j = j_disp.psi_trig_lat(jj[1], jj[2])
    for a, b in zip(sp_t, sp_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    ne_t = medium.ne_total_m3(tt[0], tt[1], te)
    bm_t = medium.b_mag(tt[0], tt[1], te)
    rlp_t = dispersion.stix_rlp(ne_t, bm_t, tt[3])
    rlp_j = j_disp.stix_rlp(jnp.asarray(ne_t.numpy()),
                            jnp.asarray(bm_t.numpy()), jj[3])
    for a, b in zip(rlp_t, rlp_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    for root in (1.0, -1.0):
        mu2_t = dispersion.mu2_signed_trig(*rlp_t, *sp_t, root)
        mu2_j = j_disp.mu2_signed_trig(
            *[jnp.asarray(x.numpy()) for x in (*rlp_t, *sp_t)], root)
        np.testing.assert_allclose(mu2_t.numpy(), np.asarray(mu2_j),
                                   rtol=1e-12)
        np.testing.assert_allclose(
            dispersion.mu_from_mu2(mu2_t).numpy(),
            np.asarray(j_disp.mu_from_mu2(mu2_j)), rtol=1e-12)
        np.testing.assert_allclose(
            dispersion.mu_2d_lat(*tt, te, root).numpy(),
            np.asarray(j_disp.mu_2d_lat(*jj, je, root)), rtol=1e-12)


def test_unported_grad_mode_raises():
    _, te = _envs("lat")
    x = torch.ones(2, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gradients.mu_grads_2d_lat(x, x * 0.5, x * 0.1, x * 1000.0, te,
                                  grad_mode="reference")
