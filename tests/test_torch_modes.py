"""Port parity for the remaining modes of the ray path, float64 on the
CPU, against the JAX package: one attempt of each stepper that runs as
torch ops (heun2, ros2, ros2x, ros4x; the Pallas kernel runs none of
them), the storm-time env sequence (models/storm.py) and the day/night
ionosphere density (ionosphere.ne_iono_mlt_cm3). The rounds tracer's
ros2x pool and continue_until_done are held in
tests/test_torch_modes_stiff.py and
tests/test_torch_modes_continue.py. Inputs come from numpy seeds; each
comparison states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.integrate import steppers as j_steppers
from raytrace_tpu.models import ionosphere as j_ionosphere
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.models import storm as j_storm
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate import solve, steppers
from raytrace_tpu_torch.models import ionosphere, make_env, storm
from raytrace_tpu_torch.ops import rhs

RTOL, ATOL = 1e-6, 1e-10
B0_2D = 3.0696381e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _states(frame, seed, n=48):
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.05, 4.0, n)
    if frame == "3d":
        u = np.stack([r, rng.uniform(0.4, 2.7, n), rng.uniform(-3, 3, n),
                      *rng.normal(scale=20.0, size=(3, n)),
                      rng.uniform(0.0, 2.0, n)], 1)
    else:
        u = np.stack([r, rng.uniform(-1.0, 1.0, n),
                      rng.uniform(-0.5, 0.5, n), rng.uniform(0.0, 2.0, n)],
                     1)
    return u, rng.uniform(500.0, 8000.0, n), rng.uniform(1e-3, 3e-2, n)


@pytest.mark.parametrize("name,frame", [
    ("heun21_step", "2d_lat"), ("ros2_step", "2d_lat"),
    ("ros2x_step", "2d_lat"), ("ros4x_step", "2d_lat"),
    ("ros2x_step", "3d"),
])
def test_one_attempt_matches_jax(name, frame):
    """One attempt of each stepper on 48 random states (the 3D frame's
    7-state Rosenbrock solve for ros2x): u_new, k_end and the increment at
    rtol 1e-13 of each component's largest magnitude; the error norm,
    which cancels to the size of the local error, within 1e-13 of the
    increments it is formed from (rms of |incr| / scale), or of itself."""
    b0 = 3.12e-5 if frame == "3d" else B0_2D
    je, te = j_make_env(b0=b0), make_env(b0=b0)
    jfn = j_rhs.rhs_3d if frame == "3d" else j_rhs.rhs_2d_lat
    u, f, dt = _states(frame, 80)
    k = np.asarray(jax.vmap(lambda uu, ff: jfn(uu, ff, je))(
        jnp.asarray(u), jnp.asarray(f)))
    ref = jax.vmap(lambda uu, kk, h, ff: getattr(j_steppers, name)(
        lambda x: jfn(x, ff, je), uu, kk, h, RTOL, ATOL
    ))(*map(jnp.asarray, (u, k, dt, f)))
    ft = torch.tensor(f)
    rhs_fn = rhs.frame_rhs(frame, te)[0]
    kw = ({} if name == "heun21_step"
          else {"jac_fn": solve._jacobian_fn(rhs_fn, ft)})
    got = getattr(steppers, name)(
        lambda x: rhs_fn(x, ft), torch.tensor(u), torch.tensor(k),
        torch.tensor(dt), RTOL, ATOL, **kw)
    for field in ("u_new", "k_end", "incr"):
        want = np.asarray(getattr(ref, field))
        scale = np.abs(want).max(axis=0)
        err = np.abs(getattr(got, field).numpy() - want) / scale
        assert float(err.max()) <= 1e-13, field
    u_new = np.asarray(ref.u_new)
    scale = ATOL + RTOL * np.maximum(np.abs(u), np.abs(u_new))
    cond = np.sqrt(np.mean((np.asarray(ref.incr) / scale) ** 2, axis=1))
    np.testing.assert_array_less(
        np.abs(got.err.numpy() - np.asarray(ref.err)),
        1e-13 * np.maximum(cond, np.asarray(ref.err)))


def test_heun2_rejects_a_non_finite_end():
    """heun2's estimate does not contain the end-derivative, so a step
    that lands on a non-finite one is rejected outright (err = inf)."""
    u = torch.ones(2, 4, dtype=torch.float64)
    k1 = torch.zeros_like(u)

    def fn(x):
        out = torch.zeros_like(x)
        out[1, 0] = float("nan") if bool((x[1] != 1.0).any()) else 0.0
        return out + 1e-3

    out = steppers.heun21_step(fn, u, k1, torch.full((2,), 0.1,
                                                     dtype=torch.float64),
                               RTOL, ATOL)
    assert bool(torch.isfinite(out.err[0])) and bool(torch.isinf(out.err[1]))


def _storm_kp():
    hours = np.arange(0.0, 72.1, 3.0)
    kp = np.full_like(hours, 2.0)
    kp[(hours >= 24.0) & (hours < 30.0)] = 7.0
    kp[(hours >= 30.0) & (hours < 36.0)] = 4.0
    return hours, kp


def test_storm_sequence_matches_jax():
    """kp_max_24h, plasmapause_history and refill_history equal the JAX
    package's to 1e-15, and storm_sequence gives the same envs (every
    field, with refill) and plasmapause history."""
    hours, kp = _storm_kp()
    t = np.arange(0.0, 72.0, 1.5)
    np.testing.assert_array_equal(storm.kp_max_24h(t, hours, kp),
                                  j_storm.kp_max_24h(t, hours, kp))
    for fn in ("plasmapause_history", "refill_history"):
        np.testing.assert_allclose(getattr(storm, fn)(t, hours, kp),
                                   getattr(j_storm, fn)(t, hours, kp),
                                   rtol=1e-15, err_msg=fn)
    epochs = [6.0, 27.0, 40.0, 66.0]
    envs, lpp = storm.storm_sequence(epochs, hours, kp, refill=True,
                                     b0=B0_2D, mlt=3.0)
    j_envs, j_lpp = j_storm.storm_sequence(epochs, hours, kp, refill=True,
                                           b0=B0_2D, mlt=3.0)
    np.testing.assert_allclose(lpp, j_lpp, rtol=1e-15)
    for te, je in zip(envs, j_envs):
        for name, v in je._asdict().items():
            got = getattr(te, name)
            if isinstance(v, str):
                assert got == v, name
            else:
                np.testing.assert_allclose(np.asarray(got, np.float64),
                                           np.asarray(v, np.float64),
                                           rtol=1e-15, err_msg=name)
    assert envs[1].lppi < envs[0].lppi


def test_ne_iono_mlt_matches_jax():
    """The day/night ionosphere at rtol 1e-14, for an MLT scalar and an
    MLT tensor: the day fit at noon, the night fit at midnight."""
    rng = np.random.default_rng(81)
    r = rng.uniform(1.0, 3.0, 64)
    mlt = rng.uniform(0.0, 24.0, 64)
    want = np.asarray(j_ionosphere.ne_iono_mlt_cm3(r, mlt))
    got = ionosphere.ne_iono_mlt_cm3(torch.tensor(r), torch.tensor(mlt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    for m, fit in ((12.0, ionosphere.IRI_DAYSIDE_FIT),
                   (0.0, ionosphere.IRI_NIGHTSIDE_FIT)):
        got = ionosphere.ne_iono_mlt_cm3(torch.tensor(r), m)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(j_ionosphere.ne_iono_mlt_cm3(r, m)),
            rtol=1e-14)
        np.testing.assert_allclose(
            got.numpy(), ionosphere.ne_iono_cm3(torch.tensor(r),
                                                *fit).numpy(), rtol=1e-14)
