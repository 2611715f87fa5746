"""Port parity: one attempt of each ported stepper, the event helpers and
one _step_one step, raytrace_tpu_torch against the JAX package, float64 on
the CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.integrate import events as j_events
from raytrace_tpu.integrate import solve as j_solve
from raytrace_tpu.integrate import steppers as j_steppers
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate import events, solve, steppers
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, solver_config_from, stop_spec_from,
)
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import rhs

RTOL, ATOL = 1e-6, 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _states(seed, n=64):
    rng = np.random.default_rng(seed)
    u = np.stack([rng.uniform(1.05, 4.0, n), rng.uniform(-1.0, 1.0, n),
                  rng.uniform(-0.5, 0.5, n), rng.uniform(0.0, 2.0, n)], 1)
    return u, rng.uniform(500.0, 8000.0, n), rng.uniform(1e-3, 5e-2, n)


@pytest.mark.parametrize("name", ["bs3_step", "dopri5_step", "ros3pr_step"])
def test_one_attempt_matches_jax(name):
    """u_new, k_end and the increment agree to rtol 1e-12. The error norm
    is a sum of stage terms that cancel to the size of the local error, so
    it is held to 1e-12 of the increments it is formed from (rms of
    |incr| / scale) -- its conditioning, not its own size, sets what two
    math libraries can agree on."""
    je, te = j_medium.make_env_lat(), medium.make_env_lat()
    u, f, dt = _states(20)
    k = np.asarray(jax.vmap(lambda uu, ff: j_rhs.rhs_2d_lat(uu, ff, je))(
        jnp.asarray(u), jnp.asarray(f)))
    ref = jax.vmap(lambda uu, kk, h, ff: getattr(j_steppers, name)(
        lambda x: j_rhs.rhs_2d_lat(x, ff, je), uu, kk, h, RTOL, ATOL
    ))(jnp.asarray(u), jnp.asarray(k), jnp.asarray(dt), jnp.asarray(f))
    ft = torch.tensor(f)
    rhs_fn = lambda x, ff: rhs.rhs_2d_lat(x, ff, te)  # noqa: E731
    kw = ({"jac_fn": solve._jacobian_fn(rhs_fn, ft)}
          if name == "ros3pr_step" else {})
    got = getattr(steppers, name)(
        lambda x: rhs_fn(x, ft), torch.tensor(u), torch.tensor(k),
        torch.tensor(dt), RTOL, ATOL, **kw)
    for field in ("u_new", "k_end", "incr"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-12, err_msg=field)
    u_new = np.asarray(ref.u_new)
    scale = ATOL + RTOL * np.maximum(np.abs(u), np.abs(u_new))
    cond = np.sqrt(np.mean((np.asarray(ref.incr) / scale) ** 2, axis=1))
    np.testing.assert_array_less(
        np.abs(got.err.numpy() - np.asarray(ref.err)),
        1e-12 * np.maximum(cond, np.asarray(ref.err)),
    )


def test_event_helpers_match_jax():
    rng = np.random.default_rng(21)
    n = 128
    u0 = np.stack([rng.uniform(0.98, 1.1, n), rng.uniform(-0.2, 0.2, n),
                   rng.uniform(-1, 1, n), rng.uniform(-0.1, 3.0, n)], 1)
    u1 = u0 + rng.normal(scale=0.05, size=u0.shape)
    u1[::17, 2] = np.nan
    t1 = rng.uniform(0.0, 10.0, n)
    spec = dict(r_floor=1.0, r_ceil=1.08, t_max=8.0, group_time_max=2.9,
                stop_at_equator=1.0, stop_retrograde=1.0)
    got = events.classify_step(torch.tensor(u0), torch.tensor(u1),
                               torch.tensor(t1), events.StopSpec(**spec))
    ref = jax.vmap(lambda a, b, t: j_events.classify_step(
        a, b, t, j_events.StopSpec(**spec)))(
        jnp.asarray(u0), jnp.asarray(u1), jnp.asarray(t1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(set(got.tolist())) >= 5   # the priority order is exercised

    du0, du1 = rng.normal(size=u0.shape), rng.normal(size=u0.shape)
    u1 = u0 + 0.01 * rng.normal(size=u0.shape)
    u0[:, 0], u1[:, 0] = 1.0 + 1e-3, 1.0 - 1e-3
    tau, dt = rng.uniform(0, 1, n), rng.uniform(1e-3, 1e-1, n)
    targs = [torch.tensor(x) for x in (u0, du0, u1, du1, dt)]
    jargs = [jnp.asarray(x) for x in (u0, du0, u1, du1, dt)]
    np.testing.assert_allclose(
        events.hermite_interp(torch.tensor(tau), *targs).numpy(),
        np.asarray(jax.vmap(j_events.hermite_interp)(jnp.asarray(tau),
                                                     *jargs)),
        rtol=1e-12)
    tau_t, u_t = events.refine_crossing(lambda uu: uu[..., 0] - 1.0, *targs)
    tau_j, u_j = jax.vmap(lambda *a: j_events.refine_crossing(
        lambda uu: uu[0] - 1.0, *a))(*jargs)
    np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_j), rtol=1e-12)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-12)


@pytest.mark.parametrize("stepper", ["bs3", "dopri5", "ros3pr"])
def test_step_one_matches_jax(stepper):
    """One _step_one from the same mid-flight carry, every field."""
    je, te = j_medium.make_env_lat(), medium.make_env_lat()
    u, f, dt = _states(22, n=32)
    cfg_j = j_solve.SolverConfig(rtol=RTOL, atol=ATOL, dt0=1e-4)
    spec_j = j_events.StopSpec(r_floor=1.0, t_max=50.0)
    rhs_j = lambda uu, ff: j_rhs.rhs_2d_lat(uu, ff, je)  # noqa: E731
    c0 = jax.vmap(lambda uu, ff: j_solve.init_carry(rhs_j, uu, ff, cfg_j))(
        jnp.asarray(u), jnp.asarray(f))
    rng = np.random.default_rng(23)
    c0 = c0._replace(
        dt=jnp.asarray(dt), t=jnp.asarray(rng.uniform(0.0, 49.99, 32)),
        caution=jnp.asarray(rng.integers(0, 20, 32), jnp.int32),
        rejected=jnp.asarray(rng.integers(0, 2, 32), jnp.int32),
        errold=jnp.asarray(rng.uniform(1e-4, 1.0, 32)),
    )
    ref = jax.vmap(partial(j_solve._step_one, rhs_j, cfg=cfg_j, spec=spec_j,
                           group_idx=3, adaptive=True, stepper=stepper))(
        c0, jnp.asarray(f))
    cfg, spec = solver_config_from(cfg_j), stop_spec_from(spec_j)
    carry = carry_from_numpy(
        {k: np.asarray(v) for k, v in c0._asdict().items()},
        device="cpu", dtype=torch.float64)
    got = carry_to_numpy(solve._step_one(
        lambda uu, ff: rhs.rhs_2d_lat(uu, ff, te), carry, torch.tensor(f),
        cfg, spec, stepper=stepper))
    same_dt = np.asarray(ref.dt) == got["dt"]
    for name in ref._fields:
        if name in ("errold", "dt"):
            # the controller's output follows the error norm (see
            # test_one_attempt_matches_jax); where it is not clamped it
            # carries the norm's conditioning
            continue
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-12 if name == "u_lo"
                                   else 0.0, err_msg=name)
    assert same_dt.mean() > 0.5
