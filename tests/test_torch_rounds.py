"""Port parity: the bucketed rounds tracer of raytrace_tpu_torch
(parallel/ensemble.py) against the JAX package's, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate.solve import RayCarry as JRayCarry
from raytrace_tpu.models import cast_env, make_env_lat as j_make_env_lat
from raytrace_tpu.parallel import ensemble as j_ensemble
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import RayCarry, SolverConfig
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.parallel import ensemble


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _random_carry(rng, dtype, B=7, n=4):
    return dict(
        u=rng.normal(size=(B, n)).astype(dtype),
        t=rng.uniform(0, 100, B).astype(dtype),
        dt=rng.uniform(1e-6, 1e-1, B).astype(dtype),
        k1=rng.normal(size=(B, n)).astype(dtype),
        errold=rng.uniform(1e-4, 10, B).astype(dtype),
        status=rng.integers(0, 8, B).astype(np.int32),
        n_accept=rng.integers(0, 1 << 23, B).astype(np.int32),
        n_reject=rng.integers(0, 1 << 23, B).astype(np.int32),
        u_prev=rng.normal(size=(B, n)).astype(dtype),
        dt_prev=rng.uniform(1e-6, 1e-1, B).astype(dtype),
        u_lo=(1e-9 * rng.normal(size=(B, n))).astype(dtype),
        rejected=rng.integers(0, 2, B).astype(np.int32),
        n_tiny=rng.integers(0, 64, B).astype(np.int32),
        caution=rng.integers(0, 61, B).astype(np.int32),
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_packed_carry_roundtrip_exact(dtype):
    """Every field survives the packed float transport bit-exactly (the
    int32 counters ride as floats below 2^24), on tensors and on the
    host copy, and the layout is the JAX package's."""
    rng = np.random.default_rng(30)
    d = _random_carry(rng, dtype)
    f = rng.uniform(500, 8000, 7).astype(dtype)
    carry = RayCarry(**{k: torch.from_numpy(v) for k, v in d.items()})
    fl = ensemble.pack_carry(carry, torch.from_numpy(f))
    assert ensemble.packed_state_dim(fl) == 4
    fl_j = np.asarray(j_ensemble.pack_carry(JRayCarry(**d), jnp.asarray(f)))
    np.testing.assert_array_equal(fl.numpy(), fl_j)
    for back, f_back in (ensemble.unpack_carry(fl, 4),
                         ensemble.unpack_carry(fl.numpy(), 4)):
        np.testing.assert_array_equal(np.asarray(f_back), f)
        for name in RayCarry._fields:
            got = getattr(back, name)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert got.dtype == d[name].dtype, name
            np.testing.assert_array_equal(got, d[name], err_msg=name)


def test_launch_grid_padding_and_buckets():
    spec = ensemble.LaunchSpec(lats=(0.5, 0.6, 0.7), chis=(0.0, 0.1),
                               freqs=(1000.0, 2000.0))
    u0, f = ensemble.build_launch(spec, np.float64)
    u0_j, f_j = j_ensemble.build_launch(j_ensemble.LaunchSpec(*spec),
                                        np.float64)
    np.testing.assert_array_equal(u0, u0_j)
    np.testing.assert_array_equal(f, f_j)
    u0p, fp, valid = ensemble.pad_batch(u0, f)
    assert u0p.shape == (16, 4) and valid.sum() == 12
    np.testing.assert_array_equal(u0p[12:], np.repeat(u0[:1], 4, axis=0))
    for n_active in (1, 8, 9, 300, 5000):
        assert ensemble._bucket_size(n_active, 4096, 256) == (
            j_ensemble._bucket_size(n_active, 4096, 256))


def _fan():
    """24 rays that land cleanly (well-conditioned trajectories)."""
    u0, f = ensemble.build_launch(ensemble.LaunchSpec(
        lats=tuple(np.linspace(0.75, 1.05, 6)), chis=(0.3, 0.5),
        freqs=(2000.0, 3000.0)), np.float64)
    return ensemble.pad_batch(u0, f)


def _both(u0, f, valid, cfg, spec, **kw):
    """The same rounds through both packages (the JAX one without a mesh,
    so both have the same bucket floor)."""
    jres = j_ensemble.make_rounds_tracer(
        cast_env(j_make_env_lat(), np.float64),
        cfg=JSolverConfig(**cfg), spec=JStopSpec(**spec), **kw,
    )
    j_out = jres(u0, f, valid)
    tres = ensemble.make_rounds_tracer(
        make_env_lat(), device="cpu", dtype=torch.float64,
        cfg=SolverConfig(**cfg), spec=StopSpec(**spec), **kw,
    )
    t_out = tres(u0, f, valid)
    return jres, j_out, tres, t_out


# dopri5 holds u to 1e-12; with the bs3 base the landing states carry the
# conditioning of bs3's error estimate (see test_torch_step_chunk.py):
# 1e-15 math-library differences reach ~5e-9 in the landing latitude
@pytest.mark.parametrize("base,rtol", [("bs3", 1e-8), ("dopri5", 1e-12)])
def test_rounds_tracer_matches_jax(base, rtol):
    u0, f, valid = _fan()
    jres, j_out, tres, t_out = _both(
        u0, f, valid, dict(rtol=1e-5, atol=1e-8, dt0=1e-4),
        dict(r_floor=1.0, t_max=5e9 / RE), stepper="auto",
        base_stepper=base, max_steps=1536, round_steps=(256, 256, 128),
        bucket_floor=8,
    )
    # the same schedule: buckets shrink and the straggler tail merges
    assert [(r["stepper"], r["active"], r["bucket"], r["steps"])
            for r in tres.last_rounds] == [
        (r["stepper"], r["active"], r["bucket"], r["steps"])
        for r in jres.last_rounds]
    assert len({r["bucket"] for r in tres.last_rounds}) >= 2
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(t_out, name),
                                      np.asarray(getattr(j_out, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t_out.u, np.asarray(j_out.u), rtol=rtol)
    np.testing.assert_allclose(t_out.t, np.asarray(j_out.t), rtol=rtol)
    assert (t_out.status == events.HIT_EARTH).all()


def test_stiff_pool_handoff_ros3pr():
    """Mirror of test_rounds.py::test_auto_pool_ros3pr_stiff_stepper: the
    switch threshold forced low so rays move to the ros3pr pool (torch
    ops, Jacobian by torch.func.jacfwd); pool membership, statuses and
    counters equal the JAX run's, states to 1e-12, and the physics equals
    the pure-dopri5 run within the cross-method tolerance."""
    u0, f = ensemble.build_launch(
        ensemble.LaunchSpec(lats=tuple(np.linspace(0.6, 0.9, 4))),
        np.float64)
    u0, f, valid = ensemble.pad_batch(u0, f)
    cfg = dict(rtol=1e-6, atol=1e-10, dt0=1e-4)
    spec = dict(r_floor=1.0, t_max=5e8 / RE)
    kw = dict(max_steps=4096, round_steps=256, bucket_floor=8)
    jres, j_out, tres, t_out = _both(
        u0, f, valid, cfg, spec, stepper="auto", stiff_stepper="ros3pr",
        stiff_switch=0.001, stiff_unswitch=0.0, **kw,
    )
    assert tres.last_stiff.any()
    np.testing.assert_array_equal(tres.last_stiff, jres.last_stiff)
    assert "ros3pr" in [r["stepper"] for r in tres.last_rounds]
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(t_out, name),
                                      np.asarray(getattr(j_out, name)))
    np.testing.assert_allclose(t_out.u, np.asarray(j_out.u), rtol=1e-12)

    dp5 = ensemble.make_rounds_tracer(
        make_env_lat(), device="cpu", dtype=torch.float64,
        cfg=SolverConfig(**cfg), spec=StopSpec(**spec), stepper="dopri5",
        **kw,
    )(u0, f, valid)
    v = valid
    np.testing.assert_array_equal(t_out.status[v], dp5.status[v])
    np.testing.assert_allclose(t_out.u[v, :2], dp5.u[v, :2], rtol=5e-3,
                               atol=5e-3)


def test_ensemble_stats_matches_jax():
    rng = np.random.default_rng(31)
    n = 40
    u = np.stack([np.ones(n), rng.uniform(-0.5, 0.5, n),
                  rng.uniform(-1, 1, n), rng.uniform(-0.2, 3, n)], 1)
    res = ensemble.TraceResult(
        u=u, t=rng.uniform(0, 9, n), status=rng.integers(1, 9, n),
        n_accept=rng.integers(0, 999, n), n_reject=rng.integers(0, 99, n))
    valid = np.arange(n) < 33
    got = ensemble.ensemble_stats(res, valid)
    ref = j_ensemble.ensemble_stats(res, valid, xp=np)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-15, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(grad_mode="autodiff", stiff_stepper="ros2x"),
    dict(grad_mode="autodiff"),
    dict(save_every=8, legacy_freq_state=True, grad_mode="autodiff"),
])
def test_unported_knobs_raise(kw):
    # the stiff steppers, the reference gradient set, legacy_freq_state,
    # the trajectory channel and the scheduling knobs run (tests/
    # test_torch_reference_mode.py, test_torch_modes.py,
    # test_torch_trajectory.py, test_torch_rounds_knobs.py); the autodiff
    # set (ROADMAP B7) stays refused, with the trajectory channel too
    with pytest.raises(NotImplementedError, match="B7"):
        ensemble.make_rounds_tracer(make_env_lat(), device="cpu",
                                    dtype=torch.float64, **kw)


def test_step_counters_must_fit_the_float_transport():
    with pytest.raises(ValueError, match="2\\^24"):
        ensemble.make_rounds_tracer(make_env_lat(), device="cpu",
                                    dtype=torch.float32, max_steps=1 << 24)
