"""Port parity: the rounds tracer's scheduling knobs (pipeline,
order_switch_dt, tail_stepper) in raytrace_tpu_torch against the JAX
package's, float64 on the CPU (the port's plain version).

The JAX package's own tests of the knobs (tests/test_rounds.py) are
ported, and every knob run is held to the JAX run with the same knob on
the same seeded launch: statuses, counters and the per-round schedule
equal, states to 1e-12 where every launch is dopri5 and to 1e-8 where bs3
takes part (1e-15 math-library differences reach ~5e-9 through bs3's
error estimate, tests/test_torch_rounds.py)."""

import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.models import cast_env, make_env_lat as j_make_env_lat
from raytrace_tpu.parallel import ensemble as j_ensemble
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.parallel import ensemble

CFG = dict(rtol=1e-6, atol=1e-10, dt0=1e-4)
SPEC = dict(r_floor=1.0, t_max=5e8 / RE)
# the landing fan of tests/test_torch_rounds.py: 24 rays whose
# trajectories are well conditioned (they land), traced to the surface
LAND = dict(lats=tuple(np.linspace(0.75, 1.05, 6)), chis=(0.3, 0.5),
            freqs=(2000.0, 3000.0))
LAND_CFG = dict(rtol=1e-5, atol=1e-8, dt0=1e-4)
LAND_SPEC = dict(r_floor=1.0, t_max=5e9 / RE)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _launch(lats, chis=(0.0,), freqs=(1000.0,)):
    u0, f = ensemble.build_launch(
        ensemble.LaunchSpec(lats=lats, chis=chis, freqs=freqs), np.float64)
    return ensemble.pad_batch(u0, f)


def _port(u0, f, valid, cfg=CFG, spec=SPEC, **kw):
    tr = ensemble.make_rounds_tracer(
        make_env_lat(), device="cpu", dtype=torch.float64,
        cfg=SolverConfig(**cfg), spec=StopSpec(**spec), **kw)
    return tr, tr(u0, f, valid)


def _jax(u0, f, valid, cfg=CFG, spec=SPEC, **kw):
    tr = j_ensemble.make_rounds_tracer(
        cast_env(j_make_env_lat(), np.float64), cfg=JSolverConfig(**cfg),
        spec=JStopSpec(**spec), **kw)
    return tr, tr(u0, f, valid)


def _schedule(tr):
    return [(r["stepper"], r["active"], r["bucket"], r["steps"])
            for r in tr.last_rounds]


def _hold_to_jax(tres, t_out, jres, j_out, rtol):
    assert _schedule(tres) == _schedule(jres)
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(t_out, name),
                                      np.asarray(getattr(j_out, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t_out.u, np.asarray(j_out.u), rtol=rtol)
    np.testing.assert_allclose(t_out.t, np.asarray(j_out.t), rtol=rtol)


def _equal(a, b, v):
    for name in ("status", "n_accept", "n_reject", "u", "t"):
        np.testing.assert_array_equal(getattr(a, name)[v],
                                      getattr(b, name)[v], err_msg=name)


PIPE_KW = dict(stepper="dopri5", max_steps=1536, round_steps=(256, 256, 128),
               bucket_floor=8)


def test_pipeline_split_exact():
    """Mirror of test_rounds.py::test_rounds_pipeline_split_exact: the
    split of every round into parts (24 rays at a bucket floor of 8 are 3
    floor units: 16 + 8 rays while all are active) changes no per-ray
    result to the landing, and the parts, statuses, counters and states
    are the JAX package's."""
    u0, f, valid = _launch(**LAND)
    one_tr, one = _port(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=1,
                        **PIPE_KW)
    tr, split = _port(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=2,
                      **PIPE_KW)
    assert [r["active"] for r in tr.last_rounds[1:3]] == [16, 8]
    assert len(tr.last_rounds) > len(one_tr.last_rounds)
    _equal(split, one, valid)
    assert (split.status[valid] == events.HIT_EARTH).all()
    jres, j_out = _jax(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=2,
                       **PIPE_KW)
    _hold_to_jax(tr, split, jres, j_out, rtol=1e-12)


# 40 rays at floor 8 are 5 units, 4 + 1 in binary: pipeline 2 keeps
# them, 3 halves the 4, and 4 can split no further (a part of 2 units
# is not halved)
@pytest.mark.parametrize("pipeline,parts", [
    (2, [32, 8]), (3, [16, 16, 8]), (4, [16, 16, 8]),
])
def test_split_parts_match_jax(pipeline, parts):
    """The parts of a round of 40 rays: the JAX package's _split_parts
    (the same launches in the same order), the states after the round the
    JAX run's to 1e-12 and pipeline=1's bit for bit."""
    u0, f, valid = _launch(tuple(np.linspace(0.75, 1.05, 10)),
                           chis=(0.3, 0.5), freqs=(2000.0, 3000.0))
    kw = dict(stepper="dopri5", max_steps=384, round_steps=(256, 128),
              bucket_floor=8)
    tr, split = _port(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=pipeline,
                      **kw)
    assert [r["active"] for r in tr.last_rounds[1:]] == parts
    _, one = _port(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=1, **kw)
    _equal(split, one, valid)
    jres, j_out = _jax(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=pipeline,
                       **kw)
    _hold_to_jax(tr, split, jres, j_out, rtol=1e-12)


@pytest.mark.parametrize("pipeline", [2, 3])
def test_pipeline_with_trajectory_bit_for_bit(pipeline):
    """pipeline with the trajectory channel: each part's snapshot block is
    scattered at its rays' own cursors, so the assembled trajectory and
    the final states equal pipeline=1's bit for bit."""
    u0, f, valid = _launch(**LAND)
    kw = dict(stepper="auto", base_stepper="bs3", max_steps=512,
              round_steps=(128, 128, 64), bucket_floor=8, save_every=32)
    _, one = _port(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=1, **kw)
    tr, split = _port(u0, f, valid, LAND_CFG, LAND_SPEC, pipeline=pipeline,
                      **kw)
    assert len(tr.last_rounds) > 4
    _equal(split, one, valid)
    assert split.traj.keys() == one.traj.keys()
    for k in one.traj:
        np.testing.assert_array_equal(split.traj[k], one.traj[k], err_msg=k)


ORDER_KW = dict(max_steps=4096, round_steps=256, bucket_floor=8)


def test_order_pool_bs3_to_dp5():
    """Mirror of test_rounds.py::test_auto_order_pool_bs3_to_dp5: with a
    forced-low threshold every ray moves from the bs3 base to the dopri5
    pool after round 0, the hand-off preserves the physics, and the pools,
    statuses and counters are the JAX package's."""
    u0, f, valid = _launch(tuple(np.linspace(0.6, 0.9, 4)))
    knob = dict(stepper="auto", base_stepper="bs3", order_switch_dt=10.0,
                order_unswitch_dt=1.0e9, **ORDER_KW)
    tr, res = _port(u0, f, valid, **knob)
    assert tr.last_slow is not None and tr.last_slow.any()
    assert "dopri5" in [r["stepper"] for r in tr.last_rounds]
    _, dp5 = _port(u0, f, valid, stepper="dopri5", **ORDER_KW)
    np.testing.assert_array_equal(res.status[valid], dp5.status[valid])
    np.testing.assert_allclose(res.u[valid, :2], dp5.u[valid, :2],
                               rtol=5e-3, atol=5e-3)
    jres, j_out = _jax(u0, f, valid, **knob)
    np.testing.assert_array_equal(tr.last_slow, jres.last_slow)
    _hold_to_jax(tr, res, jres, j_out, rtol=1e-8)


def test_order_pool_hysteresis_matches_jax():
    """Both ways through the hysteresis on the landing fan: at a switch
    level of 0.9 dt_max and an unswitch level of 0.95, three rays take
    the dopri5 pool after round 0 and return to bs3 after round 1; the
    pools of every round, statuses, counters and landings are the JAX
    package's."""
    u0, f, valid = _launch(**LAND)
    knob = dict(stepper="auto", base_stepper="bs3", order_switch_dt=0.9,
                order_unswitch_dt=0.95, max_steps=1536,
                round_steps=(256, 256, 128), bucket_floor=8)
    tr, res = _port(u0, f, valid, LAND_CFG, LAND_SPEC, **knob)
    steppers = [r["stepper"] for r in tr.last_rounds]
    assert steppers[2] == "dopri5" and steppers[3:] == ["bs3"] * (
        len(steppers) - 3)
    assert not tr.last_slow.any()
    jres, j_out = _jax(u0, f, valid, LAND_CFG, LAND_SPEC, **knob)
    np.testing.assert_array_equal(tr.last_slow, jres.last_slow)
    _hold_to_jax(tr, res, jres, j_out, rtol=1e-8)


def test_order_pool_off_is_two_pool():
    """order_switch_dt = 0 keeps a bs3-base run on two pools: no ray lands
    on the dopri5 pool."""
    u0, f, valid = _launch(tuple(np.linspace(0.6, 0.9, 4)))
    tr, _ = _port(u0, f, valid, stepper="auto", base_stepper="bs3",
                  order_switch_dt=0.0, **ORDER_KW)
    assert tr.last_slow is not None and not tr.last_slow.any()
    assert {r["stepper"] for r in tr.last_rounds} <= {"bs3", "ros3pr"}


TAIL_KW = dict(max_steps=4096, round_steps=128, bucket_floor=32)


def test_merged_tail_order5():
    """Mirror of test_rounds.py::test_merged_tail_order5: with 8 rays at
    floor 32 every round after round 0 is the merged tail, whose non-stiff
    pool runs dopri5; statuses equal the pinned-bs3 run's and landings
    agree to the method difference; the rounds, statuses and counters are
    the JAX package's."""
    u0, f, valid = _launch(tuple(np.linspace(0.6, 0.9, 8)))
    knob = dict(stepper="auto", base_stepper="bs3", tail_stepper="dopri5",
                **TAIL_KW)
    tr, res = _port(u0, f, valid, **knob)
    tail = [r for r in tr.last_rounds[1:] if r["stepper"] != "ros3pr"]
    assert tail and all(r["stepper"] == "dopri5" for r in tail)
    _, bs3 = _port(u0, f, valid, stepper="bs3", **TAIL_KW)
    np.testing.assert_array_equal(res.status[valid], bs3.status[valid])
    np.testing.assert_allclose(res.u[valid, 0], bs3.u[valid, 0], atol=1e-5)
    jres, j_out = _jax(u0, f, valid, **knob)
    _hold_to_jax(tr, res, jres, j_out, rtol=1e-8)


def test_tail_stepper_off_is_pinned_base():
    """tail_stepper = "" keeps the base method in every round: bit for bit
    the pinned-bs3 run (no ray trips the stiff pool here)."""
    u0, f, valid = _launch(tuple(np.linspace(0.6, 0.9, 8)))
    tr, off = _port(u0, f, valid, stepper="auto", base_stepper="bs3",
                    tail_stepper="", **TAIL_KW)
    assert all(r["stepper"] == "bs3" for r in tr.last_rounds)
    _, bs3 = _port(u0, f, valid, stepper="bs3", **TAIL_KW)
    _equal(off, bs3, valid)


def test_order_pools_refuse_arc_ceiling():
    """Mirror of test_rounds.py::test_order_pools_refuse_arc_ceiling: the
    order hysteresis is calibrated against dt_max, so the arc-length
    ceiling is refused."""
    with pytest.raises(ValueError, match="arc-length"):
        ensemble.make_rounds_tracer(
            make_env_lat(), device="cpu", dtype=torch.float64,
            cfg=SolverConfig(rtol=1e-6, atol=1e-10, ds_max=0.3),
            stepper="auto", base_stepper="bs3", order_switch_dt=0.12)


def test_unknown_tail_stepper_raises():
    with pytest.raises(ValueError, match="unknown stepper"):
        ensemble.make_rounds_tracer(make_env_lat(), device="cpu",
                                    dtype=torch.float64, tail_stepper="rk45")


if __name__ == "__main__":
    # The JAX package's census of a preset on the CPU under one knob of
    # the rounds tracer, traced in one batch as run() traces it (the merged
    # tail depends on the batch): the pins of chip_smoke.py phase 32.
    #
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_rounds_knobs.py \
    #       ensemble10k float64 tail_stepper='"dopri5"' [--out rays.npz]
    #
    # --out writes each ray's status and step counters; --nudge moves
    # every launch latitude up by one ulp (the run's own sensitivity to
    # rounding).
    import ast
    import json
    import sys
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import raytrace_tpu.config as j_config
    import raytrace_tpu.run as j_run
    from raytrace_tpu.parallel import ensemble_stats

    args = sys.argv[1:]
    out = ""
    if "--out" in args:
        k = args.index("--out")
        out = args[k + 1]
        del args[k:k + 2]
    nudge = "--nudge" in args
    if nudge:
        args.remove("--nudge")
    name, dtype = args[0], args[1]
    knobs = {k: ast.literal_eval(v) for k, v in
             (a.split("=", 1) for a in args[2:])}
    conf = j_config.preset(name, dtype=dtype)
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = j_run._build_u0(conf, np_dt)
    if nudge:
        u0[:, 1] = np.nextafter(u0[:, 1], np.inf)
    kw = dict(frame=conf.frame, cfg=conf.solver(), spec=conf.stop(),
              adaptive=conf.adaptive, stepper=conf.stepper,
              max_steps=conf.max_steps, grad_mode=conf.grad_mode,
              root=conf.root, want_carry=False,
              base_stepper=conf.base_stepper, **knobs)
    if conf.round_steps:
        kw["round_steps"] = tuple(conf.round_steps)
    tracer = j_ensemble.make_rounds_tracer(
        cast_env(conf.medium.build(), np_dt), **kw)
    t0 = time.perf_counter()
    res = tracer(u0, f, np.ones(u0.shape[0], bool))
    spec = conf.stop()
    stats = ensemble_stats(res, np.ones(u0.shape[0], bool),
                           lat_sign=spec.lat_sign,
                           lat_offset=spec.lat_offset, xp=np)
    stats = {k: np.asarray(v).item() for k, v in stats.items()}
    stats["attempted_steps"] = (stats["total_accepted_steps"]
                                + stats["total_rejected_steps"])
    if out:
        np.savez(out, **{k: np.asarray(getattr(res, k)) for k in
                         ("status", "n_accept", "n_reject")})
    print(json.dumps({
        "preset": name, "dtype": dtype, "knobs": knobs, "stats": stats,
        "launches": [(r["stepper"], r["active"], r["steps"])
                     for r in tracer.last_rounds],
        "seconds": time.perf_counter() - t0}, indent=1))
