"""A trace's end inside the step kernel's launch: `finish` and `fresh`.

On the card a final-states `trace` over a kernel pool asks its one launch
of csrc/step_chunk.cu to form the first k1 (`fresh`, init_carry's
right-hand side) and to refine the events after the loop (`finish`,
refine_events), so `_finish` only maps ACTIVE to MAX_STEPS. On the CPU the
wrapper runs the same control flow through the plain version (the
right-hand side, step_chunk_reference, refine_events). These tests hold
that path, on the CPU and in float64, to the path it replaced (init_carry,
the launch, _finish's post-pass) exactly, check where the post-pass stays
(the trajectory channel, the torch-op steppers), and hold a resume through
carry0 to the JAX package's trace(carry0=...). The kernel's epilogue and
prologue themselves are held to the plain version by
tests/test_torch_kernel_host.py (the host build) and chip_smoke.py (the
card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
from raytrace_tpu.integrate import trace as j_trace
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.integrate import events, solve
from raytrace_tpu_torch.integrate.solve import (
    RayCarry, init_carry, refine_events, step_loop, trace,
)
from raytrace_tpu_torch.kernel_ab import recording_launches
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import rhs as rhs_mod
from raytrace_tpu_torch.ops import step_chunk as sc
from raytrace_tpu_torch.run import _build_u0

# rays of each fan that land within a few hundred attempts (8 kHz) beside
# rays that run on past the budget
CUTS = {
    "ensemble10k": dict(lats=(0.8, 1.1), chis=(0.0, 0.5),
                        freqs=(2000.0, 8000.0)),
    "ensemble10k_3d": dict(lats=(0.45, 1.1), chis=(-0.5, 0.5),
                           freqs=(8000.0,)),
}
BUDGET = {"ensemble10k": 512, "ensemble10k_3d": 192}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(name, **over):
    conf = preset(name, dtype="float64", **CUTS[name], **over)
    env = conf.medium.build()
    u0, f = _build_u0(conf, env, np.float64, torch.device("cpu"))
    return conf, env, torch.as_tensor(u0), torch.as_tensor(f)


def _old_trace(conf, env, u0, f, stepper, max_steps, chunk=64):
    """The final-states trace as it ran before the launch ended it:
    init_carry, the launch's plain version, then _finish's post-pass."""
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env, conf.root)[0]
    carry = init_carry(rhs_fn, u0, f, conf.solver())
    carry = sc.step_chunk_reference(
        carry, f, env, conf.solver(), conf.stop(), stepper=stepper,
        n_steps=-(-max_steps // chunk) * chunk, frame=conf.frame,
        root=conf.root)
    return solve._finish(rhs_fn, carry, f, conf.stop())


def _assert_same(got, want):
    for name in RayCarry._fields:
        a, b = getattr(got.carry, name), getattr(want.carry, name)
        assert torch.equal(a, b), name
    for name in ("u", "t", "status", "n_accept", "n_reject"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("name", sorted(CUTS))
def test_trace_matches_the_post_pass_exactly(name):
    """trace over a kernel pool on the CPU: the same TraceResult, every
    field bit for bit, as init_carry + the launch + the post-pass; some
    rays land (refined to r = 1) and some run out of budget."""
    conf, env, u0, f = _setup(name)
    kw = dict(frame=conf.frame, cfg=conf.solver(), spec=conf.stop(),
              stepper="bs3", max_steps=BUDGET[name], root=conf.root)
    got = trace(env, u0, f, **kw)
    want = _old_trace(conf, env, u0, f, "bs3", BUDGET[name])
    _assert_same(got, want)
    hit = got.status == events.HIT_EARTH
    assert 0 < int(hit.sum()) < f.shape[0]
    assert (got.status == events.MAX_STEPS).any()
    np.testing.assert_allclose(got.u[hit, 0].numpy(), 1.0, atol=1e-9)


def _spy(monkeypatch, module):
    """Count the calls of `module`'s refine_events (solve's: _finish's
    post-pass; ops.step_chunk's: the wrapper's plain path)."""
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return refine_events(*args, **kw)

    monkeypatch.setattr(module, "refine_events", spy)
    return calls


def test_trace_asks_the_launch_to_finish_and_refines_once(monkeypatch):
    """A kernel pool's trace makes one launch with finish (and fresh where
    it starts the carry): the events are refined once per trace, in the
    launch (here the wrapper's plain path), never again in _finish, also
    on a resume."""
    conf, env, u0, f = _setup("ensemble10k_3d")
    in_finish, in_launch = _spy(monkeypatch, solve), _spy(monkeypatch, sc)
    kw = dict(frame=conf.frame, cfg=conf.solver(), spec=conf.stop(),
              stepper="bs3", max_steps=64, root=conf.root)
    with recording_launches() as seen:
        first = trace(env, u0, f, **kw)
        trace(env, u0, f, carry0=first.carry, **kw)
    assert [launch[-1]["finish"] for launch in seen] == [True, True]
    assert [launch[-1]["fresh"] for launch in seen] == [True, False]
    assert len(in_launch) == 2 and in_finish == []


def test_fresh_ignores_the_carry_k1():
    """step_chunk(fresh=True) forms k1 = rhs(u) itself: a carry whose k1 is
    NaN (or init_carry(None, ...)'s zeros) gives init_carry's result bit
    for bit, with finish as well."""
    conf, env, u0, f = _setup("ensemble10k")
    cfg, spec = conf.solver(), conf.stop()
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env)[0]
    want = refine_events(rhs_fn, sc.step_chunk_reference(
        init_carry(rhs_fn, u0, f, cfg), f, env, cfg, spec, stepper="bs3",
        n_steps=32), f, spec)
    blank = init_carry(None, u0, f, cfg)
    assert torch.equal(blank.k1, torch.zeros_like(u0))
    for k1 in (blank.k1, torch.full_like(u0, float("nan"))):
        got = sc.step_chunk(blank._replace(k1=k1), f, env, cfg, spec,
                            stepper="bs3", n_steps=32, finish=True,
                            fresh=True)
        for name in RayCarry._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    # n_steps = 0: the first right-hand side alone
    got = sc.step_chunk(blank, f, env, cfg, spec, stepper="bs3", n_steps=0,
                        fresh=True)
    assert torch.equal(got.k1, rhs_fn(u0, f))


def test_finish_refines_every_event_of_the_carry():
    """finish refines the rays that end on an event whichever launch
    retired them, as the post-pass does on a resumed carry: a launch of 0
    attempts over a carry with landed rays equals refine_events on it."""
    conf, env, u0, f = _setup("ensemble10k_3d")
    cfg, spec = conf.solver(), conf.stop()
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env)[0]
    carry = sc.step_chunk_reference(init_carry(rhs_fn, u0, f, cfg), f, env,
                                    cfg, spec, stepper="bs3", n_steps=192,
                                    frame="3d")
    assert (carry.status == events.HIT_EARTH).any()
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3", n_steps=0,
                        frame="3d", finish=True)
    want = refine_events(rhs_fn, carry, f, spec)
    for name in RayCarry._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    moved = (got.u != carry.u).any(dim=1)
    assert torch.equal(moved, carry.status == events.HIT_EARTH)


def test_trajectory_channel_keeps_the_post_pass(monkeypatch):
    """save_every > 0: the snapshots hold the unrefined carry of each block
    (the JAX package's scan), the final carry is refined once, by _finish,
    and the first launch forms k1 (fresh)."""
    conf, env, u0, f = _setup("ensemble10k_3d")
    cfg, spec = conf.solver(), conf.stop()
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env)[0]
    in_finish, in_launch = _spy(monkeypatch, solve), _spy(monkeypatch, sc)
    with recording_launches() as seen:
        res = trace(env, u0, f, frame="3d", cfg=cfg, spec=spec,
                    stepper="bs3", max_steps=192, save_every=64, chunk=64)
    assert len(in_finish) == 1 and in_launch == [] and seen == []
    carry = init_carry(rhs_fn, u0, f, cfg)
    for k in range(3):
        carry = sc.step_chunk_reference(carry, f, env, cfg, spec,
                                        stepper="bs3", n_steps=64,
                                        frame="3d")
        assert torch.equal(res.traj["u"][k], carry.u)
        assert torch.equal(res.traj["t"][k], carry.t)
        assert torch.equal(res.traj["status"][k], carry.status)
    want = solve._finish(rhs_fn, carry, f, spec)
    _assert_same(res, want)
    hit = res.status == events.HIT_EARTH
    assert hit.any() and not torch.equal(res.u[hit], res.traj["u"][-1][hit])


def test_stiff_pool_keeps_the_post_pass(monkeypatch):
    """The torch-op steppers (ros3pr, the auto mode's stiff pool) step
    through step_loop and refine in _finish: a toy ray with dr/dt = -1
    from r = 2 lands at t = 1 through the post-pass, as through a kernel
    pool's launch."""
    monkeypatch.setitem(rhs_mod.FRAMES, "toy", (
        lambda u, f, env, root=1.0: torch.stack(
            [torch.full_like(u[..., 0], -1.0)]
            + [torch.zeros_like(u[..., 0])] * 3, dim=-1), 3))
    monkeypatch.setitem(sc._FRAME_CODE, "toy", (0, 4))
    u0 = torch.tensor([[2.0, 0.5, 0.0, 0.0]], dtype=torch.float64)
    f = torch.zeros(1, dtype=torch.float64)
    kw = dict(frame="toy", cfg=solve.SolverConfig(dt0=0.3, dt_max=0.3),
              spec=events.StopSpec(r_floor=1.0, t_max=10.0), max_steps=64)
    for stepper in ("ros3pr", "dopri5"):
        in_finish, in_launch = _spy(monkeypatch, solve), _spy(monkeypatch,
                                                              sc)
        with recording_launches() as seen:
            res = trace(medium.make_env_lat(), u0, f, stepper=stepper, **kw)
        kernel = stepper == "dopri5"
        assert (len(in_finish), len(in_launch), len(seen)) == (
            (0, 1, 1) if kernel else (1, 0, 0))
        assert res.status.tolist() == [events.HIT_EARTH]
        assert float(res.t[0]) == pytest.approx(1.0, abs=1e-9)
        assert float(res.u[0, 0]) == pytest.approx(1.0, abs=1e-9)
    rhs_fn = rhs_mod.frame_rhs("toy", None)[0]
    want = solve._finish(rhs_fn, step_loop(
        rhs_fn, init_carry(rhs_fn, u0, f, kw["cfg"]), f, kw["cfg"],
        kw["spec"], stepper="ros3pr", n_steps=64), f, kw["spec"])
    got = trace(medium.make_env_lat(), u0, f, stepper="ros3pr", **kw)
    _assert_same(got, want)


# test_torch_slice.py's 16 rays, which land cleanly in < 1000 attempts:
# the 3 kHz rays within the first call's 704, the 2 kHz ones after it
CUT_RESUME = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
                  freqs=(2000.0, 3000.0))


def test_resume_through_carry0_matches_jax():
    """A resume as continue_until_done makes it: trace to a short budget,
    then trace(carry0=...) on, in both packages (float64, dopri5 at the
    fan's tolerances). The rays that land in the first call are refined
    again by the second (both packages refine every event of the carry),
    the MAX_STEPS rays re-arm; statuses and counters equal, states and
    phase paths within 1e-12 (test_torch_slice.py's dopri5 band)."""
    jconf = j_config.preset("ensemble10k", dtype="float64", **CUT_RESUME)
    ju0, jf = j_run._build_u0(jconf, np.float64)
    jenv = jconf.medium.build()
    jrhs = lambda u, ff: j_rhs.rhs_2d_lat(u, ff, jenv)  # noqa: E731
    jkw = dict(cfg=jconf.solver(), spec=jconf.stop(), stepper="dopri5",
               chunk=64)
    j1 = j_trace(jrhs, jnp.asarray(ju0), jnp.asarray(jf), max_steps=704,
                 **jkw)
    j2 = j_trace(jrhs, jnp.asarray(ju0), jnp.asarray(jf), max_steps=320,
                 carry0=j1.carry, **jkw)
    conf = preset("ensemble10k", dtype="float64", **CUT_RESUME)
    env = conf.medium.build()
    u0, f = (torch.as_tensor(x) for x in _build_u0(
        conf, env, np.float64, torch.device("cpu")))
    kw = dict(frame="2d_lat", cfg=conf.solver(), spec=conf.stop(),
              stepper="dopri5")
    t1 = trace(env, u0, f, max_steps=704, **kw)
    t2 = trace(env, u0, f, carry0=t1.carry, max_steps=320, **kw)
    for jr, tr in ((j1, t1), (j2, t2)):
        for name in ("status", "n_accept", "n_reject"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)),
                                          err_msg=name)
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t),
                                   rtol=1e-12)
    st1, st2 = t1.status.numpy(), t2.status.numpy()
    assert (st1 == events.HIT_EARTH).any() and (st1 == events.MAX_STEPS).any()
    assert ((st1 == events.MAX_STEPS) & (st2 == events.HIT_EARTH)).any()
    jax.clear_caches()
