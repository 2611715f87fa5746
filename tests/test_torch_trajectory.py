"""Port parity for the trajectory channel: trace(save_every, save_fn), the
rounds tracer's snapshot channel and the single-program tracer, run()'s
trajectory branches, explicit ray lists and the CLI flags, against the
JAX package (float64 on the CPU, the port's plain version)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
import raytrace_tpu_torch.config as t_config
import raytrace_tpu_torch.run as t_run
from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import trace as j_trace
from raytrace_tpu.integrate.saving import save_fn_for as j_save_fn_for
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu.parallel import ensemble as j_ensemble
from raytrace_tpu_torch.__main__ import main as t_main
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.saving import save_fn_for
from raytrace_tpu_torch.integrate.solve import SolverConfig, trace
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.parallel import ensemble


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# two rays of the rounds tests' fan that land cleanly
# (test_torch_rounds.py::_fan), at its tolerances: within 673 dopri5 and
# 704 bs3 attempts
U0, F = ensemble.build_launch(ensemble.LaunchSpec(
    lats=(1.0, 1.1), chis=(0.5,), freqs=(3000.0,)), np.float64)
CFG = dict(rtol=1e-5, atol=1e-8, dt0=1e-4)
SPEC = dict(r_floor=1.0, t_max=5e9 / RE)


# dopri5 holds the snapshots to 1e-12; bs3's error estimate turns the two
# math libraries' last bits into ~1e-8 (test_torch_step_chunk.py). The
# extras are a function of the snapshot: 1e-10 where u holds 1e-12, and
# u's band where it does not
@pytest.mark.parametrize("stepper,rtol,extras_rtol", [
    ("dopri5", 1e-12, 1e-10), ("bs3", 1e-8, 1e-6),
])
def test_trace_trajectory_matches_jax(stepper, rtol, extras_rtol):
    j_env = j_make_env_lat()
    kw = dict(stepper=stepper, max_steps=736, save_every=32)
    jr = j_trace(
        lambda u, ff: j_rhs.rhs_2d_lat(u, ff, j_env), jnp.asarray(U0),
        jnp.asarray(F), cfg=JSolverConfig(**CFG), spec=JStopSpec(**SPEC),
        save_fn=j_save_fn_for("2d_lat", j_env), **kw)
    env = make_env_lat()
    tr = trace(env, torch.from_numpy(U0), torch.from_numpy(F),
               cfg=SolverConfig(**CFG), spec=StopSpec(**SPEC),
               save_fn=save_fn_for("2d_lat", env), **kw)
    assert set(tr.traj) == set(jr.traj) == {"u", "t", "status", "extras"}
    for k, v in jr.traj.items():
        assert tuple(tr.traj[k].shape) == v.shape, k
        assert tr.traj[k].dtype == (torch.int32 if k == "status"
                                    else torch.float64)
    assert tr.traj["u"].shape[0] == 736 // 32
    np.testing.assert_array_equal(tr.traj["status"].numpy(),
                                  np.asarray(jr.traj["status"]))
    for k in ("u", "t"):
        np.testing.assert_allclose(tr.traj[k].numpy(), np.asarray(jr.traj[k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tr.traj["extras"].numpy(),
                               np.asarray(jr.traj["extras"]),
                               rtol=extras_rtol)
    # the final carry: MAX_STEPS relabelled and the events refined
    for k in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(),
                                      np.asarray(getattr(jr, k)), err_msg=k)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=rtol)
    st = tr.traj["status"].numpy()
    # the rays land inside the budget (the loop stops launching, and the
    # rows left repeat the frozen state, as the scan records it); the
    # last row holds the unrefined landing state (below the floor), the
    # result the refined one
    assert (st[-1] == events.HIT_EARTH).all() and (st[0] == 0).all()
    assert (st[-2] == events.HIT_EARTH).all()
    assert (tr.traj["u"].numpy()[-1, :, 0] < 1.0).all()
    np.testing.assert_allclose(tr.u.numpy()[:, 0], 1.0, rtol=1e-9)


def _rounds_setup(lats):
    u0, f = ensemble.build_launch(ensemble.LaunchSpec(lats=lats), np.float64)
    return ensemble.pad_batch(u0, f)


def test_rounds_trajectory_channel_matches_single_shot():
    """Mirror of test_rounds.py::test_rounds_trajectory_channel_matches_
    single_shot: the host-assembled snapshot buffers of the rounds tracer
    (scattered per round at each ray's cursor, forward-filled past a
    ray's end) equal the single-program trajectory bit for bit with a
    pinned stepper, extras included."""
    u0, f, valid = _rounds_setup(tuple(np.linspace(0.6, 0.9, 8)))
    env = make_env_lat()
    kw = dict(device="cpu", dtype=torch.float64,
              cfg=SolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4),
              spec=StopSpec(r_floor=1.0, t_max=5e8 / RE), max_steps=768,
              stepper="bs3", save_every=64,
              save_fn=save_fn_for("2d_lat", env))
    tracer = ensemble.make_rounds_tracer(env, round_steps=128,
                                         bucket_floor=8, stall_progress=0.0,
                                         **kw)
    rounds = tracer(u0, f, valid)
    single = ensemble.make_ensemble_tracer(env, **kw)(u0, f)
    assert len(tracer.last_rounds) >= 3
    assert rounds.traj is not None and set(rounds.traj) == set(single.traj)
    assert rounds.traj["u"].shape[0] == 768 // 64
    for k in single.traj:
        np.testing.assert_array_equal(
            rounds.traj[k][:, valid], single.traj[k].numpy()[:, valid],
            err_msg=f"trajectory channel {k!r} diverged")
    np.testing.assert_array_equal(rounds.u[valid], single.u.numpy()[valid])
    np.testing.assert_array_equal(rounds.status[valid],
                                  single.status.numpy()[valid])
    # the packed float transport of every round left the carry unchanged:
    # the status of the last row is the final one before relabelling
    st = rounds.traj["status"][:, valid]
    assert (st[-1] != events.ACTIVE).all()


def test_rounds_trajectory_cadence_validation():
    with pytest.raises(ValueError, match="multiples of save_every"):
        ensemble.make_rounds_tracer(
            make_env_lat(), device="cpu", dtype=torch.float64,
            spec=StopSpec(r_floor=1.0, t_max=1e8 / RE), max_steps=1024,
            round_steps=(100, 512), save_every=64,
        )
    with pytest.raises(ValueError, match="multiples of save_every"):
        ensemble.make_rounds_tracer(
            make_env_lat(), device="cpu", dtype=torch.float64,
            max_steps=1000, round_steps=512, save_every=64,
        )


def test_stiff_pool_trajectory_cadence():
    """Mirror of test_rounds.py::test_stiff_pool_trajectory_cadence at a
    cadence whose stiff cap (max(k, 1024 - 1024 % k)) bites: save_every
    640 caps the stiff pool's rounds at 640 attempts. Every ray is forced
    onto the stiff pool after round 0, then runs 640 of round 1's 1280:
    rows == attempts // save_every exactly on the ray's own clock, the
    rows past its cursor repeat its last one bitwise, and that last row is
    the final carry. The stiff pool is heun2 (a torch-op stepper: the
    cadence is a matter of pool identity, not of the method)."""
    u0, f, valid = _rounds_setup(tuple(np.linspace(0.6, 0.9, 4)))
    save_every = 640
    kw = dict(
        device="cpu", dtype=torch.float64,
        cfg=SolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4),
        spec=StopSpec(r_floor=1.0, t_max=5e9 / RE), max_steps=2560,
        round_steps=1280, bucket_floor=8, save_every=save_every,
    )
    auto = ensemble.make_rounds_tracer(
        make_env_lat(), stepper="auto", base_stepper="bs3",
        stiff_stepper="heun2", stiff_switch=0.001, stiff_unswitch=0.0, **kw)
    res = auto(u0, f, valid)
    assert auto.last_stiff[valid].all()  # the forced switch took
    assert [r["steps"] for r in auto.last_rounds] == [1280, 640]
    tt, tu = res.traj["t"], res.traj["u"]
    att = res.n_accept + res.n_reject
    assert tt.shape[0] == 2560 // save_every
    for i in np.nonzero(valid)[0]:
        assert att[i] == 1280 + 640, att[i]
        assert int(res.status[i]) == events.MAX_STEPS
        kf = np.nonzero(np.diff(tt[:, i]) > 0)[0][-1] + 1
        assert kf + 1 == att[i] // save_every   # the own-clock cadence
        assert (tu[kf:, i] == tu[kf, i]).all()  # forward fill, bitwise
        np.testing.assert_array_equal(tu[kf, i], res.u[i])


def test_run_trajectory_branches_match_each_other_and_jax(tmp_path):
    """run() with save_every and save_diagnostics through the rounds
    tracer and through use_rounds=False: bitwise equal to each other,
    within dopri5's band of the JAX package's run() on the same 4-ray
    lat_fan, statuses exactly; the files and the record's keys."""
    kw = dict(max_steps=256, dtype="float64", save_every=32,
              save_diagnostics=True, stepper="dopri5",
              lats=tuple(np.linspace(0.6, 0.8, 4)), chis=(0.0,))
    j_out = j_run.run(j_config.preset("lat_fan", **kw),
                      out_dir=str(tmp_path / "jax"))
    rounds = t_run.run(t_config.preset("lat_fan", **kw), device="cpu",
                       out_dir=str(tmp_path / "port"))
    single = t_run.run(t_config.preset("lat_fan", use_rounds=False, **kw),
                       device="cpu")
    # the JAX package pads the batch to its eight CPU devices: the valid
    # rays come first in both
    v = rounds["valid"]
    n = int(v.sum())
    traj, j_traj = rounds["result"].traj, j_out["result"].traj
    assert set(traj) == set(j_traj) == {"u", "t", "status", "extras"}
    assert traj["u"].shape == (256 // 32, 8, 4)
    for k in traj:
        np.testing.assert_array_equal(
            traj[k][:, v], single["result"].traj[k][:, v],
            err_msg=f"run()-level trajectory channel {k!r} diverged")
        got, ref = traj[k][:, :n], np.asarray(j_traj[k])[:, :n]
        if k == "status":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-10 if k == "extras"
                                       else 1e-12, err_msg=k)
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(
            getattr(single["result"], name)[:n],
            np.asarray(getattr(j_out["result"], name))[:n])
    assert rounds["rounds"] and single["rounds"] is None
    paths = rounds["paths"]
    assert set(paths) == set(j_out["paths"]) == {"final", "traj", "record"}
    with np.load(paths["traj"]) as z:
        assert set(z.files) == set(traj)
        np.testing.assert_array_equal(z["u"], traj["u"])
    rec = json.loads(open(paths["record"]).read())
    j_rec = json.loads(open(j_out["paths"]["record"]).read())
    assert rec.keys() == j_rec.keys()
    assert rec["result"].keys() == j_rec["result"].keys()
    assert rec["result"]["n_rays"] == 8   # the JAX package's pads to 64
    assert rec["backend"] == "cpu" and rec["launch"] == j_rec["launch"]
    assert json.loads(rec["extra"]["config"]) == json.loads(
        j_rec["extra"]["config"])


def test_build_launch_list_matches_jax():
    rays = [(0.8, 0.3, 2000.0), (0.9, -0.1, 3000.0, 1.2)]
    u0, f = ensemble.build_launch_list(rays, dtype=np.float64)
    u0_j, f_j = j_ensemble.build_launch_list(rays, dtype=np.float64)
    np.testing.assert_array_equal(u0, u0_j)
    np.testing.assert_array_equal(f, f_j)
    with pytest.raises(ValueError, match="lat, chi, freq"):
        ensemble.build_launch_list([(0.8, 0.3)])


def test_single_program_ray_list_matches_jax_and_3d_refuses():
    """use_rounds=False without the channel, over an explicit ray list:
    one trace call over the batch (the JAX package's make_ensemble_tracer
    path), stepper auto mapped to dopri5. Ray lists are 2D only."""
    rays = ((0.75, 0.3, 2000.0), (1.05, 0.3, 2000.0))
    kw = dict(rays=rays, max_steps=128, dtype="float64", use_rounds=False,
              rtol=1e-5, atol=1e-8)
    j_out = j_run.run(j_config.preset("ensemble10k", **kw))
    t_out = t_run.run(t_config.preset("ensemble10k", **kw), device="cpu")
    n = int(t_out["valid"].sum())
    jr, tr = j_out["result"], t_out["result"]
    assert n == 2 and tr.traj is None and isinstance(tr.u, np.ndarray)
    assert t_out["rounds"] is None
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, name)[:n],
                                      np.asarray(getattr(jr, name))[:n])
    np.testing.assert_allclose(tr.u[:n], np.asarray(jr.u)[:n], rtol=1e-12)
    assert (tr.status[:n] == events.MAX_STEPS).all()
    for run, cfg in ((t_run.run, t_config), (j_run.run, j_config)):
        conf = cfg.preset("3d", rays=rays, max_steps=8)
        with pytest.raises(ValueError, match="2D-only"):
            run(conf, **({"device": "cpu"} if run is t_run.run else {}))


def test_cli_trajectory_writes_the_channel(tmp_path):
    cfg = t_config.preset("ensemble10k", lats=(0.9,), chis=(0.5,),
                          freqs=(3000.0,), max_steps=256)
    path = tmp_path / "tiny.json"
    cfg.to_json(str(path))
    out = tmp_path / "out"
    assert t_main([str(path), "--device", "cpu", "--float64",
                   "--trajectory", "32", "--out", str(out)]) == 0
    with np.load(out / "ensemble10k_traj.npz") as z:
        assert z["u"].shape == (256 // 32, 8, 4)
        assert z["extras"].shape == (256 // 32, 8, 4)
    assert (out / "ensemble10k_final.npz").exists()
    assert (out / "ensemble10k_record.json").exists()


@pytest.mark.parametrize("flag,item", [
    (["--sensitivity", "2"], "A13"),
])
def test_cli_refuses_unported_flags(flag, item, capsys):
    # ported: --sensitivity N sets sensitivity_rays (the channel's run is
    # held in tests/test_torch_sensitivity.py); --plots and --multihost
    # run (tests/test_torch_plots.py, test_torch_distributed.py)
    assert t_main(["ensemble10k", *flag, "--dump-config"]) == 0
    assert '"sensitivity_rays": 2' in capsys.readouterr().out
