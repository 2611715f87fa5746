"""Port parity for the 3D slice as a whole: raytrace_tpu_torch.run.run
against raytrace_tpu.run.run on 16-ray cuts of ensemble10k_3d and
ensemble10k_production (float64, CPU), the float32-vs-float64 landing pin
of the 3D production setting, the newly served presets and the launch.

Run as a script, the file prints the JAX package's census of a preset on
the CPU, traced in batches of --batch rays (1,024 by default; the numbers
chip_smoke.py pins and PERF.md records, for ensemble10k_3d,
ensemble10k_production, ensemble10k_plume and, in one batch of 2,048,
mr_fan_3d); --against a census of the same preset in the other dtype adds
the float32-vs-float64 agreement (statuses, median landing L); --rays
i,j,... instead traces each listed ray alone in both packages on the CPU
(status and step counters); --set field=value (repeatable) overrides a
field of the preset (a Python literal, e.g. --set frame='"2d_colat"'
--set adaptive=False --set dt0=0.15695630336514316 --set
grad_mode='"reference"'); --run traces the preset through the JAX
package's run() instead, in one batch (the path of --set
continue_until_done=True); --nudge moves every launch latitude up by one
ulp (a run's own sensitivity to rounding). A batch of at most 64 rays is
traced in one full-budget round, as run() traces it:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_slice3d.py \\
        ensemble10k_plume float64 [--out census.npz] [--against other.npz] \\
        [--batch 1024] [--rays 1346,1410] [--set frame='"2d_colat"'] \\
        [--run] [--nudge]
"""

import json

import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
import raytrace_tpu_torch.config as t_config
import raytrace_tpu_torch.run as t_run
from raytrace_tpu_torch.integrate import events

# 16 rays of ensemble10k_3d that land in a few hundred steps
CUT_3D = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(-0.2, 0.2),
              freqs=(2000.0, 3000.0), dtype="float64")
# 16 rays of ensemble10k_production (the 2D cut of test_torch_slice.py)
CUT_2D = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
              freqs=(2000.0, 3000.0), dtype="float64")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# with the presets' bs3 base, the landing states carry the conditioning of
# bs3's error estimate: 1e-15 math-library differences between XLA and
# PyTorch reach ~1e-8 in dt and from there the trajectory
# (test_torch_step_chunk.py). The 3D launch does the same to dopri5: its
# first attempts are tiny (dt0 = 1e-4 RE against rho ~ 1e2), so their
# embedded error estimate is rounding noise (measured: the two packages'
# dt differ by 1.6e-6 after 5 steps) and the controller carries that into
# the trajectory; statuses and counters stay identical
@pytest.mark.parametrize("name,cut,base,rtol", [
    ("ensemble10k_3d", CUT_3D, "bs3", 1e-7),
    ("ensemble10k_3d", CUT_3D, "dopri5", 1e-7),
    ("ensemble10k_production", CUT_2D, "bs3", 1e-7),
])
def test_run_matches_jax_run(name, cut, base, rtol):
    j_out = j_run.run(j_config.preset(name, base_stepper=base, **cut))
    t_out = t_run.run(t_config.preset(name, base_stepper=base, **cut),
                      device="cpu")
    n = int(t_out["valid"].sum())
    assert n == 16 and int(np.asarray(j_out["valid"]).sum()) == n
    jr, tr = j_out["result"], t_out["result"]
    for field in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, field)[:n],
                                      np.asarray(getattr(jr, field))[:n],
                                      err_msg=field)
    ju = np.asarray(jr.u)[:n]
    # per component against its largest magnitude (rho_phi and phi stay
    # at ~0 in the meridional fan)
    scale = np.abs(ju).max(axis=0)
    assert (np.abs(tr.u[:n] - ju) <= rtol * scale).all()
    np.testing.assert_allclose(tr.t[:n], np.asarray(jr.t)[:n], rtol=rtol)
    assert t_out["stats"].keys() == j_out["stats"].keys()
    for k, v in j_out["stats"].items():
        np.testing.assert_allclose(t_out["stats"][k], v, rtol=rtol, err_msg=k)
    assert int(t_out["stats"]["n_hit_earth"]) == 16


def test_3d_fan_f32_landing_accuracy_vs_f64():
    """The port's analogue of test_rounds.py::
    test_3d_fan_f32_landing_accuracy_vs_f64: an on-shell 3D chi-fan at the
    production ceilings, float32 against float64 through trace (the plain
    version of the step kernel on the CPU). Median relative landing-L
    error under 1e-4 over the rays whose statuses match."""
    from raytrace_tpu_torch.constants import RE
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import SolverConfig, trace
    from raytrace_tpu_torch.models.medium import make_env
    from raytrace_tpu_torch.ops.dispersion import consistent_rho_3d

    env = make_env(b0=3.12e-5)
    r0 = (RE + 1.0e6) / RE
    lat, chi = np.meshgrid(np.linspace(0.5, 1.05, 6), (-0.25, 0.0, 0.25),
                           indexing="ij")
    lat, chi = lat.ravel(), chi.ravel()
    c, s = np.cos(chi), np.sin(chi)
    th = torch.tensor(np.pi / 2 - lat)
    k = tuple(torch.tensor(x) for x in (c - s, s + c, np.zeros_like(c)))
    f = torch.full_like(th, 1500.0)
    rho = consistent_rho_3d(torch.full_like(th, r0), th, torch.zeros_like(th),
                            k, f, env)
    u0 = torch.stack([torch.full_like(th, r0), th, torch.zeros_like(th),
                      *rho, torch.zeros_like(th)], dim=1)
    spec = StopSpec(r_floor=1.0, t_max=5.0e9 / RE, lat_sign=-1.0,
                    lat_offset=np.pi / 2)
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, dt0=1e-4,
                       dt_max=8.0e6 / RE, ds_max=2.0e6 / RE)

    def go(dt):
        res = trace(env, u0.to(dt), f.to(dt), frame="3d", cfg=cfg,
                    spec=spec, max_steps=4096, chunk=512)
        return res.u.double().numpy(), res.status.numpy()

    u64, st64 = go(torch.float64)
    u32, st32 = go(torch.float32)
    match = st64 == st32
    assert match.mean() >= 0.8, (st64.tolist(), st32.tolist())
    hit = match & (st64 == events.HIT_EARTH)
    assert hit.sum() >= 10
    L64 = u64[hit, 0] / np.sin(u64[hit, 1]) ** 2
    L32 = u32[hit, 0] / np.sin(u32[hit, 1]) ** 2
    assert np.median(np.abs(L32 - L64) / L64) < 1e-4


NEW_PRESETS = ("ensemble10k_3d", "ensemble10k_production", "3d", "knee_3d",
               "ensemble3d", "mr_fan")


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_new_preset_json_equals_jax(name):
    t_cfg = t_config.preset(name)
    j_cfg = j_config.preset(name)
    assert json.loads(t_cfg.to_json()) == json.loads(j_cfg.to_json())
    assert t_cfg.solver() == tuple(j_cfg.solver())
    assert tuple(t_cfg.stop()) == tuple(j_cfg.stop())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_3d_launch_matches_jax(dtype):
    """The 3D launch grid and its on-shell rho. In float64 the port and
    the JAX package agree to rounding. In float32 the port solves in
    float64 from theta and f rounded to float32, then rounds; the JAX
    package under x64 promotes its float32 theta only part of the way (the
    field terms stay float32), so its rho sits up to ~2e-5 from the
    port's."""
    np_dt = np.float32 if dtype == "float32" else np.float64
    cut = dict(CUT_3D, dtype=dtype, phis=(0.0,))
    j_cfg = j_config.preset("ensemble10k_3d", **cut)
    t_cfg = t_config.preset("ensemble10k_3d", **cut)
    uj, fj = j_run._build_u0(j_cfg, np_dt)
    ut, ft = t_run._build_u0(t_cfg, t_cfg.medium.build(), np_dt,
                             torch.device("cpu"))
    assert ut.dtype == np_dt and ut.shape == uj.shape == (16, 7)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ut[:, :3], uj[:, :3])
    np.testing.assert_array_equal(ut[:, 6], uj[:, 6])
    np.testing.assert_allclose(ut[:, 3:6], uj[:, 3:6],
                               rtol=1e-14 if dtype == "float64" else 2e-5)
    # on the dispersion surface: |rho| is the local mu of the launch
    # direction, to the run dtype's rounding
    from raytrace_tpu_torch.ops.dispersion import mu_3d

    u = torch.tensor(ut.astype(np.float64))
    mu = mu_3d(*u[:, :6].unbind(1), torch.tensor(ft.astype(np.float64)),
               t_cfg.medium.build())
    np.testing.assert_allclose(u[:, 3:6].norm(dim=1).numpy(), mu.numpy(),
                               rtol=1e-14 if dtype == "float64" else 1e-6)


def test_3d_refuses_a_phis_fan():
    """A phis fan runs in 3D over the MLT-resolved medium since the plume
    slice (test_torch_slice_mlt.py) and over the tilted and IGRF fields
    (test_torch_slice_fields.py); what is refused is a phis fan under the
    reference gradient set over a field it does not take (tilted, with
    He+: ValueError, as in the JAX package) and a phis fan in a 2D frame,
    whose state carries no longitude (as the JAX package refuses it)."""
    cut = dict(lats=(0.8,), chis=(0.0,), freqs=(2000.0,), phis=(0.0, 1.0),
               max_steps=8)
    cfg = t_config.preset("ensemble10k_3d", grad_mode="reference", **cut)
    cfg.medium.b_model = "tilted"
    cfg.medium.eta_he = 0.1
    with pytest.raises(ValueError, match="centered-dipole|protons-only"):
        t_run.run(cfg, device="cpu")
    with pytest.raises(ValueError, match="3D-only"):
        t_run.run(t_config.preset("ensemble10k", **cut), device="cpu")
    with pytest.raises(ValueError, match="3D-only"):
        j_run._build_u0(j_config.preset("ensemble10k", **cut), np.float64)


def _jax_census(name, dtype, batch=1024, overrides=None, nudge=False,
                legacy=False):
    """The JAX package's run of preset `name` (with `overrides`, a dict of
    RunConfig fields) on the CPU, traced in batches of `batch` rays through
    one rounds tracer (its run() path without a mesh; a batch of at most
    64 rays in one full-budget round, as run() has it). Returns (per-ray
    numpy arrays, stats). nudge moves every launch's state slot 1 (the
    latitude or colatitude) up by one ulp: the run's own sensitivity to
    rounding. legacy passes legacy_freq_state=True to the rounds tracer
    (the 2D frames; not a RunConfig field)."""
    import raytrace_tpu.parallel.ensemble as j_ens
    from raytrace_tpu.integrate.solve import TraceResult
    from raytrace_tpu.models import cast_env
    from raytrace_tpu.parallel import ensemble_stats

    cfg = j_config.preset(name, dtype=dtype, **(overrides or {}))
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = j_run._build_u0(cfg, np_dt)
    if nudge:
        u0[:, 1] = np.nextafter(u0[:, 1], np.inf)
    kw = dict(frame=cfg.frame, cfg=cfg.solver(), spec=cfg.stop(),
              adaptive=cfg.adaptive, stepper=cfg.stepper,
              max_steps=cfg.max_steps, grad_mode=cfg.grad_mode,
              root=cfg.root, want_carry=False,
              base_stepper=cfg.base_stepper, legacy_freq_state=legacy)
    if cfg.round_steps:
        kw["round_steps"] = tuple(cfg.round_steps)
    if min(batch, u0.shape[0]) <= 64:
        kw["round_steps"] = (cfg.max_steps,)
    tracer = j_ens.make_rounds_tracer(cast_env(cfg.medium.build(), np_dt),
                                      **kw)
    cols = {k: [] for k in ("u", "status", "n_accept", "n_reject")}
    for start in range(0, u0.shape[0], batch):
        ub, fb = u0[start:start + batch], f[start:start + batch]
        res = tracer(ub, fb, np.ones(ub.shape[0], bool))
        for k in cols:
            cols[k].append(np.asarray(getattr(res, k)))
    arrays = {k: np.concatenate(v) for k, v in cols.items()}
    res = TraceResult(u=arrays["u"], t=None, status=arrays["status"],
                            n_accept=arrays["n_accept"],
                            n_reject=arrays["n_reject"])
    spec = cfg.stop()
    stats = ensemble_stats(res, np.ones(u0.shape[0], bool),
                           lat_sign=spec.lat_sign,
                           lat_offset=spec.lat_offset, xp=np)
    return arrays, {k: np.asarray(v).item() for k, v in stats.items()}


def _jax_run_census(name, dtype, overrides=None):
    """The JAX package's run() of preset `name` (with `overrides`) on the
    CPU, in one batch: (per-ray numpy arrays, stats)."""
    out = j_run.run(j_config.preset(name, dtype=dtype, **(overrides or {})))
    valid = np.asarray(out["valid"])
    arrays = {k: np.asarray(getattr(out["result"], k))[valid]
              for k in ("u", "status", "n_accept", "n_reject")}
    return arrays, {k: np.asarray(v).item() for k, v in out["stats"].items()
                    if np.asarray(v).size == 1}


def _port_run_census(name, dtype, overrides=None):
    """The port's run() of preset `name` (with `overrides`) on the CPU, its
    plain version, in one batch: (per-ray numpy arrays, stats)."""
    out = t_run.run(t_config.preset(name, dtype=dtype, **(overrides or {})),
                    device="cpu")
    valid = np.asarray(out["valid"])
    arrays = {k: np.asarray(getattr(out["result"], k))[valid]
              for k in ("u", "status", "n_accept", "n_reject")}
    return arrays, {k: np.asarray(v).item() for k, v in out["stats"].items()
                    if np.asarray(v).size == 1}


def _rays_alone(name, dtype, rays):
    """Each listed ray of preset `name` traced alone (one ray, one
    full-budget round) by the JAX package and by the port's plain version,
    both on the CPU: {ray: {"launch": ..., "jax": [status, n_accept,
    n_reject], "port": [...]}}."""
    axes = ("lats", "phis", "chis", "freqs")
    base = j_config.preset(name, dtype=dtype)
    out = {}
    for i in rays:
        idx = np.unravel_index(i, [len(getattr(base, k)) for k in axes])
        one = {k: (getattr(base, k)[j],) for k, j in zip(axes, idx)}
        res = {"jax": j_run.run(j_config.preset(name, dtype=dtype, **one)),
               "port": t_run.run(t_config.preset(name, dtype=dtype, **one),
                                 device="cpu")}
        out[i] = {"launch": {k: float(v[0]) for k, v in one.items()}}
        for pkg, r in res.items():
            out[i][pkg] = [int(np.asarray(getattr(r["result"], k))[0])
                           for k in ("status", "n_accept", "n_reject")]
    return out


if __name__ == "__main__":
    import argparse

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    p = argparse.ArgumentParser()
    p.add_argument("preset")
    p.add_argument("dtype", choices=("float32", "float64"))
    p.add_argument("--out", default="")
    p.add_argument("--against", default="")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--rays", default="",
                   help="comma-separated ray indices: trace each alone in "
                        "both packages instead of the census")
    p.add_argument("--nudge", action="store_true",
                   help="move every launch latitude up by one ulp")
    p.add_argument("--legacy", action="store_true",
                   help="trace with legacy_freq_state=True (2D frames)")
    p.add_argument("--run", action="store_true",
                   help="trace through the JAX package's run() in one "
                        "batch")
    p.add_argument("--port", action="store_true",
                   help="trace through the port's run() on the CPU (its "
                        "plain version) in one batch")
    p.add_argument("--set", action="append", default=[],
                   help="field=value: override a RunConfig field (a Python "
                        "literal)")
    args = p.parse_args()
    import ast

    over = {k: ast.literal_eval(v) for k, v in
            (item.split("=", 1) for item in args.set)}
    if args.rays:
        rays = [int(x) for x in args.rays.split(",")]
        print(json.dumps(_rays_alone(args.preset, args.dtype, rays),
                         indent=1))
        raise SystemExit(0)
    if args.port:
        arrays, stats = _port_run_census(args.preset, args.dtype, over)
    elif args.run:
        arrays, stats = _jax_run_census(args.preset, args.dtype, over)
    else:
        arrays, stats = _jax_census(args.preset, args.dtype, args.batch,
                                    over, args.nudge, args.legacy)
    if args.out:
        np.savez(args.out, **arrays)
    stats["attempted_steps"] = (stats["total_accepted_steps"]
                                + stats["total_rejected_steps"])
    if args.against:
        other = np.load(args.against)
        match = arrays["status"] == other["status"]
        hit = match & (arrays["status"] == events.HIT_EARTH)
        frame = j_config.preset(args.preset, **over).frame
        # the 2D latitude frame carries the latitude, the others colatitude
        trig = np.cos if frame == "2d_lat" else np.sin
        L = [u[hit, 0] / trig(u[hit, 1]) ** 2 for u in
             (arrays["u"].astype(np.float64), other["u"].astype(np.float64))]
        stats["status_match_vs_against"] = float(match.mean())
        stats["median_rel_landing_l_diff_vs_against"] = float(
            np.median(np.abs(L[0] - L[1]) / L[1]))
    print(json.dumps({"preset": args.preset, "dtype": args.dtype,
                      "overrides": over, "stats": stats}, indent=1))
