"""The CUDA kernels against their plain PyTorch versions on the card: the
step kernel (csrc/step_chunk.cu) and the 2D Fokker-Planck CN/CG kernel
(csrc/cn_pcg_2d.cu, `-k cn_pcg`).

Marked `gpu`: on a machine without a CUDA device every test here skips.
On the card: `python -m pytest tests/test_torch_cuda.py -m gpu -q
--noconftest` (tests/conftest.py imports jax, which a machine with only
the port need not have)."""

import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.constants import RE
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import (
    RayCarry, SolverConfig, init_carry, trace,
)
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.ops import rhs
from raytrace_tpu_torch.ops import step_chunk as sc
from raytrace_tpu_torch.run import _build_u0

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("stepper", ["bs3", "dopri5"])
def test_kernel_matches_plain_version_float64(cuda, stepper):
    env = make_env_lat()
    ens = preset("ensemble10k", dtype="float64")
    cfg, spec = ens.solver(), ens.stop()
    rng = np.random.default_rng(50)
    n = 256
    u0 = torch.tensor(np.stack([np.full(n, (RE + 1e6) / RE),
                                rng.uniform(0.45, 1.1, n),
                                rng.uniform(-0.5, 0.5, n), np.zeros(n)], 1),
                      device=cuda)
    f = torch.tensor(rng.uniform(500.0, 8000.0, n), device=cuda)
    carry = init_carry(lambda u, ff: rhs.rhs_2d_lat(u, ff, env), u0, f, cfg)
    launches = sc.step_chunk.launches
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper, n_steps=1)
    assert sc.step_chunk.launches == launches + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                                  n_steps=1)
    torch.cuda.synchronize()
    _assert_same(got, ref)


def _assert_same(got, ref):
    for name in RayCarry._fields:
        a, b = getattr(got, name).cpu(), getattr(ref, name).cpu()
        if a.dtype == torch.int32:
            assert torch.equal(a, b), name
        elif name == "u_lo":
            assert float((a - b).abs().max()) <= 1e-12
        else:
            # per component against its largest magnitude over the batch;
            # the floor keeps an all-zero column (T at launch) at 0, not NaN
            scale = b.abs().amax(dim=0) if b.dim() == 2 else b.abs()
            scale = scale.clamp_min(torch.finfo(b.dtype).tiny)
            assert float(((a - b).abs() / scale).max()) <= 1e-12, name


@pytest.mark.parametrize("name", ["ensemble10k_3d", "ensemble10k_production"])
@pytest.mark.parametrize("stepper", ["bs3", "dopri5"])
def test_kernel_with_arc_ceiling_matches_plain_version(cuda, name, stepper):
    """256 rays of the 3D launch (7-state frame, rhs_3d) and of the 2D
    production launch, one step from dt = dt_max with the arc ceiling at
    1e-4 RE, so that it sets every ray's step (the launch's arc rates are
    1/mu-small: at the presets' 2e6 m it binds only where mu < ~4)."""
    conf = preset(name, dtype="float64")
    env = conf.medium.build()
    cfg, spec = conf.solver()._replace(ds_max=1e-4), conf.stop()
    u0, f = _build_u0(conf, env, np.float64, cuda)
    u0 = torch.as_tensor(u0[::40], device=cuda)
    f = torch.as_tensor(f[::40], device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env)
    carry = init_carry(rhs_fn, u0, f, cfg)
    carry = carry._replace(dt=torch.full_like(carry.dt, cfg.dt_max))
    launches = sc.step_chunk.launches
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper, n_steps=1,
                        frame=conf.frame)
    assert sc.step_chunk.launches == launches + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                                  n_steps=1, frame=conf.frame)
    torch.cuda.synchronize()
    assert bool((ref.dt < cfg.dt_max).all())   # the ceiling bound
    _assert_same(got, ref)


def test_canonical_ray_through_the_kernel(cuda):
    res = trace(make_env_lat(),
                torch.tensor([[(RE + 1e6) / RE, np.pi / 4, 0.0, 0.0]],
                             dtype=torch.float64, device=cuda),
                torch.tensor([1000.0], dtype=torch.float64, device=cuda),
                cfg=SolverConfig(rtol=1e-7, atol=1e-12, dt0=1e-4),
                spec=StopSpec(r_floor=1.0, t_max=5e9 / RE),
                stepper="dopri5", max_steps=40000)
    assert int(res.status[0]) == events.HIT_EARTH
    u = res.u[0].cpu().numpy()
    assert abs(u[0] - 1.0) <= 1e-12
    assert abs(np.degrees(u[1]) - 2.747) <= 0.01
    assert abs(u[3] - 3.1251) <= 0.001
    assert abs(int(res.n_accept[0]) - 4135) <= 0.02 * 4135


def _assert_bitwise(got, ref):
    for name in RayCarry._fields:
        a, b = getattr(got, name).cpu(), getattr(ref, name).cpu()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        assert bool(same.all()), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("stepper", ["bs3", "dopri5"])
def test_full_medium_kernel_matches_plain_version_bitwise(cuda, dtype,
                                                          stepper):
    """Every 40th ray of the ensemble10k_plume launch (3D, the MLT-resolved
    medium: the kernel's full-medium instances with d mu/d phi), 64
    attempts: the kernel rounds as its plain version does, so every field
    agrees bit for bit."""
    conf = preset("ensemble10k_plume", dtype=dtype)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    u0 = torch.as_tensor(u0[::40], device=cuda)
    f = torch.as_tensor(f[::40], device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env)
    carry = init_carry(rhs_fn, u0, f, cfg)
    assert sc.medium_code(env) == 1
    launches = sc.step_chunk.launches
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper,
                        n_steps=64, frame="3d")
    assert sc.step_chunk.launches == launches + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                                  n_steps=64, frame="3d")
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
    assert float(got.k1[:, 5].abs().max()) > 0.0   # d mu/d phi on the path


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_full_medium_2d_kernel_matches_plain_version_bitwise(cuda, dtype):
    """The 2D frame through the full chain (GCPM, the day/night
    ionosphere and a duct), 256 rays of the knee fan x 64 bs3 attempts,
    bit for bit."""
    from raytrace_tpu_torch.models.medium import make_env

    conf = preset("knee", dtype=dtype)
    env = make_env(b0=conf.medium.b0, ps_model="gcpm", iono_mlt=True,
                   duct_amp=0.5, duct_l0=3.0, duct_w=0.1)
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    u0 = torch.as_tensor(u0[:256], device=cuda)
    f = torch.as_tensor(f[:256], device=cuda)
    carry = init_carry(lambda u, ff: rhs.rhs_2d_lat(u, ff, env), u0, f, cfg)
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3", n_steps=64)
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper="bs3",
                                  n_steps=64)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("stepper", ["bs3", "dopri5"])
@pytest.mark.parametrize("name", ["ensemble10k_tilted", "ensemble10k_igrf"])
def test_general_field_kernel_matches_plain_version_bitwise(cuda, name,
                                                            dtype, stepper):
    """Every 40th ray of the preset's launch (3D, the MLT-resolved medium
    over the tilted dipole or the IGRF truncation: the kernel's
    general-field instances), 64 attempts: asin, atan2 and sqrt are the
    card's own in both, so every field agrees bit for bit."""
    conf = preset(name, dtype=dtype)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    u0 = torch.as_tensor(u0[::40], device=cuda)
    f = torch.as_tensor(f[::40], device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env)
    carry = init_carry(rhs_fn, u0, f, cfg)
    assert sc.medium_code(env) == 1 and sc.field_code(env) > 0
    launches = sc.step_chunk.launches
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper,
                        n_steps=64, frame="3d")
    assert sc.step_chunk.launches == launches + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                                  n_steps=64, frame="3d")
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
    assert float(got.k1[:, 5].abs().max()) > 0.0   # d mu/d phi on the path


@pytest.mark.parametrize("name", ["ensemble10k_tilted", "ensemble10k_igrf"])
def test_field_presets_run_through_the_kernel(cuda, name):
    """run.run of a cut of each preset on the card: every round a kernel
    launch, the plain version never called, every ray finite and
    stopped."""
    from raytrace_tpu_torch.run import run

    conf = preset(name, lats=(0.7, 0.85, 1.0, 1.1), chis=(-0.2, 0.2),
                  freqs=(1000.0, 2000.0, 4000.0))
    sc.step_chunk.launches = 0
    sc.step_chunk_reference.calls = 0
    out = run(conf, device="cuda")
    assert sc.step_chunk.launches > 0
    assert sc.step_chunk_reference.calls == 0
    assert int(out["valid"].sum()) == 4 * 8 * 2 * 3
    assert np.isfinite(out["result"].u[out["valid"]]).all()
    assert int(out["stats"]["n_active"]) == 0
    assert int(out["stats"]["n_hit_earth"]) > 0


# the last variants of the step: (preset, overrides, stepper, medium
# overrides); rk4 runs at the reference ceiling dt0 = 1e6 m
VARIANTS = {
    "local": ("ensemble10k_local", {}, "bs3", {}),
    "local_tilted": ("ensemble10k_tilted", dict(ds_local=True), "dopri5",
                     {}),
    "colat": ("ensemble10k", dict(frame="2d_colat"), "dopri5", {}),
    "colat_full": ("ensemble10k", dict(frame="2d_colat"), "bs3",
                   dict(ps_model="gcpm", iono_mlt=True, duct_amp=0.5)),
    "emic": ("emic_heband", {}, "dopri5", {}),
    "multi_ion_whistler": ("ensemble10k", {}, "dopri5",
                           dict(eta_he=0.1, eta_o=0.02)),
    "multi_ion_igrf": ("ensemble10k_igrf", {}, "bs3",
                       dict(eta_he=0.1, eta_o=0.02)),
    "rk4": ("ensemble10k", dict(adaptive=False, dt0=1.0e6 / RE), "bs3", {}),
    "rk4_plume": ("ensemble10k_plume", dict(adaptive=False, dt0=1.0e-3),
                  "bs3", {}),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_variant_kernel_matches_plain_version_bitwise(cuda, case, dtype):
    """Every 40th ray of each launch (the emic_heband launch whole), 64
    attempts through the kernel's instances of the local arc ceiling, the
    colatitude frame, the multi-ion medium at either root and fixed-step
    rk4: every field bit for bit with the plain version."""
    name, over, stepper, med = VARIANTS[case]
    conf = preset(name, dtype=dtype, **over)
    for k, v in med.items():
        setattr(conf.medium, k, v)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    every = 1 if name == "emic_heband" else 40
    u0 = torch.as_tensor(u0[::every], device=cuda)
    f = torch.as_tensor(f[::every], device=cuda)
    carry = init_carry(rhs.frame_rhs(conf.frame, env, conf.root)[0], u0, f,
                       cfg)
    kw = dict(stepper=stepper, n_steps=64, root=conf.root,
              adaptive=conf.adaptive, frame=conf.frame)
    launches = sc.step_chunk.launches
    got = sc.step_chunk(carry, f, env, cfg, spec, **kw)
    assert sc.step_chunk.launches == launches + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, **kw)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
    assert int((got.n_accept + got.n_reject).sum()) > 0


@pytest.mark.parametrize("name,over", [
    ("raymain", {}), ("emic_heband", dict(max_steps=512)),
    ("ensemble10k_local", dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
                               freqs=(2000.0, 3000.0))),
])
def test_variant_presets_run_through_the_kernel(cuda, name, over):
    """run.run of each preset of the variants (cut where it is a fan) on
    the card: every round a kernel launch, the plain version never
    called, every ray finite."""
    from raytrace_tpu_torch.run import run

    sc.step_chunk.launches = 0
    sc.step_chunk_reference.calls = 0
    out = run(preset(name, **over), device="cuda")
    assert sc.step_chunk.launches > 0
    assert sc.step_chunk_reference.calls == 0
    assert np.isfinite(out["result"].u[out["valid"]]).all()
    assert int(out["stats"]["n_active"]) == 0


# the team body (one ray across four warps): the 3D full chain over the
# dipole, in float and double, each stepper, and over the non-axial fields
# its float bs3 instance (every other instance keeps the one-thread body)
TEAM_INSTANCES = [("ensemble10k_plume", "float32", "bs3"),
                  ("ensemble10k_plume", "float64", "bs3"),
                  ("ensemble10k_plume", "float64", "dopri5"),
                  ("ensemble10k_plume", "float32", "rk4"),
                  ("ensemble10k_tilted", "float32", "bs3"),
                  ("ensemble10k_igrf", "float32", "bs3")]


def _team_launch(cuda, name, dtype, stepper, case):
    """(carry, f, env, cfg, spec, kw, n_steps) of one edge case of the team
    layout over the preset's launch: B = 1, 31, 33 or 10,240 rays; rays
    that retire at different attempts (the ceiling r_ceil 3% above the
    launch radius); rays stopped at entry; n_steps = 0; and a merged
    tail's shape (5 rays padded to a 256-lane bucket with copies of the
    first, as parallel/ensemble.py pads it). rk4 runs at dt0 = 1e6 m."""
    over = dict(adaptive=False, dt0=1.0e6 / RE) if stepper == "rk4" else {}
    conf = preset(name, dtype=dtype, **over)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    rows = {"b1": [4000], "b31": np.arange(31) * 300,
            "b33": np.arange(33) * 300, "b10240": np.arange(u0.shape[0]),
            "retire": np.arange(0, u0.shape[0], 40),
            "inactive": np.arange(0, u0.shape[0], 40),
            "zero": np.arange(0, u0.shape[0], 40),
            "tail": np.concatenate([np.arange(5) * 1900,
                                    np.zeros(251, np.int64)])}[case]
    u0 = torch.as_tensor(u0[rows], device=cuda)
    f = torch.as_tensor(f[rows], device=cuda)
    carry = init_carry(rhs.frame_rhs(conf.frame, env)[0], u0, f, cfg)
    if case == "retire":
        spec = spec._replace(r_ceil=float(u0[:, 0].max()) * 1.03)
    if case == "inactive":
        status = carry.status.clone()
        status[::3] = events.HIT_EARTH
        status[1::5] = events.DT_UNDERFLOW
        carry = carry._replace(status=status)
    n_steps = {"zero": 0, "b10240": 32, "tail": 512}.get(case, 256)
    kw = dict(stepper="bs3" if stepper == "rk4" else stepper,
              adaptive=conf.adaptive, frame=conf.frame)
    return carry, f, env, cfg, spec, kw, n_steps


@pytest.mark.parametrize("case", ["b1", "b31", "b33", "b10240", "retire",
                                  "inactive", "zero", "tail"])
@pytest.mark.parametrize("name,dtype,stepper", TEAM_INSTANCES)
def test_team_body_edges_match_plain_version_bitwise(cuda, name, dtype,
                                                     stepper, case):
    """The team body's instances at the edges of its layout (a block of
    four warps serving 32 rays: warp 0 steps them, three helpers compute
    the pieces of each right-hand side; a lane with no ray, a ray that is
    done and a pad lane ride along and take every barrier): every field
    bit for bit with the plain version."""
    carry, f, env, cfg, spec, kw, n = _team_launch(cuda, name, dtype,
                                                   stepper, case)
    codes = (0 if dtype == "float32" else 1, sc._STEPPER_CODE[stepper],
             sc._FRAME_CODE[kw["frame"]][0], sc.medium_code(env, cfg),
             sc.field_code(env))
    assert sc.team_warps(*codes) > 0
    # over the non-axial fields the team body runs the launches of the tail
    # layout (at most layout_limit(True) rays), the one-thread body the
    # wider ones
    on_team = (not sc.tail_layout(*codes)
               or f.shape[0] <= sc.layout_limit(True))
    team = sc.step_chunk.team_launches
    got = sc.step_chunk(carry, f, env, cfg, spec, n_steps=n, **kw)
    assert sc.step_chunk.team_launches == team + on_team
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, n_steps=n, **kw)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
    made = (got.n_accept + got.n_reject) - (carry.n_accept + carry.n_reject)
    live = carry.status == events.ACTIVE
    if case == "zero":
        assert int(made.abs().sum()) == 0
    else:
        assert int(made[live].min()) > 0
        assert int(made[~live].abs().sum()) == 0
    if case == "retire":   # the rays of a team stop at different attempts
        stopped = made[got.status == events.ESCAPED]
        assert stopped.numel() > 1 and int(stopped.min()) < int(stopped.max())
    if case == "tail":     # every pad lane is its first ray, bit for bit
        for field in RayCarry._fields:
            x = getattr(got, field)[5:]
            assert bool((x == getattr(got, field)[:1]).all()), field


def test_team_body_takes_the_measured_instances(cuda):
    """The body of each instance is the kernel source's compile-time
    choice: the 3D full chain over the dipole in every instance and over
    the non-axial fields in the float bs3 one, no other frame or
    medium."""
    for dtype in (0, 1):
        for stepper in (0, 1, 2):
            for frame in (0, 1, 2):
                for medium in (0, 1, 2):
                    for field in ((0, 1, 2) if frame == 1 and medium else
                                  (0,)):
                        team = sc.team_warps(dtype, stepper, frame, medium,
                                             field)
                        want = frame == 1 and medium == 1 and (
                            field == 0 or (dtype, stepper) == (0, 0))
                        assert team == (4 if want else 0), (
                            dtype, stepper, frame, medium, field)
                        # the tail layout: the 2D chain instances (one ray
                        # a warp) and the general-field team instances
                        layout = (dtype, stepper, medium, field) == (
                            0, 0, 0, 0) and frame != 1 or (want and field)
                        assert sc.tail_layout(dtype, stepper, frame, medium,
                                              field) == bool(layout)


# the media of the team body's density pieces (ne_head, ne_lterms,
# ne_tail) beside the plume's: GCPM and the smoothed plasmapause with the
# per-L trough refill, each with the day/night ionosphere and the duct,
# without and with the MLT-resolved plasmapause; a constant refill with the
# DE factor; no plasmasphere
_DUCT = dict(iono_mlt=True, duct_amp=0.5, duct_l0=3.0, duct_w=0.1)
TEAM_MEDIA = {
    "gcpm": dict(ps_model="gcpm", **_DUCT),
    "gcpm_mlt": dict(ps_model="gcpm", ps_mlt=True, **_DUCT),
    "smooth": dict(ps_smooth=0.05, ps_refill=0.5, ps_refill_q=4.0, **_DUCT),
    "smooth_mlt": dict(ps_smooth=0.05, ps_refill=0.5, ps_refill_q=4.0,
                       ps_mlt=True, **_DUCT),
    "refill_de": dict(ps_refill=0.5, de_correction=True, ps_mlt=True),
    "no_ps": dict(plasmasphere=False, iono_mlt=True),
}


@pytest.mark.parametrize("dtype,stepper", [("float32", "bs3"),
                                           ("float64", "dopri5")])
@pytest.mark.parametrize("medium", sorted(TEAM_MEDIA))
def test_team_body_media_match_plain_version_bitwise(cuda, medium, dtype,
                                                     stepper):
    """Every 10th ray of the plume fan over each medium of TEAM_MEDIA
    through the team body, 256 attempts: every branch of its density
    pieces agrees with the plain version bit for bit."""
    from raytrace_tpu_torch.config import MediumConfig
    from raytrace_tpu_torch.constants import B0_3D

    conf = preset("ensemble10k_plume", dtype=dtype,
                  medium=MediumConfig(b0=B0_3D, **TEAM_MEDIA[medium]))
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    u0 = torch.as_tensor(u0[::10], device=cuda)
    f = torch.as_tensor(f[::10], device=cuda)
    carry = init_carry(rhs.frame_rhs(conf.frame, env)[0], u0, f, cfg)
    codes = (0 if dtype == "float32" else 1, sc._STEPPER_CODE[stepper],
             sc._FRAME_CODE["3d"][0], sc.medium_code(env, cfg),
             sc.field_code(env))
    assert sc.team_warps(*codes) > 0
    team = sc.step_chunk.team_launches
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper,
                        n_steps=256, frame="3d")
    assert sc.step_chunk.team_launches == team + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                                  n_steps=256, frame="3d")
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
    made = (got.n_accept + got.n_reject) - (carry.n_accept + carry.n_reject)
    assert int(made.min()) > 0   # every ray stepped


# the non-axial fields of the general-field team body's presets
TEAM_FIELDS = {"tilted": dict(b_model="tilted", b_tilt=0.2, b_tilt_phi=0.5),
               "igrf": dict(b_model="igrf")}


@pytest.mark.parametrize("medium", sorted(TEAM_MEDIA) + ["ca1992"])
@pytest.mark.parametrize("field", sorted(TEAM_FIELDS))
def test_general_team_body_media_match_plain_version_bitwise(cuda, field,
                                                             medium):
    """Every 40th ray of the field's fan (256 rays: the tail layout) over
    each medium of TEAM_MEDIA and the axisymmetric CA1992 (the chain rule
    through the magnetic latitude alone) through the general-field team
    body, float32 bs3, 256 attempts: bit for bit with the plain
    version."""
    from raytrace_tpu_torch.config import MediumConfig
    from raytrace_tpu_torch.constants import B0_3D

    conf = preset(f"ensemble10k_{field}", dtype="float32",
                  medium=MediumConfig(b0=B0_3D, **TEAM_FIELDS[field],
                                      **TEAM_MEDIA.get(medium, {})))
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    u0, f = _build_u0(conf, env, np.float32, cuda)
    u0 = torch.as_tensor(u0[::40], device=cuda)
    f = torch.as_tensor(f[::40], device=cuda)
    carry = init_carry(rhs.frame_rhs(conf.frame, env)[0], u0, f, cfg)
    codes = (0, sc._STEPPER_CODE["bs3"], sc._FRAME_CODE["3d"][0],
             sc.medium_code(env, cfg), sc.field_code(env))
    assert codes[3:] == (sc.FULL, 1 if field == "tilted" else 2)
    assert sc.team_warps(*codes) == 4 and sc.tail_layout(*codes)
    assert f.shape[0] <= sc.layout_limit(True)
    team = sc.step_chunk.team_launches
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3",
                        n_steps=256, frame="3d")
    assert sc.step_chunk.team_launches == team + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper="bs3",
                                  n_steps=256, frame="3d")
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
    made = (got.n_accept + got.n_reject) - (carry.n_accept + carry.n_reject)
    assert int(made.min()) > 0   # every ray stepped


# the ALT instances (the reference scripts' modes over the axisymmetric
# medium): each frame with its modes, each stepper (rk4: adaptive=False)
ALT_FRAMES = {
    "2d_lat": ("ensemble10k", {}, dict(grad_mode="reference",
                                       legacy_freq_state=True)),
    "2d_colat": ("ensemble10k", dict(frame="2d_colat"),
                 dict(grad_mode="reference", legacy_freq_state=True)),
    "3d": ("ensemble10k_3d", {}, dict(grad_mode="reference")),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("stepper", ["bs3", "dopri5", "rk4"])
@pytest.mark.parametrize("frame", sorted(ALT_FRAMES))
def test_alt_kernel_matches_plain_version_bitwise(cuda, frame, stepper,
                                                  dtype):
    """Every 40th ray of the launch, 64 attempts through each of the 18
    ALT instances (grad_mode="reference" with legacy_freq_state in the 2D
    frames): every field bit for bit with the plain version; and the
    2D frames' legacy alone and the reference set alone through the same
    instances."""
    name, over, modes = ALT_FRAMES[frame]
    if stepper == "rk4":
        over = dict(over, adaptive=False, dt0=1.0e6 / RE)
    conf = preset(name, dtype=dtype, **over)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    u0 = torch.as_tensor(u0[::40], device=cuda)
    f = torch.as_tensor(f[::40], device=cuda)
    runs = [modes]
    if frame != "3d":
        runs += [dict(grad_mode="reference"), dict(legacy_freq_state=True)]
    for m in runs:
        assert sc.medium_code(env, cfg, **m) == sc.ALT
        fn = rhs.frame_rhs(conf.frame, env, conf.root, **m)[0]
        carry = init_carry(fn, u0, f, cfg)
        kw = dict(stepper="bs3" if stepper == "rk4" else stepper,
                  n_steps=64, root=conf.root, adaptive=conf.adaptive,
                  frame=conf.frame, **m)
        launches = sc.step_chunk.launches
        got = sc.step_chunk(carry, f, env, cfg, spec, **kw)
        assert sc.step_chunk.launches == launches + 1
        ref = sc.step_chunk_reference(carry, f, env, cfg, spec, **kw)
        torch.cuda.synchronize()
        _assert_bitwise(got, ref)
        assert int((got.n_accept + got.n_reject).sum()) > 0


def test_reference_modes_run_through_the_kernel(cuda):
    """run.run in reference mode (cut fans of ensemble10k and
    ensemble10k_3d) and the canonical ray through trace() in reference +
    legacy mode on the card: every launch through the kernel, the plain
    version never called, every ray finite."""
    from raytrace_tpu_torch.run import run

    cut = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
               freqs=(2000.0, 3000.0), grad_mode="reference")
    for name in ("ensemble10k", "ensemble10k_3d"):
        sc.step_chunk.launches = 0
        sc.step_chunk_reference.calls = 0
        out = run(preset(name, **cut), device="cuda")
        assert sc.step_chunk.launches > 0
        assert sc.step_chunk_reference.calls == 0
        assert np.isfinite(out["result"].u[out["valid"]]).all()
    u0 = torch.tensor([[(RE + 1e6) / RE, np.pi / 4, 0.0, 0.0]],
                      dtype=torch.float64, device=cuda)
    res = trace(make_env_lat(), u0,
                torch.tensor([1000.0], dtype=torch.float64, device=cuda),
                cfg=SolverConfig(rtol=1e-9, atol=1e-14, dt0=1e-4),
                spec=StopSpec(r_floor=1.0, t_max=2e8 / RE), stepper="dopri5",
                max_steps=100000, chunk=256, grad_mode="reference",
                legacy_freq_state=True)
    assert int(res.status[0]) == events.MAX_PHASE_TIME
    assert int(res.n_accept[0]) == 205


# the ALTX instances (the modes over the full and extended media): the
# reference set over the MLT plume in 3D, the modes over GCPM with the duct
# and the day/night ionosphere in the 2D frames
_GCPM_2D = dict(ps_model="gcpm", iono_mlt=True, duct_amp=0.5, duct_l0=3.0,
                duct_w=0.1)
ALTX_FRAMES = {
    "2d_lat": ("ensemble10k", dict(medium_kw=_GCPM_2D),
               dict(grad_mode="reference", legacy_freq_state=True)),
    "2d_colat": ("ensemble10k", dict(frame="2d_colat", medium_kw=_GCPM_2D),
                 dict(grad_mode="reference", legacy_freq_state=True)),
    "3d": ("ensemble10k_plume", {}, dict(grad_mode="reference")),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("stepper", ["bs3", "dopri5", "rk4"])
@pytest.mark.parametrize("frame", sorted(ALTX_FRAMES))
def test_altx_kernel_matches_plain_version_bitwise(cuda, frame, stepper,
                                                   dtype):
    """Every 40th ray of the launch, 64 attempts through each of the 18
    ALTX instances: every field bit for bit with the plain version; in
    the 2D frames legacy alone and the reference set alone too, and the
    local arc ceiling (ensemble10k_local) and He+ and O+ under legacy
    through the 2D latitude instances."""
    name, over, modes = ALTX_FRAMES[frame]
    over = dict(over)
    med = over.pop("medium_kw", None)
    if stepper == "rk4":
        over = dict(over, adaptive=False,
                    dt0=1.0e-3 if frame == "3d" else 1.0e6 / RE)
    conf = preset(name, dtype=dtype, **over)
    for k, v in (med or {}).items():
        setattr(conf.medium, k, v)
    cases = [(conf, modes)]
    if frame != "3d":
        cases += [(conf, dict(grad_mode="reference")),
                  (conf, dict(legacy_freq_state=True))]
    if frame == "2d_lat" and stepper != "rk4":
        ions = preset("ensemble10k", dtype=dtype)
        ions.medium.eta_he, ions.medium.eta_o = 0.1, 0.02
        cases += [(preset("ensemble10k_local", dtype=dtype),
                   dict(grad_mode="reference")),
                  (ions, dict(legacy_freq_state=True))]
    np_dt = np.float32 if dtype == "float32" else np.float64
    for c, m in cases:
        env = c.medium.build()
        cfg, spec = c.solver(), c.stop()
        assert sc.medium_code(env, cfg, **m) == sc.ALTX
        u0, f = _build_u0(c, env, np_dt, cuda)
        u0 = torch.as_tensor(u0[::40], device=cuda)
        f = torch.as_tensor(f[::40], device=cuda)
        fn = rhs.frame_rhs(c.frame, env, c.root, **m)[0]
        carry = init_carry(fn, u0, f, cfg)
        kw = dict(stepper="bs3" if stepper == "rk4" else stepper,
                  n_steps=64, root=c.root, adaptive=c.adaptive,
                  frame=c.frame, **m)
        launches = sc.step_chunk.launches
        got = sc.step_chunk(carry, f, env, cfg, spec, **kw)
        assert sc.step_chunk.launches == launches + 1
        ref = sc.step_chunk_reference(carry, f, env, cfg, spec, **kw)
        torch.cuda.synchronize()
        _assert_bitwise(got, ref)
        assert int((got.n_accept + got.n_reject).sum()) > 0


def test_modes_over_full_media_run_through_the_kernel(cuda):
    """run.run with grad_mode="reference" over cut fans of
    ensemble10k_plume and ensemble10k_local: every launch through the
    kernel, the plain version never called, every ray finite."""
    from raytrace_tpu_torch.run import run

    for name, cut in (
        ("ensemble10k_plume", dict(lats=(0.8, 1.0), phis=(0.0, 2.0),
                                   chis=(0.3,), freqs=(2000.0, 3000.0))),
        ("ensemble10k_local", dict(lats=(0.8, 0.9, 1.0, 1.1),
                                   chis=(0.3, 0.5), freqs=(2000.0,))),
    ):
        sc.step_chunk.launches = 0
        sc.step_chunk_reference.calls = 0
        out = run(preset(name, grad_mode="reference", **cut), device="cuda")
        assert sc.step_chunk.launches > 0
        assert sc.step_chunk_reference.calls == 0
        assert np.isfinite(out["result"].u[out["valid"]]).all()


def test_sensitivity_graph_matches_eager_on_the_card(cuda):
    """trace_rhs over the variational system: the CUDA graph of one attempt
    replayed gives the eager loop's carry bit for bit (16 attempts of the
    canonical ray's 4 + 16-state system, float64), and
    landing_sensitivity_batch runs on the card."""
    from raytrace_tpu_torch.integrate.solve import trace_rhs
    from raytrace_tpu_torch.sensitivity import (
        landing_sensitivity_batch, make_variational_rhs,
    )

    fn = rhs.frame_rhs("2d_lat", make_env_lat())[0]
    u0 = np.array([(RE + 1e6) / RE, np.pi / 4, 0.0, 0.0])
    ua0 = torch.cat([torch.tensor(u0), torch.eye(4).reshape(16)]).to(
        cuda, torch.float64)[None]
    f = torch.tensor([1000.0], dtype=torch.float64, device=cuda)
    kw = dict(cfg=SolverConfig(rtol=1e-9, atol=1e-13),
              spec=StopSpec(r_floor=1.0, t_max=5e9 / RE), max_steps=16,
              chunk=16)
    aug = make_variational_rhs(fn, 4)
    a = trace_rhs(aug, ua0, f, graph=False, **kw)
    b = trace_rhs(aug, ua0, f, graph=True, **kw)
    for x, y in zip(a.carry, b.carry):
        assert torch.equal(x, y)
    out = landing_sensitivity_batch(
        fn, np.stack([u0, u0]), np.array([1000.0, 2000.0]),
        spec=StopSpec(r_floor=1.0, t_max=3.0), device=cuda)
    assert np.isfinite(out["jac"]).all()


def test_tier_loops_graph_matches_eager_on_the_card(cuda):
    """evolve_cn and precipitation_lifetime through their CUDA graphs (one
    CN step, one inverse iteration replayed by integrate.graph.GraphLoop)
    give the eager loop's values bit for bit, float64, a batch of two."""
    from raytrace_tpu_torch import fokker_planck as fp
    from raytrace_tpu_torch import radial

    grid = radial.make_l_grid(1.6, 6.4, 48, device=cuda)
    dll = radial.dll_power_law(grid[1], d0=3e-8)
    f0 = torch.stack([torch.zeros(48, dtype=torch.float64, device=cuda),
                      torch.linspace(0.0, 1.0, 48, dtype=torch.float64,
                                     device=cuda)])
    runs = [radial.evolve_radial(f0, *grid[:3], dll, dt=1e4, n_steps=50,
                                 save_every=20, graph=g) for g in (False, True)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    a_lc = 0.2
    centers = fp.make_grid(a_lc, 32, cuda)[0]
    daa = torch.stack([1e-4 * torch.cos(centers) ** 2, 1e-3 + 0 * centers])
    taus = [fp.precipitation_lifetime(daa, a_lc, n_cells=32, n_iter=24,
                                      graph=g) for g in (False, True)]
    assert torch.equal(*taus)
    assert torch.isfinite(taus[0]).all()


def _plain_trajectory(carry, f, env, cfg, spec, kw, n_outer, save_every,
                      save_fn):
    """trace's trajectory channel through the plain version: a snapshot
    after each block of save_every attempts, the extras over all
    snapshots in one call, the final carry relabelled and refined."""
    from raytrace_tpu_torch.integrate.solve import refine_events

    rows = {"u": [], "t": [], "status": []}
    for _ in range(n_outer):
        carry = sc.step_chunk_reference(carry, f, env, cfg, spec,
                                        n_steps=save_every, **kw)
        for k in rows:
            rows[k].append(getattr(carry, k))
    traj = {k: torch.stack(v) for k, v in rows.items()}
    b, n = carry.u.shape
    traj["extras"] = save_fn(traj["u"].reshape(-1, n),
                             f.repeat(n_outer)).reshape(n_outer, b, -1)
    carry = carry._replace(status=torch.where(
        carry.status == events.ACTIVE, events.MAX_STEPS, carry.status
    ).to(torch.int32))
    rhs_fn, _ = rhs.frame_rhs(kw["frame"], env)
    return traj, refine_events(rhs_fn, carry, f, spec)


@pytest.mark.parametrize("name,every,n_outer", [
    ("ensemble10k", 40, 24), ("ensemble10k_plume", 40, 8),
])
def test_trajectory_through_the_kernel_matches_plain_version_bitwise(
        cuda, name, every, n_outer):
    """trace(save_every=32, save_fn) on the card -- one kernel launch per
    block on the resident field-major carry -- against the plain version's
    blocks: every snapshot, the extras and the final carry bit for bit
    (the 2D one-thread instance and the 3D team instance, float32 bs3)."""
    from raytrace_tpu_torch.integrate.saving import save_fn_for

    conf = preset(name)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    u0, f = _build_u0(conf, env, np.float32, cuda)
    u0 = torch.as_tensor(u0[::every], device=cuda)
    f = torch.as_tensor(f[::every], device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env)
    carry = init_carry(rhs_fn, u0, f, cfg)
    kw = dict(stepper="bs3", frame=conf.frame)
    save_fn = save_fn_for(conf.frame, env)
    launches = sc.step_chunk.launches
    res = trace(env, u0, f, carry0=carry, cfg=cfg, spec=spec,
                max_steps=32 * n_outer, save_every=32, save_fn=save_fn, **kw)
    assert 0 < sc.step_chunk.launches - launches <= n_outer
    traj, final = _plain_trajectory(carry, f, env, cfg, spec, kw, n_outer,
                                    32, save_fn)
    torch.cuda.synchronize()
    for k, v in traj.items():
        a, b = res.traj[k].cpu(), v.cpu()
        assert a.shape == b.shape, k
        assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()), k
    _assert_bitwise(res.carry, final)


# (preset, dtype, stepper, every, m, n, B): a launch with finish and fresh
# after m attempts of the kernel, where some of the fan's rays land; the
# team body also at 33 rays (a lane with no ray and a ray alone in its
# team)
FINISH = [
    ("ensemble10k", "float32", "bs3", 10, 1984, 64, None),
    ("ensemble10k_3d", "float64", "bs3", 10, 160, 64, None),
    ("ensemble10k_plume", "float32", "bs3", 10, 192, 64, None),
    ("ensemble10k_plume", "float64", "dopri5", 10, 160, 32, 33),
]


@pytest.mark.parametrize("name,dtype,stepper,every,m,n,b", FINISH)
def test_finish_and_fresh_match_plain_version_bitwise(cuda, name, dtype,
                                                      stepper, every, m, n,
                                                      b):
    """A launch with finish (refine_events after the loop) and fresh
    (init_carry's right-hand side before it), on a carry with NaN in k1,
    against the plain path on the same carry: k1 = rhs(u),
    step_chunk_reference, refine_events; every field bit for bit, with
    rays refined that retired before the launch and rays that landed in
    it."""
    from raytrace_tpu_torch.integrate.solve import refine_events

    conf = preset(name, dtype=dtype)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    u0 = torch.as_tensor(u0[::every][:b], device=cuda)
    f = torch.as_tensor(f[::every][:b], device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env)
    kw = dict(stepper=stepper, frame=conf.frame)
    mid = sc.step_chunk(init_carry(rhs_fn, u0, f, cfg), f, env, cfg, spec,
                        n_steps=m, **kw)
    mid = RayCarry(*(x.clone() for x in mid))
    finish = sc.step_chunk.finish_launches
    got = sc.step_chunk(mid._replace(k1=torch.full_like(mid.k1, np.nan)), f,
                        env, cfg, spec, n_steps=n, finish=True, fresh=True,
                        **kw)
    assert sc.step_chunk.finish_launches == finish + 1
    ref = sc.step_chunk_reference(mid._replace(k1=rhs_fn(mid.u, f)), f, env,
                                  cfg, spec, n_steps=n, **kw)
    ref = refine_events(rhs_fn, ref, f, spec)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
    before = mid.status == events.HIT_EARTH
    assert bool(before.any())
    assert bool(((got.status == events.HIT_EARTH) & ~before).any())


def test_trace_refines_in_the_launch_on_the_card(cuda, monkeypatch):
    """A final-states trace on a kernel pool neither forms init_carry's
    right-hand side nor runs refine_events on the host: one launch with
    finish and fresh, and the canonical ray lands at r = 1."""
    from raytrace_tpu_torch.integrate import solve

    def refuse(*args, **kw):
        raise AssertionError("refine_events ran on the host")

    monkeypatch.setattr(solve, "refine_events", refuse)
    init = solve.init_carry
    monkeypatch.setattr(solve, "init_carry", lambda rhs_fn, *a: (
        init(rhs_fn, *a) if rhs_fn is None else refuse()))
    counts = (sc.step_chunk.launches, sc.step_chunk.finish_launches,
              sc.step_chunk.fresh_launches)
    u0 = torch.tensor([[(RE + 1.0e6) / RE, np.pi / 4, 0.0, 0.0]],
                      dtype=torch.float64, device=cuda)
    res = trace(make_env_lat(), u0,
                torch.tensor([1000.0], dtype=torch.float64, device=cuda),
                cfg=SolverConfig(rtol=1e-7, atol=1e-12, dt0=1e-4),
                spec=StopSpec(r_floor=1.0, t_max=5e9 / RE),
                stepper="dopri5", max_steps=40000)
    assert (sc.step_chunk.launches, sc.step_chunk.finish_launches,
            sc.step_chunk.fresh_launches) == tuple(c + 1 for c in counts)
    assert int(res.status[0]) == events.HIT_EARTH
    assert abs(float(res.u[0, 0]) - 1.0) <= 1e-12


def test_rounds_trajectory_matches_single_program_on_the_card(cuda):
    """The rounds tracer's assembled trajectory (buckets, the packed float
    transport, the host scatter and forward fill) against the
    single-program tracer's, every 40th ray of ensemble10k in float32
    with a pinned bs3 and no stall retirement: bit for bit."""
    from raytrace_tpu_torch.integrate.saving import save_fn_for
    from raytrace_tpu_torch.parallel.ensemble import (
        make_ensemble_tracer, make_rounds_tracer, pad_batch,
    )

    conf = preset("ensemble10k")
    env = conf.medium.build()
    u0, f = _build_u0(conf, env, np.float32, cuda)
    u0, f, valid = pad_batch(u0[::40], f[::40])
    kw = dict(device=cuda, dtype=torch.float32, cfg=conf.solver(),
              spec=conf.stop(), stepper="bs3", max_steps=4096,
              save_every=32, save_fn=save_fn_for("2d_lat", env))
    tracer = make_rounds_tracer(env, round_steps=(512, 512, 256),
                                bucket_floor=8, stall_progress=0.0,
                                want_carry=False, **kw)
    rounds = tracer(u0, f, valid)
    single = make_ensemble_tracer(env, **kw)(u0, f)
    assert len({r["bucket"] for r in tracer.last_rounds}) >= 2
    for k, v in single.traj.items():
        a, b = rounds.traj[k][:, valid], v.cpu().numpy()[:, valid]
        assert a.shape == b.shape == (4096 // 32,) + b.shape[1:], k
        assert ((a == b) | (np.isnan(a) & np.isnan(b))).all(), k
    np.testing.assert_array_equal(rounds.u[valid],
                                  single.u.cpu().numpy()[valid])


# ---- the 2D Fokker-Planck CN/CG kernel (csrc/cn_pcg_2d.cu) ---------------

def _fp2d_case(cuda, dtype, na=20, npp=23, seed=31, loss_cone="absorbing"):
    from raytrace_tpu_torch import fokker_planck_2d as fp2

    rng = np.random.default_rng(seed)
    a11 = rng.uniform(0.3, 3.0, (na, npp))
    a22 = rng.uniform(0.3, 3.0, (na, npp))
    a12 = rng.uniform(-0.95, 0.95, (na, npp)) * np.sqrt(a11 * a22)
    g = fp2.make_grid_2d(np.radians(8.0), na, 0.5, 4.0, npp)
    op = fp2.make_operator_2d(g, *(torch.tensor(a, device=cuda).to(dtype)
                                   for a in (a11, a12, a22)),
                              loss_cone=loss_cone)
    f0 = torch.tensor(rng.uniform(0.5, 1.5, (na, npp)), device=cuda).to(dtype)
    return fp2, op, f0


@pytest.mark.parametrize("dtype,tol,dcount", [(torch.float64, 1e-12, 1),
                                              (torch.float32, 1e-5, 3)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("loss_cone", ["absorbing", "reflecting"])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16],
                         ids=["auto", "c1", "c2", "c4", "c8", "c16"])
def test_cn_pcg_kernel_matches_plain_version(cuda, dtype, tol, dcount,
                                             loss_cone, cluster):
    """The evolution at the layout the wrapper picks (auto, through
    evolve_cn_2d) and at every cluster size it can pick."""
    from raytrace_tpu_torch.ops import cn_pcg_2d as cg

    fp2, op, f0 = _fp2d_case(cuda, dtype, loss_cone=loss_cone)
    launches = cg.cn_pcg_2d.launches
    if cluster is None:
        got, snaps = fp2.evolve_cn_2d(f0, op, 0.05, 23, save_every=5)
        it_k = fp2.evolve_cn_2d.cg_iterations.cpu()
    else:
        got, snaps, it_k = cg.cn_pcg_2d(f0, op, 0.05, 23, 5,
                                        fp2.default_cg_tol(dtype), 500,
                                        cluster)
        assert cg.cn_pcg_2d.last_layout.cluster == cluster
        it_k = it_k.cpu()
    assert cg.cn_pcg_2d.launches == launches + 1
    want, ref = fp2.evolve_cn_2d_reference(f0, op, 0.05, 23, save_every=5)
    it_p = fp2.evolve_cn_2d.cg_iterations.cpu()
    torch.cuda.synchronize()
    assert snaps.shape == (4,) + tuple(f0.shape)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale
    assert float((snaps - ref).abs().max()) <= tol * scale
    assert int((it_k.long() - it_p.long()).abs().max()) <= dcount
    assert int(it_k.min()) > 5


def test_cn_pcg_kernel_edges(cuda):
    from raytrace_tpu_torch.ops import cn_pcg_2d as cg

    fp2, op, f0 = _fp2d_case(cuda, torch.float64, na=3, npp=2)
    # no steps: the state as it came, no snapshot
    out = fp2.evolve_cn_2d(f0, op, 0.05, 0)
    assert torch.equal(out, f0)
    # fewer steps than a snapshot interval, and maxiter cuts the solve
    got, snaps = fp2.evolve_cn_2d(f0, op, 0.05, 3, save_every=4)
    assert snaps.shape == (0, 3, 2)
    fp2.evolve_cn_2d(f0, op, 0.05, 2, cg_maxiter=1)
    assert fp2.evolve_cn_2d.cg_iterations.tolist() == [1, 1]
    # one row and a grid near the limit
    fp2, op, f0 = _fp2d_case(cuda, torch.float64, na=1, npp=7)
    got = fp2.evolve_cn_2d(f0, op, 0.05, 4)
    want = fp2.evolve_cn_2d_reference(f0, op, 0.05, 4)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    fp2, op, f0 = _fp2d_case(cuda, torch.float64, na=90, npp=104)
    assert 90 * 104 <= cg.max_cells(torch.float64)
    got = fp2.evolve_cn_2d(f0, op, 0.05, 2)
    want = fp2.evolve_cn_2d_reference(f0, op, 0.05, 2)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    big = dataclasses.replace(op, n_a=400, n_p=400)
    with pytest.raises(ValueError, match="150176 cells"):
        cg.cn_pcg_2d(torch.ones(400, 400, device=cuda, dtype=torch.float64),
                     big, 0.05, 1, 0, 1e-10, 10)


def test_cn_pcg_kernel_past_the_old_limit(cuda):
    """A grid between the one-block kernel's old limit (9,386 float64
    cells) and the cluster's, held to the plain version at 1e-12."""
    from raytrace_tpu_torch.ops import cn_pcg_2d as cg

    fp2, op, f0 = _fp2d_case(cuda, torch.float64, na=160, npp=100)
    assert 9386 < 160 * 100 <= cg.max_cells(torch.float64)
    got = fp2.evolve_cn_2d(f0, op, 0.05, 3)
    it_k = fp2.evolve_cn_2d.cg_iterations.cpu()
    assert cg.cn_pcg_2d.last_layout.cluster > 1
    want = fp2.evolve_cn_2d_reference(f0, op, 0.05, 3)
    it_p = fp2.evolve_cn_2d.cg_iterations.cpu()
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert int((it_k.long() - it_p.long()).abs().max()) <= 1


@pytest.mark.parametrize("grid", [(270, 270), (64, 300)],
                         ids=["270x270", "64x300"])
def test_cn_pcg_kernel_state_in_global_memory(cuda, grid):
    """Grids whose bands hold more than two cells a thread of 512 take the
    instance that keeps the state in global memory (variant 0): one near
    the cluster's limit (17 rows of 270 a block) and one just past the
    register instances (4 rows of 300), held to the plain version at
    1e-12 (float64). Steps of 0.002, whose solves converge (~180-210
    iterations): at 0.05 these grids' solves stop at cg_maxiter short of
    the tolerance, where any two reduction orders part by 1e-11 to 1e-10
    of the max (the plain version against itself with f0 one ulp up, or
    two layouts of the kernel's source on the CPU)."""
    from raytrace_tpu_torch.ops import cn_pcg_2d as cg

    fp2, op, f0 = _fp2d_case(cuda, torch.float64, na=grid[0], npp=grid[1])
    launches = cg.cn_pcg_2d.launches
    got, snaps = fp2.evolve_cn_2d(f0, op, 0.002, 4, save_every=2)
    it_k = fp2.evolve_cn_2d.cg_iterations.cpu()
    lay = cg.cn_pcg_2d.last_layout
    assert cg.cn_pcg_2d.launches == launches + 1
    assert (lay.cluster, lay.threads, cg.VARIANTS[lay.variant]) == (16, 512, 0)
    want, ref = fp2.evolve_cn_2d_reference(f0, op, 0.002, 4, save_every=2)
    it_p = fp2.evolve_cn_2d.cg_iterations.cpu()
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale
    assert float((snaps - ref).abs().max()) <= 1e-12 * scale
    assert int((it_k.long() - it_p.long()).abs().max()) <= 1
    assert 5 < int(it_k.min()) and int(it_p.max()) < 500


# The main path's redesigned instances (the 2D float32 bs3 ones over the
# axisymmetric medium: the stage loop and, at most TAIL_LAYOUT_MAX_RAYS
# rays, the tail layout, one ray a warp), at the edges
# of the layout: B rays of the fan (every 10,240 // B-th), the threshold and
# one past it, and a merged tail's shape (41 rays padded to a 256-lane
# bucket with copies of the first)
CHAIN_B = [1, 31, 33, 41, 256, 528, 529, "tail"]


@pytest.mark.parametrize("b", CHAIN_B)
@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
def test_tail_layout_matches_plain_version_bitwise(cuda, frame, b):
    """Every field bit for bit with the plain version over 64 attempts
    with fresh and finish, each launch in the layout that launch_flags
    gives it (counted on step_chunk.sparse_launches)."""
    from raytrace_tpu_torch.integrate.solve import refine_events

    conf = preset("ensemble10k", frame=frame)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    u0, f = _build_u0(conf, env, np.float32, cuda)
    if b == "tail":
        rows = np.concatenate([np.arange(41) * 240, np.zeros(215, np.int64)])
    else:
        rows = np.arange(b) * (u0.shape[0] // b)
    u0 = torch.as_tensor(u0[rows], device=cuda)
    f = torch.as_tensor(f[rows], device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env)
    kw = dict(stepper="bs3", frame=conf.frame)
    codes = (0, 0, sc._FRAME_CODE[frame][0], sc.medium_code(env, cfg),
             sc.field_code(env))
    assert sc.tail_layout(*codes)
    carry = init_carry(rhs_fn, u0, f, cfg)
    sparse = sc.step_chunk.sparse_launches
    got = sc.step_chunk(carry._replace(k1=torch.full_like(carry.k1, np.nan)),
                        f, env, cfg, spec, n_steps=64, finish=True,
                        fresh=True, **kw)
    assert sc.step_chunk.sparse_launches == sparse + (
        len(rows) <= sc.TAIL_LAYOUT_MAX_RAYS)
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, n_steps=64,
                                  **kw)
    ref = refine_events(rhs_fn, ref, f, spec)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)


@pytest.mark.parametrize("flags", ["none", "finish_fresh"])
@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
def test_redesigned_chain_dense_matches_plain_version_bitwise(cuda, frame,
                                                              flags):
    """The whole fan, 10,240 rays in the dense layout, 32 attempts with and
    without finish and fresh: every field bit for bit."""
    conf = preset("ensemble10k", frame=frame)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    u0, f = _build_u0(conf, env, np.float32, cuda)
    u0, f = torch.as_tensor(u0, device=cuda), torch.as_tensor(f, device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env)
    kw = dict(stepper="bs3", frame=conf.frame)
    carry = init_carry(rhs_fn, u0, f, cfg)
    on = flags == "finish_fresh"
    sparse = sc.step_chunk.sparse_launches
    got = sc.step_chunk(carry, f, env, cfg, spec, n_steps=32, finish=on,
                        fresh=on, **kw)
    assert sc.step_chunk.sparse_launches == sparse
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, n_steps=32,
                                  **kw)
    if on:
        from raytrace_tpu_torch.integrate.solve import refine_events

        ref = refine_events(rhs_fn, ref, f, spec)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)


# The group body of the bs3 AD instances (ops/step_chunk.py::group_lanes:
# the 2D latitude frame in float32 and float64, the tilted dipole in
# float32, the 3D dipole in float64) at launch sizes of one ray, 45 rays
# (partly filled warps and blocks) and a merged tail's shape (27 rays
# padded to 256 lanes with copies of the first, stopped)
@pytest.mark.parametrize("b", [1, 45, "tail"])
@pytest.mark.parametrize("name,dtype", [
    ("ensemble10k", "float32"), ("ensemble10k_tilted", "float32"),
    ("ensemble10k", "float64"), ("ensemble10k_3d", "float64")])
def test_ad_group_body_matches_plain_version_bitwise(cuda, name, dtype, b):
    """Every field bit for bit with the plain version (ops/dual.py's
    rules) over 48 attempts with fresh and finish, the launch on the
    group body (counted on step_chunk.group_launches)."""
    from raytrace_tpu_torch.integrate.solve import refine_events

    conf = preset(name, grad_mode="autodiff", dtype=dtype)
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, cuda)
    rows = (np.concatenate([np.arange(27) * 379, np.zeros(229, np.int64)])
            if b == "tail" else np.arange(b) * (u0.shape[0] // b))
    u0 = torch.as_tensor(u0[rows], device=cuda)
    f = torch.as_tensor(f[rows], device=cuda)
    rhs_fn, _ = rhs.frame_rhs(conf.frame, env, conf.root, "autodiff")
    kw = dict(stepper="bs3", frame=conf.frame, root=conf.root,
              grad_mode="autodiff")
    codes = (int(dtype == "float64"), 0, sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg, "autodiff"), sc.field_code(env))
    assert sc.group_lanes(*codes) == (8 if conf.frame == "3d" else 4)
    assert sc.GROUP_MAX_RAYS[codes] >= 256
    carry = init_carry(rhs_fn, u0, f, cfg)
    if b == "tail":
        status = carry.status.clone()
        status[27:] = events.MAX_STEPS
        carry = carry._replace(status=status)
    group = sc.step_chunk.group_launches
    got = sc.step_chunk(carry._replace(k1=torch.full_like(carry.k1, np.nan)),
                        f, env, cfg, spec, n_steps=48, finish=True,
                        fresh=True, **kw)
    assert sc.step_chunk.group_launches == group + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, n_steps=48,
                                  **kw)
    ref = refine_events(rhs_fn, ref, f, spec)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref)
