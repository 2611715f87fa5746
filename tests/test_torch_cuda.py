"""The CUDA step kernel against its plain PyTorch version on the card.

Marked `gpu`: on a machine without a CUDA device every test here skips.
On the card: `python -m pytest tests/test_torch_cuda.py -m gpu -q
--noconftest` (tests/conftest.py imports jax, which a machine with only
the port need not have)."""

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
