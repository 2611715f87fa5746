"""Port parity for the paths over the non-axial fields, float64 on the
CPU: the step kernel's plain version over rhs_3d with the tilted dipole
and the IGRF truncation (against the JAX package's _step_one loop and its
Pallas kernel in interpret mode), the ensemble10k_tilted and
ensemble10k_igrf slices through run.run against the JAX package's run,
their launch, their presets, and the scalars the kernel takes by value."""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
import raytrace_tpu_torch.config as t_config
import raytrace_tpu_torch.run as t_run
from raytrace_tpu.integrate.solve import _step_one as j_step_one
from raytrace_tpu.integrate.solve import init_carry as j_init_carry
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate.solve import RayCarry
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.models import dipole
from raytrace_tpu_torch.ops import step_chunk as sc

PRESETS = ("ensemble10k_tilted", "ensemble10k_igrf")
PHIS4 = tuple(np.linspace(-np.pi, np.pi, 4, endpoint=False) + np.pi / 4)
# 16 rays of each preset's launch over 4 local-time sectors
CUT16 = dict(lats=(0.8, 1.0), phis=PHIS4, chis=(-0.2, 0.2),
             freqs=(2000.0,), dtype="float64")
# 32 rays that land within a few hundred steps
CUT32 = dict(lats=(0.7, 0.85, 1.0, 1.1), phis=PHIS4, chis=(-0.2, 0.2),
             freqs=(2000.0,), dtype="float64")
# The arc ceiling at 0.002 RE sets every step (as in
# test_torch_slice_mlt.py), so dt is a smooth function of the state and
# dopri5 is held to 1e-12
CEILING = dict(dt0=1e-4, ds_max=0.002)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e}"


def _assert_carries(got, want, rtol):
    for name in RayCarry._fields:
        w = np.asarray(getattr(want, name))
        g = np.asarray(got[name])
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name == "u_lo":   # two-sum residuals (~1e-17)
            assert float(np.abs(g - w).max()) <= 1e-12
        elif name == "errold":
            # the error norm, >= 1e-4: a cancellation of stage terms whose
            # last bits are rounding noise
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12,
                                       err_msg=name)
        elif w.ndim == 2:
            for j in range(w.shape[1]):
                _close(g[:, j], w[:, j], rtol, f"{name}[{j}]")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=name)


def _jax_carry(name):
    """(rhs_fn, cfg, spec, carry0, f, env) of the JAX package for the 16
    rays of CUT16 at the CEILING settings."""
    cfg_run = j_config.preset(name, **CUT16, **CEILING)
    env = cfg_run.medium.build()
    u0, f = j_run._build_u0(cfg_run, np.float64)
    rf = lambda u, ff: j_rhs.rhs_3d(u, ff, env)  # noqa: E731
    cfg, spec = cfg_run.solver(), cfg_run.stop()
    carry0 = jax.vmap(lambda u, ff: j_init_carry(rf, u, ff, cfg))(
        jnp.asarray(u0), jnp.asarray(f))
    return rf, cfg, spec, carry0, f, env


def _port_args(env, cfg, spec, carry0, f):
    return (carry_from_numpy({k: np.asarray(v) for k, v in
                              carry0._asdict().items()},
                             device="cpu", dtype=torch.float64),
            torch.tensor(np.asarray(f)), env_from_numpy(env._asdict()),
            solver_config_from(cfg), stop_spec_from(spec))


# dopri5 at 1e-12 where the ceiling sets the steps; bs3's error estimate
# cancels to ~1e-9 of its terms, so the 1e-15 math-library differences
# between XLA and PyTorch reach ~1e-8 in dt and the state, with identical
# statuses and counters (test_torch_step_chunk.py): 1e-6
@pytest.mark.parametrize("stepper,rtol", [("dopri5", 1e-12), ("bs3", 1e-6)])
@pytest.mark.parametrize("name", PRESETS)
def test_step_chunk_over_the_field_matches_jax_steps(name, stepper, rtol):
    rf, cfg, spec, carry0, f, env = _jax_carry(name)
    step = jax.jit(jax.vmap(partial(j_step_one, rf, cfg=cfg, spec=spec,
                                    group_idx=6, adaptive=True,
                                    stepper=stepper)))
    want = carry0
    for _ in range(24):
        want = step(want, jnp.asarray(f))
    args = _port_args(env, cfg, spec, carry0, f)
    assert sc.medium_code(args[2]) == 1     # the full density chain
    assert sc.field_code(args[2]) == PRESETS.index(name) + 1
    calls = sc.step_chunk_reference.calls
    got = sc.step_chunk(*args, stepper=stepper, n_steps=24, frame="3d")
    assert sc.step_chunk_reference.calls == calls + 1  # tensors on a CPU
    _assert_carries(carry_to_numpy(got), want, rtol)
    # the rays moved in longitude: d mu/d phi is on the path
    assert float(np.abs(np.asarray(want.k1)[:, 5]).max()) > 0.0


def test_step_chunk_tilted_matches_pallas_interpret():
    """The plain version against the Pallas kernel itself over rhs_3d with
    the tilted field, run as the JAX package's tests run it on the CPU
    (interpret mode)."""
    from raytrace_tpu.ops import pallas_stepper

    rf, cfg, spec, carry0, f, env = _jax_carry("ensemble10k_tilted")
    n = 8
    carry0 = type(carry0)(*[x[:n] for x in carry0])
    f = f[:n]
    chunk = pallas_stepper.make_pallas_chunk(rf, cfg, spec, 6, True, n,
                                             interpret=True)
    want = chunk(carry0, jnp.asarray(f))
    got = sc.step_chunk(*_port_args(env, cfg, spec, carry0, f),
                        stepper="dopri5", n_steps=n, frame="3d")
    _assert_carries(carry_to_numpy(got), want, 1e-12)


# each preset cut to 32 rays at its own settings (bs3 base, the preset's
# arc ceiling): statuses and counters identical; the landing states carry
# bs3's conditioning (~1e-8, test_torch_slice3d.py), held at 1e-7
@pytest.mark.parametrize("name", PRESETS)
def test_run_matches_jax_run(name):
    j_out = j_run.run(j_config.preset(name, **CUT32))
    t_out = t_run.run(t_config.preset(name, **CUT32), device="cpu")
    n = int(t_out["valid"].sum())
    assert n == 32 and int(np.asarray(j_out["valid"]).sum()) == n
    jr, tr = j_out["result"], t_out["result"]
    for field in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, field)[:n],
                                      np.asarray(getattr(jr, field))[:n],
                                      err_msg=field)
    ju = np.asarray(jr.u)[:n]
    scale = np.abs(ju).max(axis=0)
    assert (np.abs(tr.u[:n] - ju) <= 1e-7 * scale).all()
    np.testing.assert_allclose(tr.t[:n], np.asarray(jr.t)[:n], rtol=1e-7)
    assert t_out["stats"].keys() == j_out["stats"].keys()
    for k, v in j_out["stats"].items():
        np.testing.assert_allclose(t_out["stats"][k], v, rtol=1e-7,
                                   err_msg=k)
    # the landing L of the statistics is geographic (r / sin^2 theta), as
    # in the JAX package, whatever the field
    hit = tr.status[:n] == 1
    assert hit.any()
    land = np.sort((tr.u[:n, 0] / np.sin(tr.u[:n, 1]) ** 2)[hit])
    np.testing.assert_allclose(float(t_out["stats"]["median_landing_l"]),
                               land[(hit.sum() - 1) // 2], rtol=1e-14)


@pytest.mark.parametrize("name", PRESETS)
def test_field_launch_matches_jax(name):
    """The launch grid and its on-shell rho over the field: |rho| is the
    local mu of the launch direction through medium.b_vec, mlat_3d and
    mlon_3d."""
    j_cfg = j_config.preset(name, **CUT16)
    t_cfg = t_config.preset(name, **CUT16)
    uj, fj = j_run._build_u0(j_cfg, np.float64)
    ut, ft = t_run._build_u0(t_cfg, t_cfg.medium.build(), np.float64,
                             torch.device("cpu"))
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ut[:, [0, 1, 2, 6]], uj[:, [0, 1, 2, 6]])
    np.testing.assert_allclose(ut[:, 3:6], uj[:, 3:6], rtol=1e-13)
    # the same fan over the centered dipole launches elsewhere on the
    # dispersion surface
    ud, _ = t_run._build_u0(t_config.preset("ensemble10k_plume", **CUT16),
                            t_config.preset("ensemble10k_plume").medium
                            .build(), np.float64, torch.device("cpu"))
    assert not np.allclose(ud[:, 3:6], ut[:, 3:6], rtol=1e-4)


@pytest.mark.parametrize("name", PRESETS)
def test_field_preset_json_equals_jax(name):
    t_cfg = t_config.preset(name)
    j_cfg = j_config.preset(name)
    assert json.loads(t_cfg.to_json()) == json.loads(j_cfg.to_json())
    assert t_config.RunConfig.from_json(j_cfg.to_json()) == t_cfg
    assert t_cfg.solver() == tuple(j_cfg.solver())
    assert tuple(t_cfg.stop()) == tuple(j_cfg.stop())
    assert len(t_cfg.lats) * len(t_cfg.phis) * len(t_cfg.chis) * len(
        t_cfg.freqs) == 10240
    t_env, j_env = t_cfg.medium.build(), j_cfg.medium.build()
    assert env_from_numpy(j_env._asdict()) == t_env
    assert sc.medium_code(t_env) == 1
    assert sc.field_code(t_env) == PRESETS.index(name) + 1


@pytest.mark.parametrize("name", PRESETS)
def test_kernel_parameters_carry_the_field(name):
    """The scalars the kernel takes by value: the moment unit vector, the
    two rotated axes of the magnetic longitude (the host functions the
    plain version calls) and the 15 Schmidt coefficients, among 1,000
    bytes in all (with the local ceiling's shells, the ion species, the
    reference scripts' two mode flags, the three divisors of the AD
    instances' value chain and the pointers to the MLT coefficients and
    shells past those the parameters hold)."""
    import ctypes

    conf = t_config.preset(name)
    env = conf.medium.build()
    p = sc._params(env, conf.solver(), conf.stop(), 1.0)
    assert ctypes.sizeof(p) == 1000
    xm, ym = dipole.mlon_axes(env.b_tilt, env.b_tilt_phi)
    assert tuple(p.b_mom) == dipole.moment_unit(env.b_tilt, env.b_tilt_phi)
    assert tuple(p.b_xm) == xm and tuple(p.b_ym) == ym
    assert tuple(p.igrf) == (env.igrf_coeffs or (0.0,) * 15)
    assert abs(sum(m * m for m in p.b_mom) - 1.0) < 1e-15
    assert p.b0 == env.b0 and p.ps_mlt == 1.0


def test_step_chunk_refuses_the_field_in_a_2d_frame():
    """A non-axial field has no meridional symmetry: the 2D frame's chunk
    refuses it before any launch, as the JAX package's 2D entries do."""
    conf = t_config.preset("ensemble10k", lats=(0.8,), chis=(0.0,),
                           freqs=(2000.0,))
    env = t_config.MediumConfig(b_model="tilted", b_tilt=0.2).build()
    f = torch.tensor([2000.0], dtype=torch.float64)
    z = torch.zeros(1, 4, dtype=torch.float64)
    zi = torch.zeros(1, dtype=torch.int32)
    carry = RayCarry(u=z, k1=z, u_prev=z, u_lo=z, t=f, dt=f, errold=f,
                     dt_prev=f, status=zi, n_accept=zi, n_reject=zi,
                     rejected=zi, n_tiny=zi, caution=zi)
    with pytest.raises(ValueError, match="3D-only"):
        sc.step_chunk(carry, f, env, conf.solver(), conf.stop(),
                      stepper="bs3", n_steps=1, frame="2d_lat")
