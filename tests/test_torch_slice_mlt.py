"""Port parity for the path over the full density medium, float64 on the
CPU: the step kernel's plain version over rhs_3d with the MLT-resolved
medium (against the JAX package's _step_one loop and its Pallas kernel in
interpret mode) and over rhs_2d_lat with the other medium gates, the
ensemble10k_plume and mr_fan_3d slices through run.run against the JAX
package's run, their launch and their presets."""

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
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate.solve import RayCarry
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.ops import step_chunk as sc

PHIS4 = tuple(np.linspace(-np.pi, np.pi, 4, endpoint=False) + np.pi / 4)
# 16 rays of ensemble10k_plume over 4 local-time sectors that land in a
# few hundred steps
CUT_PLUME = dict(lats=(0.8, 1.0), phis=PHIS4, chis=(-0.2, 0.2),
                 freqs=(2000.0,), dtype="float64")
# the CI cut of mr_fan_3d (tests/test_mr3d.py:192)
CUT_MR = dict(lats=(1.0, 1.1), phis=(-0.39, 2.75), chis=(-0.1, 0.0),
              freqs=(1000.0, 1500.0), dtype="float64")
# The arc ceiling at 0.002 RE sets the steps (at test_torch_3d.py's
# 0.005 it binds less often over these denser media), so dt is a smooth
# function of the state and dopri5 is held to 1e-12
CEILING = dict(dt0=1e-4, ds_max=0.002)
# the 2D media through the full chain: GCPM and smoothing are separate
# code paths, so two media hold every gate
MEDIA_2D = {
    "gcpm_iono_duct": dict(ps_model="gcpm", iono_mlt=True, mlt=15.0,
                           duct_amp=0.5, duct_l0=3.0, duct_w=0.1),
    "smooth_refill_duct": dict(ps_smooth=0.05, ps_refill=0.5,
                               ps_refill_q=4.0, duct_amp=0.5, duct_l0=3.0,
                               duct_w=0.1, iono_mlt=True),
}


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
            # last bits are rounding noise (measured 2.5e-13 apart)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12,
                                       err_msg=name)
        elif w.ndim == 2:
            for j in range(w.shape[1]):
                _close(g[:, j], w[:, j], rtol, f"{name}[{j}]")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=name)


def _jax_carry(frame, medium_kw=None):
    """(rhs_fn, cfg, spec, carry0, f, env) of the JAX package for 16 rays
    at the CEILING settings: the plume launch (3D, MLT-resolved medium)
    or the 2D production fan over a medium of MEDIA_2D."""
    if frame == "3d":
        cfg_run = j_config.preset("ensemble10k_plume", **CUT_PLUME,
                                  **CEILING)
        env = cfg_run.medium.build()
        u0, f = j_run._build_u0(cfg_run, np.float64)
        rf = lambda u, ff: j_rhs.rhs_3d(u, ff, env)  # noqa: E731
    else:
        cfg_run = j_config.preset("ensemble10k_production", dtype="float64",
                                  lats=(0.6, 0.8, 1.0, 1.1),
                                  chis=(-0.3, 0.3), freqs=(1000.0, 4000.0),
                                  **CEILING)
        env = j_make_env(b0=3.0696381e-5, **medium_kw)
        u0, f = j_run._build_u0(cfg_run, np.float64)
        rf = lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env)  # noqa: E731
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


def _jax_steps(rf, cfg, spec, carry0, f, gidx, stepper, n):
    step = jax.jit(jax.vmap(partial(j_step_one, rf, cfg=cfg, spec=spec,
                                    group_idx=gidx, adaptive=True,
                                    stepper=stepper)))
    want = carry0
    for _ in range(n):
        want = step(want, jnp.asarray(f))
    return want


# dopri5 at 1e-12 where the ceiling sets the steps; bs3's error estimate
# cancels to ~1e-9 of its terms, so the 1e-15 math-library differences
# between XLA and PyTorch reach ~1e-8 in dt and the state, with identical
# statuses and counters (test_torch_step_chunk.py)
@pytest.mark.parametrize("stepper,rtol", [("dopri5", 1e-12), ("bs3", 1e-6)])
def test_step_chunk_mlt_3d_matches_jax_steps(stepper, rtol):
    rf, cfg, spec, carry0, f, env = _jax_carry("3d")
    want = _jax_steps(rf, cfg, spec, carry0, f, 6, stepper, 24)
    args = _port_args(env, cfg, spec, carry0, f)
    assert sc.medium_code(args[2]) == 1     # the full density chain
    calls = sc.step_chunk_reference.calls
    got = sc.step_chunk(*args, stepper=stepper, n_steps=24, frame="3d")
    assert sc.step_chunk_reference.calls == calls + 1  # tensors on a CPU
    _assert_carries(carry_to_numpy(got), want, rtol)
    # the rays moved in longitude: d mu/d phi is on the path
    assert float(np.abs(np.asarray(want.k1)[:, 5]).max()) > 0.0


def test_step_chunk_mlt_3d_matches_pallas_interpret():
    """The plain version against the Pallas kernel itself over rhs_3d with
    the MLT-resolved medium, run as the JAX package's tests run it on the
    CPU (interpret mode)."""
    from raytrace_tpu.ops import pallas_stepper

    rf, cfg, spec, carry0, f, env = _jax_carry("3d")
    n = 8
    carry0 = type(carry0)(*[x[:n] for x in carry0])
    f = f[:n]
    chunk = pallas_stepper.make_pallas_chunk(rf, cfg, spec, 6, True, n,
                                             interpret=True)
    want = chunk(carry0, jnp.asarray(f))
    got = sc.step_chunk(*_port_args(env, cfg, spec, carry0, f),
                        stepper="dopri5", n_steps=n, frame="3d")
    _assert_carries(carry_to_numpy(got), want, 1e-12)


@pytest.mark.parametrize("medium_name", sorted(MEDIA_2D))
def test_step_chunk_2d_full_medium_matches_jax_steps(medium_name):
    """24 dopri5 steps of the 2D frame through the full density chain
    (the kernel's medium-1 instances) at 1e-12."""
    rf, cfg, spec, carry0, f, env = _jax_carry("2d_lat",
                                               MEDIA_2D[medium_name])
    want = _jax_steps(rf, cfg, spec, carry0, f, 3, "dopri5", 24)
    args = _port_args(env, cfg, spec, carry0, f)
    assert sc.medium_code(args[2]) == 1
    got = sc.step_chunk(*args, stepper="dopri5", n_steps=24,
                        frame="2d_lat")
    _assert_carries(carry_to_numpy(got), want, 1e-12)


# The plume cut runs the preset's own settings (bs3 base): the landing
# states carry bs3's conditioning (~1e-8, test_torch_slice3d.py), 1e-7.
# The mr_fan_3d cut cannot: its launches (low altitude, near f_LHR, rtol
# 1e-6) turn the two packages' last-ulp differences into other
# accept/reject paths within 256 bs3 attempts, in the axisymmetric medium
# as much as in the MLT one (measured: 12 of 16 rays' counters differ at
# 256 attempts; with the dopri5 base, 3 of 16 at 3,000). So the cut runs
# at CEILING with the dopri5 base over 512 attempts, where the steps are
# the ceiling's and the counters identical; the early rejected attempts
# still carry rounding noise into dt, so the states are held at 1e-6
# (measured 3.6e-7). The preset's own settings are held on the card
# against the JAX package's census (chip_smoke.py phase 10).
@pytest.mark.parametrize("name,cut,over,rtol", [
    ("ensemble10k_plume", CUT_PLUME, {}, 1e-7),
    ("mr_fan_3d", CUT_MR, dict(CEILING, base_stepper="dopri5",
                               max_steps=512), 1e-6),
])
def test_run_matches_jax_run(name, cut, over, rtol):
    j_out = j_run.run(j_config.preset(name, **cut, **over))
    t_out = t_run.run(t_config.preset(name, **cut, **over), device="cpu")
    n = int(t_out["valid"].sum())
    assert n == 16 and int(np.asarray(j_out["valid"]).sum()) == n
    jr, tr = j_out["result"], t_out["result"]
    for field in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, field)[:n],
                                      np.asarray(getattr(jr, field))[:n],
                                      err_msg=field)
    ju = np.asarray(jr.u)[:n]
    # per component against its largest magnitude over the cut
    scale = np.abs(ju).max(axis=0)
    assert (np.abs(tr.u[:n] - ju) <= rtol * scale).all()
    np.testing.assert_allclose(tr.t[:n], np.asarray(jr.t)[:n], rtol=rtol)
    assert t_out["stats"].keys() == j_out["stats"].keys()
    for k, v in j_out["stats"].items():
        np.testing.assert_allclose(t_out["stats"][k], v, rtol=rtol, err_msg=k)
    # the rays drifted in longitude (d mu/d phi != 0 along the path)
    u0, _ = j_run._build_u0(j_config.preset(name, **cut, **over), np.float64)
    assert float(np.abs(tr.u[:n, 2] - u0[:n, 2]).max()) > 1e-4


def test_plume_launch_matches_jax():
    """The plume launch grid (lat x phi x chi x f, the JAX package's order)
    and its on-shell rho over the MLT medium."""
    j_cfg = j_config.preset("ensemble10k_plume", **CUT_PLUME)
    t_cfg = t_config.preset("ensemble10k_plume", **CUT_PLUME)
    uj, fj = j_run._build_u0(j_cfg, np.float64)
    ut, ft = t_run._build_u0(t_cfg, t_cfg.medium.build(), np.float64,
                             torch.device("cpu"))
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ut[:, [0, 1, 2, 6]], uj[:, [0, 1, 2, 6]])
    np.testing.assert_allclose(ut[:, 3:6], uj[:, 3:6], rtol=1e-14)
    assert len(set(np.round(ut[:, 2], 12))) == 4


@pytest.mark.parametrize("name", ["ensemble10k_plume", "mr_fan_3d"])
def test_preset_json_equals_jax(name):
    t_cfg = t_config.preset(name)
    j_cfg = j_config.preset(name)
    assert json.loads(t_cfg.to_json()) == json.loads(j_cfg.to_json())
    assert t_config.RunConfig.from_json(j_cfg.to_json()) == t_cfg
    assert t_cfg.solver() == tuple(j_cfg.solver())
    assert tuple(t_cfg.stop()) == tuple(j_cfg.stop())
    t_env, j_env = t_cfg.medium.build(), j_cfg.medium.build()
    assert env_from_numpy(j_env._asdict()) == t_env
    assert sc.medium_code(t_env) == 1
