"""Port parity for the step of the last variants, float64 on the CPU: the
step kernel's plain version with the local arc ceiling, in the colatitude
frame, over a multi-ion medium at both roots and with fixed-step rk4
(against the JAX package's _step_one loop, and one of them against its
Pallas kernel in interpret mode), the presets raymain, emic_heband and
ensemble10k_local, and the scalars the kernel takes by value. The paths
as a whole: tests/test_torch_run_variants.py."""

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
from raytrace_tpu.integrate.solve import _step_one as j_step_one
from raytrace_tpu.integrate.solve import init_carry as j_init_carry
from raytrace_tpu.parallel.ensemble import _frame_rhs as j_frame_rhs
from raytrace_tpu_torch.constants import RE
from raytrace_tpu_torch.integrate.solve import RayCarry
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.ops import step_chunk as sc

DT_MAX = 1.0e6 / RE
RK4 = dict(adaptive=False, dt0=DT_MAX)
# 16 rays of each 2D fan (the cut of test_torch_slice.py), in the
# colatitude frame 8 rays that land within ~500 steps there
CUT = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
           freqs=(2000.0, 3000.0), dtype="float64")
CUT_COLAT = dict(frame="2d_colat", lats=(0.95, 1.0, 1.05, 1.1),
                 chis=(-0.5,), freqs=(6649.9, 8000.0), dtype="float64")
CUT_RK4 = dict(CUT, lats=(0.9, 1.0, 1.05, 1.1), freqs=(4600.0, 6650.0),
               **RK4)
MULTI_ION = dict(eta_he=0.1, eta_o=0.02)

# (preset, overrides, stepper) of each step-level case. Where the
# controller would set the steps from the launch's dt0 on, the first
# attempts' error estimate is rounding noise, which the two packages round
# otherwise (~1e-8 after 24 attempts, test_torch_slice3d.py); a ceiling
# that sets every step makes dt a smooth function of the state, as
# test_torch_slice_fields.py holds it: the local ceiling at a hundredth of
# its gradient length (~0.002 RE), the colatitude frame at ds_max 0.002 RE
LOCAL = dict(ds_local_frac=0.01)
CASES = {
    "local": ("ensemble10k_local", dict(CUT, **LOCAL), "dopri5"),
    "local_3d": ("ensemble10k_3d", dict(CUT, chis=(-0.2, 0.2),
                                        ds_local=True, **LOCAL), "dopri5"),
    "colat": ("ensemble10k", dict(CUT_COLAT, ds_max=0.002), "dopri5"),
    "emic": ("emic_heband", dict(dtype="float64"), "dopri5"),
    "multi_ion_whistler": ("ensemble10k", CUT, "dopri5"),
    "rk4": ("ensemble10k", CUT_RK4, "bs3"),
    "rk4_colat": ("ensemble10k", dict(CUT_COLAT, **RK4), "bs3"),
    "rk4_3d": ("ensemble10k_3d", dict(CUT, chis=(-0.2, 0.2), **RK4),
               "dopri5"),
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
            # last bits are rounding noise
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12,
                                       err_msg=name)
        elif w.ndim == 2:
            for j in range(w.shape[1]):
                _close(g[:, j], w[:, j], rtol, f"{name}[{j}]")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-300,
                                       err_msg=name)


def _jax_case(case):
    """(rhs_fn, cfg, spec, group_idx, carry0, f, env, conf) of the JAX
    package for a case of CASES."""
    name, over, _ = CASES[case]
    conf = j_config.preset(name, **over)
    if case == "multi_ion_whistler":
        conf.medium.eta_he, conf.medium.eta_o = MULTI_ION.values()
    env = conf.medium.build()
    u0, f = j_run._build_u0(conf, np.float64)
    rf, gidx = j_frame_rhs(conf.frame, env, "fused", conf.root, False)
    cfg, spec = conf.solver(), conf.stop()
    carry0 = jax.vmap(lambda u, ff: j_init_carry(rf, u, ff, cfg))(
        jnp.asarray(u0), jnp.asarray(f))
    return rf, cfg, spec, gidx, carry0, f, env, conf


def _port_args(env, cfg, spec, carry0, f):
    return (carry_from_numpy({k: np.asarray(v) for k, v in
                              carry0._asdict().items()},
                             device="cpu", dtype=torch.float64),
            torch.tensor(np.asarray(f)), env_from_numpy(env._asdict()),
            solver_config_from(cfg), stop_spec_from(spec))


# 24 attempts from the launch: dopri5 and rk4 at 1e-12 (bs3's error
# estimate would amplify the math libraries' last-bit differences to
# ~1e-8, test_torch_step_chunk.py)
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_chunk_variant_matches_jax_steps(case):
    rf, cfg, spec, gidx, carry0, f, env, conf = _jax_case(case)
    stepper = CASES[case][2]
    step = jax.jit(jax.vmap(partial(j_step_one, rf, cfg=cfg, spec=spec,
                                    group_idx=gidx, adaptive=conf.adaptive,
                                    stepper=stepper)))
    want = carry0
    for _ in range(24):
        want = step(want, jnp.asarray(f))
    args = _port_args(env, cfg, spec, carry0, f)
    calls = sc.step_chunk_reference.calls
    got = sc.step_chunk(*args, stepper=stepper, n_steps=24, root=conf.root,
                        adaptive=conf.adaptive, frame=conf.frame)
    assert sc.step_chunk_reference.calls == calls + 1  # tensors on a CPU
    _assert_carries(carry_to_numpy(got), want, 1e-12)
    if case.startswith("local"):
        # the local ceiling set some step below the phase ceiling
        assert (np.asarray(want.dt) < cfg.dt_max).any()
    if case.startswith("rk4"):
        assert (np.asarray(want.dt) == cfg.dt0).all()
        assert not np.asarray(want.n_reject).any()


def test_step_chunk_local_ceiling_matches_pallas_interpret():
    """The plain version against the Pallas kernel itself with the local
    arc ceiling, run as the JAX package's tests run it on the CPU
    (interpret mode)."""
    from raytrace_tpu.ops import pallas_stepper

    rf, cfg, spec, gidx, carry0, f, env, conf = _jax_case("local")
    n = 8
    carry0 = type(carry0)(*[x[:n] for x in carry0])
    f = f[:n]
    chunk = pallas_stepper.make_pallas_chunk(rf, cfg, spec, gidx, True, n,
                                             interpret=True)
    want = chunk(carry0, jnp.asarray(f))
    got = sc.step_chunk(*_port_args(env, cfg, spec, carry0, f),
                        stepper="dopri5", n_steps=n)
    _assert_carries(carry_to_numpy(got), want, 1e-12)


@pytest.mark.parametrize("name", ["raymain", "emic_heband",
                                  "ensemble10k_local"])
def test_variant_preset_json_equals_jax(name):
    t_cfg = t_config.preset(name)
    j_cfg = j_config.preset(name)
    assert json.loads(t_cfg.to_json()) == json.loads(j_cfg.to_json())
    assert t_cfg.solver() == tuple(j_cfg.solver())
    assert tuple(t_cfg.stop()) == tuple(j_cfg.stop())
    assert t_cfg.root == j_cfg.root
    assert t_cfg.medium.build() == env_from_numpy(
        j_cfg.medium.build()._asdict())
    assert name in t_config._PRESETS and not t_config._LATER


def test_kernel_parameters_carry_the_variants():
    """The local ceiling's shells (the knee, then the duct) and the ion
    species ride StepParams as the plain version forms them, in double."""
    from raytrace_tpu_torch.ops.dispersion import ion_species

    conf = t_config.preset("ensemble10k_local")
    conf.medium.duct_amp = 0.5
    conf.medium.eta_he, conf.medium.eta_o = MULTI_ION.values()
    env, cfg = conf.medium.build(), conf.solver()
    p = sc._params(env, cfg, conf.stop(), -1.0)
    assert (p.n_shells, p.ds_local_frac) == (2.0, 1.0)
    assert list(p.shell_l)[:2] == [env.lppo, 3.0]
    assert list(p.shell_w)[:2] == [0.1, 0.1]
    ions = ion_species(0.1, 0.02)
    assert p.n_ion == 3.0
    assert list(p.ion_fpe2) == [x for x, _ in ions]
    assert list(p.ion_fce) == [y for _, y in ions]
    assert p.root == -1.0
    base = t_config.preset("ensemble10k")
    off = sc._params(base.medium.build(), base.solver(), conf.stop(), 1.0)
    assert (off.n_shells, off.n_ion) == (0.0, 1.0)
    # the ion species and the local ceiling take the kernel's EXT instances;
    # the protons-only media without it keep theirs
    assert sc.medium_code(env, cfg) == 2
    assert sc.medium_code(base.medium.build(), cfg) == 2
    assert sc.medium_code(env._replace(eta_he=0.0, eta_o=0.0)) == 1
    assert sc.medium_code(base.medium.build(), base.solver()) == 0
    # more shells than the kernel's parameters hold: the first MAX_SHELLS
    # ride there, the rest in a buffer on the card (_overflow), and the
    # step chunk's plain version over them is the JAX package's (dopri5 at
    # 1e-12 with the ceiling setting every step, as
    # test_step_chunk_variant_matches_jax_steps holds the local case)
    many = cfg._replace(ds_local_shells=((3.0, 0.1),) * sc.MAX_SHELLS)
    p = sc._params(env, many, conf.stop(), -1.0)
    assert p.n_shells == 1.0 + sc.MAX_SHELLS
    assert list(p.shell_l) == [env.lppo] + [3.0] * (sc.MAX_SHELLS - 1)
    assert sc._overflow(env, many, torch.float64, "cpu")[1].tolist() == [
        3.0, 0.1]
    j_conf = j_config.preset("ensemble10k_local", **CUT, **LOCAL)
    j_conf.medium.duct_amp = 0.5
    j_conf.medium.eta_he, j_conf.medium.eta_o = MULTI_ION.values()
    j_env = j_conf.medium.build()
    assert env_from_numpy(j_env._asdict()) == env
    j_many = j_conf.solver()._replace(
        ds_local_shells=((3.0, 0.1),) * sc.MAX_SHELLS)
    u0, f = j_run._build_u0(j_conf, np.float64)
    rf, gidx = j_frame_rhs("2d_lat", j_env, "fused", 1.0, False)
    carry0 = jax.vmap(lambda u, ff: j_init_carry(rf, u, ff, j_many))(
        jnp.asarray(u0), jnp.asarray(f))
    step = jax.jit(jax.vmap(partial(j_step_one, rf, cfg=j_many,
                                    spec=j_conf.stop(), group_idx=gidx,
                                    adaptive=True, stepper="dopri5")))
    want = carry0
    for _ in range(24):
        want = step(want, jnp.asarray(f))
    got = sc.step_chunk(*_port_args(j_env, j_many, j_conf.stop(), carry0, f),
                        stepper="dopri5", n_steps=24)
    _assert_carries(carry_to_numpy(got), want, 1e-12)
