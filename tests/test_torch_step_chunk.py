"""Port parity: ops/step_chunk.py (the port of ops/pallas_stepper.py).

On the CPU `step_chunk` runs its plain PyTorch version,
`step_chunk_reference`; these tests hold it to the JAX package's vmapped
_step_one loop (the setup of tests/test_pallas.py: 16 rays x 24 steps,
float64) and check what the wrapper refuses. The CUDA kernel itself is
held to the same plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate.solve import _step_one as j_step_one
from raytrace_tpu.integrate.solve import init_carry as j_init_carry
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import RayCarry, SolverConfig
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.ops import step_chunk as sc

N_RAYS, N_STEPS = 16, 24


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_setup():
    env = j_make_env_lat()
    env = type(env)(
        *[v if isinstance(v, (str, tuple)) else float(v) for v in env]
    )
    rhs_fn = lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env)  # noqa: E731
    cfg = JSolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4)
    spec = JStopSpec(r_floor=1.0, t_max=5e8 / RE)
    n = N_RAYS
    u0 = jnp.stack([jnp.full((n,), (RE + 1e6) / RE),
                    jnp.linspace(0.5, 0.9, n), jnp.zeros((n,)),
                    jnp.zeros((n,))], axis=1)
    f = jnp.full((n,), 1000.0)
    carry0 = jax.vmap(lambda u, ff: j_init_carry(rhs_fn, u, ff, cfg))(u0, f)
    return env, rhs_fn, cfg, spec, carry0, f


def _port_args(env, cfg, spec, carry0, f):
    return (carry_from_numpy({k: np.asarray(v) for k, v in
                              carry0._asdict().items()},
                             device="cpu", dtype=torch.float64),
            torch.tensor(np.asarray(f)), env_from_numpy(env._asdict()),
            solver_config_from(cfg), stop_spec_from(spec))


# dopri5 is held to rtol 1e-12. bs3's embedded error estimate is a sum of
# O(dt k) stage terms that cancels to ~1e-9 of their size at these steps,
# so the 1e-15 differences between XLA's and PyTorch's CPU math libraries
# (exp, sin, ...) reach ~1e-8 in the error norm wherever the controller is
# not clamped, and from there dt, t and u (measured max 2.9e-8 over 24
# steps); the integer fields stay identical.
@pytest.mark.parametrize("stepper,rtol", [("dopri5", 1e-12), ("bs3", 1e-6)])
def test_step_chunk_cpu_matches_jax_steps(stepper, rtol):
    env, rhs_fn, cfg, spec, carry0, f = _jax_setup()
    step = jax.jit(jax.vmap(partial(j_step_one, rhs_fn, cfg=cfg, spec=spec,
                                    group_idx=3, adaptive=True,
                                    stepper=stepper)))
    ref = carry0
    for _ in range(N_STEPS):
        ref = step(ref, f)
    launches, calls = sc.step_chunk.launches, sc.step_chunk_reference.calls
    carry, ft, te, tcfg, tspec = _port_args(env, cfg, spec, carry0, f)
    got = carry_to_numpy(sc.step_chunk(carry, ft, te, tcfg, tspec,
                                       stepper=stepper, n_steps=N_STEPS))
    assert sc.step_chunk.launches == launches          # no kernel on a CPU
    assert sc.step_chunk_reference.calls == calls + 1  # tensor
    for name in RayCarry._fields:
        want = np.asarray(getattr(ref, name))
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got[name], want, err_msg=name)
            continue
        # u_lo holds compensated-summation residuals (~1e-17)
        np.testing.assert_allclose(got[name], want, rtol=rtol,
                                   atol=1e-12 if name == "u_lo" else 0.0,
                                   err_msg=name)


@pytest.mark.slow  # the JAX Pallas kernel in interpret mode, as test_pallas
def test_step_chunk_cpu_matches_pallas_interpret():
    from raytrace_tpu.ops import pallas_stepper

    env, rhs_fn, cfg, spec, carry0, f = _jax_setup()
    chunk = pallas_stepper.make_pallas_chunk(rhs_fn, cfg, spec, 3, True,
                                             N_STEPS, interpret=True)
    ref = chunk(carry0, f)
    carry, ft, te, tcfg, tspec = _port_args(env, cfg, spec, carry0, f)
    got = carry_to_numpy(sc.step_chunk(carry, ft, te, tcfg, tspec,
                                       stepper="dopri5", n_steps=N_STEPS))
    for name in RayCarry._fields:
        np.testing.assert_allclose(
            got[name], np.asarray(getattr(ref, name)), rtol=1e-12,
            atol=1e-12 if name == "u_lo" else 0.0, err_msg=name)


def _small_carry(n=8, dtype=torch.float64):
    from raytrace_tpu_torch.integrate.solve import init_carry
    from raytrace_tpu_torch.models.medium import make_env_lat
    from raytrace_tpu_torch.ops import rhs

    env = make_env_lat()
    u0 = torch.tensor([[(RE + 1e6) / RE, 0.7, 0.0, 0.0]] * n, dtype=dtype)
    f = torch.full((n,), 1000.0, dtype=dtype)
    cfg = SolverConfig()
    carry = init_carry(lambda u, ff: rhs.rhs_2d_lat(u, ff, env), u0, f, cfg)
    return carry, f, env, cfg, StopSpec(r_floor=1.0)


@pytest.mark.parametrize("case,exc", [
    ("stepper", ValueError),
    ("ds_max", NotImplementedError),
    ("ds_local", NotImplementedError),
    ("rk4", NotImplementedError),
    ("medium", NotImplementedError),
    ("dtype", ValueError),
    ("shape", ValueError),
    ("int_field", ValueError),
    ("device", ValueError),
])
def test_step_chunk_refuses_what_the_kernel_does_not_take(case, exc):
    carry, f, env, cfg, spec = _small_carry()
    kw = dict(stepper="bs3", n_steps=4)
    if case == "stepper":
        kw["stepper"] = "ros3pr"
    elif case == "ds_max":
        cfg = cfg._replace(ds_max=0.1)
    elif case == "ds_local":
        cfg = cfg._replace(ds_local_knee=4.0)
    elif case == "rk4":
        kw["adaptive"] = False
    elif case == "medium":
        env = env._replace(ps_smooth=0.1)
    elif case == "dtype":
        carry = carry._replace(t=carry.t.float())
    elif case == "shape":
        carry = carry._replace(u=torch.zeros(8, 7, dtype=torch.float64))
    elif case == "int_field":
        carry = carry._replace(status=carry.status.double())
    elif case == "device":
        f = f.to("meta")
    with pytest.raises(exc):
        sc.step_chunk(carry, f, env, cfg, spec, **kw)


def test_step_chunk_does_not_touch_its_input():
    carry, f, env, cfg, spec = _small_carry()
    before = carry_to_numpy(carry)
    out = sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3", n_steps=8)
    after = carry_to_numpy(carry)
    for name in RayCarry._fields:
        np.testing.assert_array_equal(after[name], before[name])
    assert (out.n_accept + out.n_reject == 8).all()


def test_kernel_library_path_follows_the_source():
    path = sc.library_path()
    assert path.startswith(sc.BUILD_DIR) and path.endswith(".so")
    assert "--use_fast_math" not in sc.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in sc.NVCC_FLAGS
