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


# what the kernel does not take: the steppers that were never in it (an
# adaptive ros3pr or heun2; with adaptive=False any stepper runs rk4), an
# unknown frame, more local-ceiling shells than it holds, a medium the
# port refuses (a fractional plasmasphere weight), more MLT harmonics than
# it holds, and carries of the wrong type, shape or device
@pytest.mark.parametrize("case,exc", [
    ("stepper", ValueError),
    ("frame", ValueError),
    ("ds_local", ValueError),
    ("heun2", ValueError),
    ("medium", NotImplementedError),
    ("harmonics", ValueError),
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
    elif case == "frame":
        kw["frame"] = "2d_meridian"
    elif case == "ds_local":
        cfg = cfg._replace(ds_local_knee=4.0,
                           ds_local_shells=((3.0, 0.1),) * sc.MAX_SHELLS)
    elif case == "heun2":
        kw["stepper"] = "heun2"
    elif case == "medium":
        env = env._replace(ps_weight=0.5)
    elif case == "harmonics":   # the kernel takes at most MAX_HARM
        env = env._replace(ps_mlt=1.0, ps_mlt_c=(1.0,) + (0.0,) * 18)
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


# -Xptxas -v of a build with both bodies (nvcc for sm_90a): the team body
# of the 3D full-medium float bs3 instance over the dipole (K = 4 warps a
# team, the sixth template value) and the one-thread body of the 3D
# axisymmetric float bs3 instance (K = 0), with a compile-time line between
# them
PTXAS_BOTH_BODIES = """\
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__1aa888d2_13_step_chunk_cu_54f9fbd617step_chunk_kernelIfLi0ELi1ELi1ELi0ELi4EEEvPT_S2_S2_S2_S2_S2_S2_S2_PiS3_S3_S3_S3_S3_PKS1_xiNS_7KParamsIS1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__1aa888d2_13_step_chunk_cu_54f9fbd617step_chunk_kernelIfLi0ELi1ELi1ELi0ELi4EEEvPT_S2_S2_S2_S2_S2_S2_S2_PiS3_S3_S3_S3_S3_PKS1_xiNS_7KParamsIS1_EE
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compile time = 585.993 ms
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__1aa888d2_13_step_chunk_cu_54f9fbd617step_chunk_kernelIfLi0ELi1ELi0ELi0ELi0EEEvPT_S2_S2_S2_S2_S2_S2_S2_PiS3_S3_S3_S3_S3_PKS1_xiNS_7KParamsIS1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__1aa888d2_13_step_chunk_cu_54f9fbd617step_chunk_kernelIfLi0ELi1ELi0ELi0ELi0EEEvPT_S2_S2_S2_S2_S2_S2_S2_PiS3_S3_S3_S3_S3_PKS1_xiNS_7KParamsIS1_EE
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 0 barriers, 32 bytes cumulative stack size
"""


def test_ptxas_usage_names_both_bodies():
    """Every instance keeps its registers in ptxas_usage, the team body's
    with its warps a team as the last word."""
    use = sc.ptxas_usage(PTXAS_BOTH_BODIES)
    assert use == {
        "float bs3 3d full team4": "168 registers, 32 bytes stack frame, "
                                   "0 bytes spill stores, 0 bytes spill "
                                   "loads",
        "float bs3 3d axi": "122 registers, 32 bytes stack frame, 0 bytes "
                            "spill stores, 0 bytes spill loads",
    }


def test_ptxas_usage_reads_builds_before_the_team_body():
    """A build whose kernel has five template values (before the team
    body) keeps its names."""
    old = PTXAS_BOTH_BODIES.replace("ELi4EEEv", "EEEv")
    old = old.replace("ELi0ELi0ELi0EEEv", "ELi0ELi0EEEv")
    assert sorted(sc.ptxas_usage(old)) == ["float bs3 3d axi",
                                           "float bs3 3d full"]


def test_ptxas_usage_names_the_ad_instances():
    """The AD instances (medium 5, the autodiff set) are named "ad", with
    their field where it is not the dipole; sass_census reads the same
    names."""
    from raytrace_tpu_torch import sass_census as census

    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117step_"
        "chunk_kernelIdLi1ELi1ELi5ELi2ELi0EEEvPT_'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_117step_"
        "chunk_kernelIdLi1ELi1ELi5ELi2ELi0EEEvPT_\n"
        "    1640 bytes stack frame, 430 bytes spill stores, 316 bytes "
        "spill loads\n"
        "ptxas info    : Used 255 registers\n")
    assert sc.ptxas_usage(log) == {
        "double dopri5 3d ad igrf": "255 registers, 1640 bytes stack "
                                    "frame, 430 bytes spill stores, 316 "
                                    "bytes spill loads"}
    assert census.instance_key("_ZN12_GLOBAL__N_117step_chunk_kernelIfLi0"
                               "ELi2ELi5ELi0ELi0EEEvPT_") == (
        "float bs3 2d_colat ad")


def test_sass_census_counts_the_attempt_loop():
    """The census takes the widest backward branch's span as the attempt
    loop, classes its instructions and walks its dependencies."""
    from raytrace_tpu_torch import sass_census as census

    sass = """\
        Function : _ZN12_GLOBAL__N_117step_chunk_kernelIfLi0ELi0ELi0ELi0ELi3EEEvPT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   FADD R2, R0, R1 ;
        /*0030*/                   MUFU.RCP R3, R2 ;
        /*0040*/                   FFMA R4, R3, R2, R0 ;
        /*0050*/                   STS [R0], R4 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   LDS R5, [R0] ;
        /*0080*/                   DADD R6, R4, R8 ;
        /*0090*/               @P0 BRA 0x20 ;
        /*00a0*/                   EXIT ;
"""
    funcs = census.parse(sass)
    (name, insns), = funcs.items()
    assert census.instance_key(name) == "float bs3 2d_lat axi team3"
    body = census.loop_body(insns)
    assert [op for _, _, op, _ in body][0] == "FADD" and len(body) == 8
    counts, chain, inorder = census.census(body)
    assert counts == {"fp32": 2, "mufu": 1, "shared": 2, "barrier": 1,
                      "fp64": 1, "control": 1}
    # FADD -> MUFU -> FFMA -> the exchange's store is the longest chain
    lat = census.LATENCY
    assert chain == lat["fp32"] + lat["mufu"] + lat["fp32"] + lat["shared"]
    assert inorder >= lat["fp32"] + lat["mufu"] + lat["fp32"]
