"""Port parity: ops/step_chunk.py (the port of ops/pallas_stepper.py).

On the CPU `step_chunk` runs its plain PyTorch version,
`step_chunk_reference`; these tests hold it to the JAX package's vmapped
_step_one loop (the setup of tests/test_pallas.py: 16 rays x 24 steps,
float64) and check what the wrapper refuses. The CUDA kernel itself is
held to the same plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import types
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
# unknown frame, and carries of the wrong type, shape or device
@pytest.mark.parametrize("case,exc", [
    ("stepper", ValueError),
    ("frame", ValueError),
    ("heun2", ValueError),
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
    elif case == "heun2":
        kw["stepper"] = "heun2"
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


# what the kernel once refused and takes now, held to the JAX package's
# vmapped _step_one loop (24 dopri5 steps, 1e-12, as above): a fractional
# plasmasphere weight (the 2D launch of _jax_setup), the local arc ceiling
# over the knee and MAX_SHELLS more shells (the same launch), and the MLT
# plasmapause shape of 12 harmonics, past the MAX_HARM that ride in the
# kernel's parameters (the 3D plume launch at the ds_max ceiling, where the
# ceiling sets the steps: tests/test_torch_slice_mlt.py)
@pytest.mark.parametrize("case", ["medium", "ds_local", "harmonics"])
def test_step_chunk_takes_what_it_once_refused(case):
    from raytrace_tpu import config as j_config
    from raytrace_tpu import run as j_run
    from raytrace_tpu.models import make_env as j_make_env

    env, _, cfg, spec, carry0, f = _jax_setup()
    group_idx, frame = 3, "2d_lat"
    if case == "medium":
        env = env._replace(ps_weight=0.5)
    elif case == "ds_local":
        cfg = cfg._replace(ds_local_knee=4.0, ds_local_shells=tuple(
            (3.0 + 0.5 * k, 0.1) for k in range(sc.MAX_SHELLS)))
    else:
        run_cfg = j_config.preset(
            "ensemble10k_plume", dtype="float64", lats=(0.8, 1.0),
            phis=(-2.0, 0.0, 2.0), chis=(-0.2, 0.2), freqs=(2000.0,),
            dt0=1e-4, ds_max=0.002)
        env = j_make_env(b0=3.12e-5, ps_mlt=True, ps_mlt_harmonics=12)
        u0, f = j_run._build_u0(run_cfg, np.float64)
        f = jnp.asarray(f)
        cfg, spec = run_cfg.solver(), run_cfg.stop()
        group_idx, frame = 6, "3d"
    rhs_fn = {3: lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env),
              6: lambda u, ff: j_rhs.rhs_3d(u, ff, env)}[group_idx]
    if case == "harmonics":
        carry0 = jax.vmap(lambda u, ff: j_init_carry(rhs_fn, u, ff, cfg))(
            jnp.asarray(u0), f)
    step = jax.jit(jax.vmap(partial(j_step_one, rhs_fn, cfg=cfg, spec=spec,
                                    group_idx=group_idx, adaptive=True,
                                    stepper="dopri5")))
    ref = carry0
    for _ in range(N_STEPS):
        ref = step(ref, f)
    carry, ft, te, tcfg, tspec = _port_args(env, cfg, spec, carry0, f)
    assert sc.medium_code(te, tcfg) == sc.ANY
    got = carry_to_numpy(sc.step_chunk(carry, ft, te, tcfg, tspec,
                                       stepper="dopri5", n_steps=N_STEPS,
                                       frame=frame))
    for name in RayCarry._fields:
        want = np.asarray(getattr(ref, name))
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        elif want.ndim == 2:   # per component against its scale
            scale = np.maximum(np.abs(want).max(axis=0), 1e-300)
            atol = 1e-12 if name == "u_lo" else 0.0
            assert (np.abs(got[name] - want) <= 1e-12 * scale + atol).all(), \
                name
        else:
            np.testing.assert_allclose(got[name], want, rtol=1e-12,
                                       atol=1e-12 if name == "errold" else 0,
                                       err_msg=name)


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


def test_ptxas_usage_names_the_wide_instances():
    """The ANY and AD_ANY instances (media 6 and 7) are named "any" and
    "ad_any", with their field where it is not the dipole."""
    from raytrace_tpu_torch import sass_census as census

    assert census.instance_key("_ZN12_GLOBAL__N_117step_chunk_kernelIfLi0"
                               "ELi1ELi6ELi1ELi0EEEvPT_") == (
        "float bs3 3d any tilted")
    assert census.instance_key("_ZN12_GLOBAL__N_117step_chunk_kernelIdLi2"
                               "ELi0ELi7ELi0ELi0EEEvPT_") == (
        "double rk4 2d_lat ad_any")


# which instances a medium beyond the presets' takes (medium_code): the
# weights other than 0 and 1, more MLT harmonics or more local-ceiling
# shells than the kernel's parameters hold take ANY under the fused and
# the reference sets and legacy_freq_state, and the counts take AD_ANY
# under the autodiff set, which blends the weights in AD; a shape of no
# harmonic and the presets' media keep their instances
_PLUME = dict(b0=3.12e-5, ps_mlt=True)
_KNEE = dict(ds_local_knee=4.0)


@pytest.mark.parametrize("env_kw,cfg_kw,codes", [
    ({}, {}, (sc.AXI, sc.ALT, sc.ALT, sc.AD)),
    (dict(ps_weight=0.5), {}, (sc.ANY, sc.ANY, sc.ANY, sc.AD)),
    (dict(de_weight=0.25), {}, (sc.ANY, sc.ANY, sc.ANY, sc.AD)),
    (dict(_PLUME, ps_mlt_harmonics=0), {}, (sc.FULL, sc.ALTX, sc.ALTX,
                                            sc.AD)),
    (dict(_PLUME, ps_mlt_harmonics=sc.MAX_HARM), {}, (sc.FULL, sc.ALTX,
                                                      sc.ALTX, sc.AD)),
    (dict(_PLUME, ps_mlt_harmonics=sc.MAX_HARM + 1), {},
     (sc.ANY, sc.ANY, sc.ANY, sc.AD_ANY)),
    ({}, dict(_KNEE, ds_local_shells=((3.0, 0.1),) * (sc.MAX_SHELLS - 1)),
     (sc.EXT, sc.ALTX, sc.ALTX, sc.AD)),
    ({}, dict(_KNEE, ds_local_shells=((3.0, 0.1),) * sc.MAX_SHELLS),
     (sc.ANY, sc.ANY, sc.ANY, sc.AD_ANY)),
])
def test_medium_code_takes_the_wide_instances(env_kw, cfg_kw, codes):
    from raytrace_tpu_torch.models import medium

    weights = {k: env_kw.pop(k) for k in ("ps_weight", "de_weight")
               if k in env_kw}
    env = medium.make_env(**{"b0": 3.12e-5, **env_kw})._replace(**weights)
    cfg = SolverConfig()._replace(**cfg_kw)
    got = (sc.medium_code(env, cfg), sc.medium_code(env, cfg, "reference"),
           sc.medium_code(env, cfg, "fused", True),
           sc.medium_code(env, cfg, "autodiff"))
    assert got == codes
    assert sc.wide(env, cfg) == (sc.ANY in codes)


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


@pytest.mark.parametrize("listed", ["both", "one"])
def test_sass_census_dumps_only_the_wanted_entry_points(monkeypatch,
                                                        listed):
    """run_census takes the wanted instances' mangled names from the
    build's log and asks cuobjdump for those alone (-fun); where that
    listing misses one of them, it disassembles the whole library."""
    from raytrace_tpu_torch import sass_census as census

    names = {"float bs3 2d_lat axi": "_ZN12_GLOBAL__N_117step_chunk_kernel"
                                     "IfLi0ELi0ELi0ELi0ELi0EEEvPT_",
             "float bs3 3d full tilted": "_ZN12_GLOBAL__N_117step_chunk_"
                                         "kernelIfLi0ELi1ELi1ELi1ELi0EEEvPT_",
             "double bs3 2d_lat axi": "_ZN12_GLOBAL__N_117step_chunk_kernel"
                                      "IdLi0ELi0ELi0ELi0ELi0EEEvPT_"}
    log = "".join(f"ptxas info    : Compiling entry function '{n}' for "
                  f"'sm_90a'\n" for n in names.values())
    assert census.entry_names(log) == sorted(names.values())

    def listing(keys):
        return "".join(
            f"        Function : {names[k]}\n"
            "        /*0000*/                   FADD R2, R0, R1 ;\n"
            "        /*0010*/                   EXIT ;\n" for k in keys)

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd[2:-1])
        if "-fun" in cmd:
            keys = [k for k, n in names.items() if n in cmd[3].split(",")]
            keys = keys if listed == "both" else keys[:1]
        else:
            keys = list(names)
        return types.SimpleNamespace(stdout=listing(keys), returncode=0)

    monkeypatch.setattr(census.subprocess, "run", fake_run)
    wanted = {"float bs3 2d_lat axi", "float bs3 3d full tilted"}
    out = census.run_census("lib.so", wanted, census.entry_names(log))
    assert set(out) == wanted
    picked = ",".join(names[k] for k in sorted(names) if k in wanted)
    assert calls[0] == ["-fun", ",".join(sorted(picked.split(",")))]
    assert calls[1:] == ([] if listed == "both" else [[]])
    calls.clear()
    assert set(census.run_census("lib.so", wanted)) == wanted
    assert calls == [[]]


def test_sass_census_sizes_the_attempt_loop():
    """The loop's size in bytes runs from its first instruction to the end
    of its backward branch, each instruction as wide as the address step
    (16 bytes on Hopper), and the bytes by class add up to it; the
    encoding lines of cuobjdump's listing are not instructions."""
    from raytrace_tpu_torch import sass_census as census

    sass = """\
        Function : _ZN12_GLOBAL__N_117step_chunk_kernelIfLi0ELi2ELi0ELi0ELi0EEEvPT_
        /*0100*/                   MOV R2, c[0x0][0x210] ;     /* 0x0000840000027a02 */
                                                               /* 0x000fe20000000f00 */
        /*0110*/                   FMUL R4, R2, 0.5 ;          /* 0x3f00000002047820 */
                                                               /* 0x000fc80000400000 */
        /*0120*/                   MUFU.RCP R5, R4 ;           /* 0x0000000400057308 */
                                                               /* 0x000e240000001000 */
        /*0130*/                   FCHK P0, R2, R4 ;           /* 0x0000000402007302 */
                                                               /* 0x000e620000000000 */
        /*0140*/               @P0 CALL.REL.NOINC 0x400 ;      /* 0x0000000000007944 */
                                                               /* 0x000fea0003c00000 */
        /*0150*/                   FADD R6, R5, R2 ;           /* 0x0000000205067221 */
                                                               /* 0x001fca0000000000 */
        /*0160*/                   ISETP.GE.AND P1, PT, R6, RZ, PT ;
        /*0170*/               @P1 BRA 0x110 ;                 /* 0xffffff9000001947 */
        /*0180*/                   EXIT ;                      /* 0x000000000000794d */
"""
    (name, insns), = census.parse(sass).items()
    assert census.instance_key(name) == "float bs3 2d_colat axi"
    assert len(insns) == 9
    assert census.parse(sass, keep=lambda n: False) == {}
    body = census.loop_body(insns)
    assert [op for _, _, op, _ in body] == [
        "FMUL", "MUFU.RCP", "FCHK", "CALL.REL.NOINC", "FADD", "ISETP.GE.AND",
        "BRA"]
    size, by_class = census.code_bytes(body)
    assert size == 0x170 - 0x110 + 16 == 7 * 16
    assert by_class == {"fp32": 48, "mufu": 16, "control": 32, "int": 16}
    assert sum(by_class.values()) == size
    assert census.code_bytes([]) == (0, {})


@pytest.mark.parametrize("b,layout,want", [
    (1, True, 4), (31, True, 4), (527, True, 4), (528, True, 4),
    (529, True, 0), (10240, True, 0), (0, True, 0), (528, False, 0),
    (1, False, 0)])
def test_tail_layout_rule(b, layout, want):
    """A launch takes the tail layout (flag bit 4, one ray a warp) where
    its instance has it and it has at most TAIL_LAYOUT_MAX_RAYS = 528 rays
    (132 SMs x 4 warp schedulers); finish and fresh keep bits 1 and 2."""
    assert sc.TAIL_LAYOUT_MAX_RAYS == 528
    assert sc.launch_flags(b, layout=layout) == want
    assert sc.launch_flags(b, finish=True, fresh=True,
                           layout=layout) == 3 | want
    assert sc.launch_flags(b, fresh=True, layout=layout) == 2 | want


@pytest.mark.parametrize("b,team,want", [
    (1, True, 4), (264, True, 4), (265, True, 0), (528, True, 0),
    (264, False, 4), (528, False, 4), (529, False, 0)])
def test_team_body_tail_layout_limit(b, team, want, monkeypatch):
    """An instance whose tail layout is the team body (the float32 bs3 ones
    over the non-axial fields) takes it at most TEAM_LAYOUT_MAX_RAYS = 264
    rays (measured faster there, slower at 528); the one-ray-a-warp layout
    keeps TAIL_LAYOUT_MAX_RAYS; both thresholds at 0 give the dense
    layout."""
    assert sc.TEAM_LAYOUT_MAX_RAYS == 264
    assert sc.launch_flags(b, layout=True,
                           limit=sc.layout_limit(team)) == want
    assert sc.layout_limit(False) == sc.TAIL_LAYOUT_MAX_RAYS
    monkeypatch.setattr(sc, "TAIL_LAYOUT_MAX_RAYS", 0)
    assert sc.launch_flags(b, layout=True, limit=sc.layout_limit(team)) == 0


def test_launch_counters_read_the_flag_bits(monkeypatch):
    """Each launch counts once, and once more on the counter of each of
    its flags: the team body, finish, fresh and the tail layout
    (step_chunk.sparse_launches)."""
    names = ("launches", "team_launches", "finish_launches",
             "fresh_launches", "sparse_launches")
    for name in names:
        monkeypatch.setattr(sc.step_chunk, name, 0)
    sc.count_launch(sc.launch_flags(41, fresh=True, layout=True))
    sc.count_launch(sc.launch_flags(10240, finish=True, layout=True))
    sc.count_launch(sc.launch_flags(32, finish=True), team=True)
    assert [getattr(sc.step_chunk, n) for n in names] == [3, 1, 2, 1, 1]


def test_sass_census_finds_the_attempt_loop_inside_the_pass_loop():
    """The pass loop (fresh's right-hand side, the attempts, finish's) is
    the function's widest loop; the attempt loop is the widest one inside
    it (the bisection of finish is narrower), and bs3's stage loop inside
    that is its inner loop."""
    from raytrace_tpu_torch import sass_census as census

    ops = {0x10: "FADD R1, R1, R2", 0x20: "FMUL R1, R1, R2",
           0x30: "MUFU.RCP R4, R1", 0x40: "FMUL R1, R4, R1",
           0x50: "@P0 BRA 0x30", 0x60: "FSETP.GT.AND P1, PT, R1, R2, PT",
           0x70: "@P1 BRA 0x20", 0x80: "FADD R5, R5, R1",
           0x90: "FADD R5, R5, R2", 0xa0: "@P2 BRA 0x80",
           0xb0: "@P3 BRA 0x10", 0xc0: "EXIT"}
    sass = ("Function : _ZN12_GLOBAL__N_117step_chunk_kernelIfLi0ELi0ELi0E"
            "Li0ELi0EEEvPT_\n" + "".join(
                f"        /*{a:04x}*/  {op} ;\n" for a, op in ops.items()))
    (_name, insns), = census.parse(sass).items()
    body = census.loop_body(insns)
    assert (body[0][0], body[-1][0]) == (0x20, 0x70)
    assert census.inner_loop(body) == 3
    assert census.inner_loop(body[1:3]) == 0
    lat = census.LATENCY
    # FMUL, MUFU, FMUL, the compare and its branch: one pass
    assert census.census(body)[1] == (
        lat["fp32"] + lat["mufu"] + lat["fp32"] + lat["fp32"]
        + lat["control"])


def test_sass_census_follows_the_out_of_line_right_hand_side():
    """An attempt loop that CALLs its right-hand side (the one-thread
    general-field instances' rhs_3d_general, placed after the kernel's
    code): the callee's chain counts once per call site in
    chain_cycles_total; a call to a short piece of code (a division's slow
    path) does not."""
    from raytrace_tpu_torch import sass_census as census

    pad = census.SLOW_PATH_MAX
    slow_at = 0xe0 + 16 * pad
    ops = {0x10: "FADD R1, R1, R2", 0x20: "CALL.REL.NOINC 0xa0",
           0x30: "CALL.REL.NOINC 0xa0", 0x40: "FMUL R1, R1, R2",
           0x50: f"CALL.REL.NOINC {slow_at:#x}",
           0x60: "CALL.REL.NOINC 0xa0",
           0x70: "@P1 BRA 0x20", 0x80: "@P2 BRA 0x10", 0x90: "EXIT",
           # the right-hand side
           0xa0: "MUFU.RSQ R4, R1", 0xb0: "FMUL R4, R4, R1",
           0xc0: "FMUL R4, R4, R4",
           **{0xd0 + 16 * k: "NOP" for k in range(pad)},
           0xd0 + 16 * pad: "RET.REL.NODEC R20 0x0",
           # a slow path
           slow_at: "MUFU.RCP R6, R6",
           slow_at + 0x10: "RET.REL.NODEC R20 0x0"}
    sass = ("Function : _ZN12_GLOBAL__N_117step_chunk_kernelIfLi0ELi1ELi1E"
            "Li1ELi0EEEvPT_\n" + "".join(
                f"        /*{a:04x}*/  {op} ;\n" for a, op in ops.items()))
    (_name, insns), = census.parse(sass).items()
    rec = census.instance_census(insns)
    (call,) = rec["calls"]
    lat = census.LATENCY
    chain = lat["mufu"] + 2 * lat["fp32"]
    assert (call["target"], call["sites"], call["instructions"],
            call["chain_cycles"]) == ("0xa0", 3, 4 + pad, chain)
    assert rec["chain_cycles_total"] == rec["chain_cycles"] + 3 * chain
    assert "helper_loop" not in rec


def test_sass_census_finds_the_team_body_helper_loop():
    """A team-body instance: the pass loop is the loop that holds the
    attempt loop with warp 0's barriers, even where the helpers' loop
    (two barriers, the pieces between them) is wider; the helper loop's
    chain counts once for each right-hand side of an attempt (warp 0's
    barriers / 2)."""
    from raytrace_tpu_torch import sass_census as census

    ops = {0x10: "FADD R1, R1, R2", 0x20: "BAR.SYNC.DEFER_BLOCKING 0x0",
           0x30: "BAR.SYNC.DEFER_BLOCKING 0x0", 0x40: "LDS R3, [R0]",
           0x50: "BAR.SYNC.DEFER_BLOCKING 0x0",
           0x60: "BAR.SYNC.DEFER_BLOCKING 0x0", 0x70: "FMUL R1, R3, R1",
           0x80: "@P1 BRA 0x20", 0x90: "@P2 BRA 0x10", 0xa0: "EXIT",
           0xb0: "BAR.SYNC.DEFER_BLOCKING 0x0", 0xc0: "LDS R5, [R0]",
           0xd0: "MUFU.SIN R6, R5", 0xe0: "MUFU.COS R7, R5",
           0xf0: "FMUL R8, R6, R7", 0x100: "FMUL R8, R8, R6",
           0x110: "FMUL R8, R8, R7", 0x120: "FADD R8, R8, R6",
           0x130: "FMUL R8, R8, R5", 0x140: "STS [R0], R8",
           0x150: "BAR.SYNC.DEFER_BLOCKING 0x0", 0x160: "@P3 BRA 0xb0",
           0x170: "EXIT"}
    sass = ("Function : _ZN12_GLOBAL__N_117step_chunk_kernelIfLi0ELi1ELi1E"
            "Li1ELi4EEEvPT_\n" + "".join(
                f"        /*{a:04x}*/  {op} ;\n" for a, op in ops.items()))
    (name, insns), = census.parse(sass).items()
    assert census.instance_key(name) == "float bs3 3d full tilted team4"
    body = census.loop_body(insns)
    assert (body[0][0], body[-1][0]) == (0x20, 0x80)
    rec = census.instance_census(insns)
    assert rec["rhs_per_attempt"] == 2
    helper = rec["helper_loop"]
    assert helper["instructions"] == 12
    assert rec["chain_cycles_total"] == (rec["chain_cycles"]
                                         + 2 * helper["chain_cycles"])
    both = {"float bs3 3d full tilted team4": rec,
            "float bs3 3d full tilted": {}, "float bs3 3d full igrf": {}}
    assert census.bodies(both, "float bs3 3d full tilted") == {
        "float bs3 3d full tilted team4": rec,
        "float bs3 3d full tilted": {}}


def test_ptxas_usage_names_the_group_body():
    """The group body of an AD instance (K = -G lanes a ray, mangled as a
    negative template value) is named with "group<G>" after its
    instance's name, beside the one-thread body; sass_census.bodies gives
    both under the instance's name."""
    from raytrace_tpu_torch import sass_census as census

    def line(k):
        return (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N"
                f"_117step_chunk_kernelIfLi0ELi1ELi5ELi1EL{k}EEEvPT_'\n"
                f"ptxas info    : Used {150 if k == 'i0' else 96} "
                "registers\n")

    use = sc.ptxas_usage(line("i0") + line("in8"))
    assert use == {"float bs3 3d ad tilted": "150 registers, ",
                   "float bs3 3d ad tilted group8": "96 registers, "}
    assert census.instance_key("_ZN12_GLOBAL__N_117step_chunk_kernelIfLi0"
                               "ELi0ELi5ELi0ELin4EEEvPT_") == (
        "float bs3 2d_lat ad group4")
    got = census.bodies({k: k for k in (*use, "float bs3 3d ad")},
                        "float bs3 3d ad tilted")
    assert sorted(got) == sorted(use)


def test_launch_counters_count_the_group_body(monkeypatch):
    """A launch with the group body's flag bit 8 counts on
    step_chunk.group_launches; the group body takes no tail layout (bit
    4), whatever the layout arguments say."""
    names = ("launches", "group_launches", "sparse_launches")
    for name in names:
        monkeypatch.setattr(sc.step_chunk, name, 0)
    lat, tilted = (0, 0, 0, sc.AD, 0), (0, 0, 1, sc.AD, 1)
    monkeypatch.setattr(sc, "GROUP_MAX_RAYS", {lat: 1000, tilted: 100})
    for b in (45, 500, 5000):
        sc.count_launch(sc.launch_flags(b, finish=True, layout=True,
                                        group=lat))
        sc.count_launch(sc.launch_flags(b, group=tilted))
    sc.count_launch(sc.launch_flags(45, layout=True))
    assert [getattr(sc.step_chunk, n) for n in names] == [7, 3, 1]


@pytest.mark.parametrize("cell,parsed,instance", [
    ("ensemble10k:float64:grad_mode=autodiff",
     ("ensemble10k", "float64", {"grad_mode": "autodiff"}),
     "double bs3 2d_lat ad"),
    ("ensemble10k_local:float64:grad_mode=autodiff",
     ("ensemble10k_local", "float64", {"grad_mode": "autodiff"}),
     "double bs3 2d_lat ad"),
    ("ensemble10k_3d:float64:grad_mode=autodiff",
     ("ensemble10k_3d", "float64", {"grad_mode": "autodiff"}),
     "double bs3 3d ad"),
    ("ensemble10k_tilted:grad_mode=autodiff",
     ("ensemble10k_tilted", "float32", {"grad_mode": "autodiff"}),
     "float bs3 3d ad tilted"),
    ("ensemble10k:frame=2d_colat",
     ("ensemble10k", "float32", {"frame": "2d_colat"}),
     "float bs3 2d_colat axi"),
])
def test_tools_name_the_instance_of_a_cell(cell, parsed, instance):
    """A cell of kernel_ab --tails and latency_floor --cells,
    "preset[:dtype][:field=value...]", parses to its preset, dtype (float32
    unless named) and overrides, and names the bs3 instance of its dtype
    ("double ..." for a float64 cell) as sass_census names it; a captured
    tail rebuilds its RunConfig in the dtype it was captured in (float32
    for a tail saved without one)."""
    from raytrace_tpu_torch import kernel_ab, latency_floor

    assert kernel_ab.tail_spec(cell) == parsed
    assert latency_floor._instance(cell) == instance
    name, dtype, over = parsed
    tail = dict(name=name, dtype=dtype, over=over)
    conf = latency_floor.tail_config(tail)
    assert (conf.name, conf.dtype) == (name, dtype)
    assert all(getattr(conf, k) == v for k, v in over.items())
    del tail["dtype"]
    assert latency_floor.tail_config(tail).dtype == "float32"
