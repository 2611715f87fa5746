"""Multi-step integration chunk: the port of ops/pallas_stepper.py.

`step_chunk(carry, f, env, cfg, spec, stepper=..., n_steps=..., frame=...)`
advances every ray by exactly `n_steps` attempted `_step_one` steps (a
ray that stops earlier stays as it stopped, as in the JAX package) over
the frame's right-hand side -- `rhs_2d_lat` (frame "2d_lat", 4-state
carry), `rhs_2d_colat` (frame "2d_colat", 4-state) or `rhs_3d` (frame
"3d", 7-state carry) -- with bs3 or dopri5 under the step controller
(the ds_max arc ceiling when cfg.ds_max > 0, the local arc ceiling when
cfg.ds_local_knee > 0) or, with adaptive=False, fixed rk4 steps, and
returns the new RayCarry. The kernel
takes the axisymmetric medium of the first slices in its own instances
and every other medium (`medium_code`) through the full density chain;
the tilted dipole and the IGRF truncation (`field_code`, 3D frame only)
have instances of their own over the full chain, with the general
geometry chain of ops/fused.py::mu_and_grads_3d_general called; a medium
with He+ or O+, and a run with the local arc ceiling, take the EXT
instances of the full chain, whose Stix sums run over the ion species and
whose step ceiling takes the local one. The reference scripts' modes
(grad_mode="reference": the closed-form dmu/dpsi, dmu/dr = 0 and in 3D the
Kimura rho partials; legacy_freq_state: the 2D frequency read as f + T)
take the ALT instances -- the axisymmetric medium with both as run-time
flags -- and over every other medium of the centered dipole the ALTX
instances: the extended chain of EXT (the full density chain, the Stix
sums over the ion species, the local ceiling) with the same two flags.
The autodiff gradient set (grad_mode="autodiff": the exact derivatives
of the traced mu in forward mode, ops/dual.py) takes the AD instances in
every frame and field: the value chain of ops/dispersion.py over the
whole medium, evaluated once on dual numbers whose tangents follow
torch's forward-mode formulas, every medium feature, the species, the
local ceiling and (2D) legacy_freq_state at run time.
Two more medium codes take what the JAX package takes beyond its presets'
media, each in instances of its own so that the others keep their code: a
plasmasphere or DE weight other than 0 and 1, more than MAX_HARM MLT
harmonics or more than MAX_SHELLS local-ceiling shells take ANY (the ALTX
chain, or EXT's over the non-axial fields, with the weights blended and the
harmonics and shells past those of the parameters read from buffers on
the card, `_overflow`), and under the autodiff set, the counts take AD_ANY
(AD blends the weights itself).

Two flags end or start a trace inside the launch: `finish` refines, after
the attempts, every ray that ends on HIT_EARTH or HIT_EQUATOR
(integrate.solve.refine_events), and `fresh` first sets k1 = rhs(u) for
every ray (init_carry's right-hand side; the incoming k1 is not read).

- On CUDA tensors it launches the hand-written kernel of
  csrc/step_chunk.cu, the whole carry in registers for all n_steps
  attempts: one thread per ray, or (the 3D full chain over the dipole) a
  team of four warps per 32 rays, one lane of each a ray: warp 0 steps
  them, three helper warps compute the pieces of each right-hand side
  (`team_warps`). A launch of few rays (`layout_limit`: at most
  TAIL_LAYOUT_MAX_RAYS, or TEAM_LAYOUT_MAX_RAYS) on an instance that
  takes the tail layout (`tail_layout`, `launch_flags`) runs one ray a warp
  (the main path's 2D float bs3 instances) or on the team body (the
  float32 bs3 instances over the tilted dipole and IGRF, whose wider
  launches run on the one-thread body). The bs3 AD instances of the 2D
  latitude frame (float32 and float64), of the tilted dipole (float32) and
  of the 3D frame over the dipole (float64; `group_lanes`) also have a
  group body, a group of lanes a ray, each lane with one tangent row of
  the dual chain, which a launch of at most GROUP_MAX_RAYS[codes] rays
  takes (`launch_flags`).
  The kernel is built from the source at first use
  with nvcc for sm_90a into raytrace_tpu_torch/_build/ (rebuilt when the
  source changes; PARTS nvcc processes at once, linked into one library)
  and loaded with ctypes. There is no fallback: a CUDA
  tensor launches the kernel or raises.
- On CPU tensors it runs `step_chunk_reference`, the plain PyTorch loop of
  `integrate.solve._step_one`, after the frame's right-hand side (fresh)
  and before `refine_events` (finish).

`step_chunk.launches` counts kernel launches (`step_chunk.team_launches`
those through the team body, `step_chunk.group_launches` those through the
group body, `step_chunk.sparse_launches` those in the tail layout,
`step_chunk.finish_launches` and
`step_chunk.fresh_launches` those with each flag) and
`step_chunk_reference.calls` counts calls of the plain version.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

import torch

from ..integrate import events
from ..integrate.solve import (
    KERNEL_STEPPERS, RayCarry, SolverConfig, check_supported, refine_events,
    step_loop,
)
from ..models import dipole, medium
from . import fused, gradients
from . import rhs as rhs_mod
from .dispersion import ion_species

# frame name -> (kernel frame code, state dimension)
_FRAME_CODE = {"2d_lat": (0, 4), "3d": (1, 7), "2d_colat": (2, 4)}
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "step_chunk.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
# no --use_fast_math (isfinite, the inf stop defaults and the two-sum need
# IEEE semantics); -fmad=false keeps every product and sum separately
# rounded, as in the plain PyTorch version (see the note in the source)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the source compiles as PARTS objects at once (-DSC_PARTS, -DSC_PART: one
# per frame, one per non-axial field, one for the reference scripts' modes
# over the axisymmetric medium, two for them over the extended chain, three
# for the autodiff set, three for ANY and three for AD_ANY,
# csrc/step_chunk.cu), linked into one library
PARTS = 17

# harmonics of the MLT plasmapause shape that ride in the kernel's
# parameters (kMaxHarm); the ANY and AD_ANY instances read any further ones
# from a buffer on the card (_overflow)
MAX_HARM = 8
# shells of the local arc ceiling that ride in its parameters, the knee
# first (kMaxShells); any further ones likewise
MAX_SHELLS = 4
# ion species: protons, He+, O+ (kMaxIon)
MAX_ION = 3
# The tail layout (csrc/step_chunk.cu, tail_layout): a launch of at most
# this many rays, on an instance that takes the layout, runs one ray a warp
# in blocks of four warps. 528 = 132 SMs x 4 warp schedulers of an H100:
# up to it no two rays share a warp (whose lanes would run each
# data-dependent branch of the other's chain in turn) and each ray's warp
# can have a scheduler to itself; beyond it one-ray warps queue for the
# schedulers. Measured on an H100 (python -m
# raytrace_tpu_torch.latency_floor, PERF.md): 528 rays of ensemble10k x 512
# attempts took 2.07-2.09 ms one ray a warp against 2.21-2.23 ms 32 a
# warp, 1,056 rays 2.40-2.42 against 2.21-2.26 ms, and its merged tail (41
# rays padded to 256) 57.5 against 61.4 ms.
TAIL_LAYOUT_MAX_RAYS = 528
# The float32 bs3 instances over the non-axial fields run their tail
# layout on the team body (four warps a ray, csrc/step_chunk.cu), in a launch
# of at most this many rays (layout_limit). Measured on an H100 (latency_floor
# (f), PERF.md), 512 attempts from the launch carry, team / one-thread body:
# tilted 4.44 / 4.90 ms at 132 rays, 4.36 / 4.90 at 264, 5.50 / 4.88 at
# 528; IGRF 4.15-4.24 / 5.50, 4.45 / 5.37, 5.68-5.77 / 5.45; at the full
# 10,240 the team body ran 1.15x / 1.27x the one-thread body's time.
TEAM_LAYOUT_MAX_RAYS = 264
_VEC = ("u", "k1", "u_prev", "u_lo")
_INT = ("status", "n_accept", "n_reject", "rejected", "n_tiny", "caution")
# kernel stepper codes; rk4 is what adaptive=False runs, whatever the
# stepper argument names
_STEPPER_CODE = {"bs3": 0, "dopri5": 1, "rk4": 2}
_FIELD_CODE = {"dipole": 0, "tilted": 1, "igrf": 2}
# the kernel's medium codes (medium_code): AXI, FULL, EXT, and ALT and ALTX,
# the axisymmetric medium and the extended chain under the reference
# scripts' modes, AD, any medium and field under the autodiff set, and ANY
# and AD_ANY, the extended chain and the autodiff set at any weight,
# harmonic count and shell count
AXI, FULL, EXT, ALT, ALTX, AD, ANY, AD_ANY = 0, 1, 2, 3, 4, 5, 6, 7
_MEDIUM_NAMES = ("axi", "full", "ext", "alt", "altx", "ad", "any", "ad_any")
# The group body of four AD instances (csrc/step_chunk.cu, group_instance:
# the bs3 ones of the 2D latitude frame in float32 and float64, 4 lanes a
# ray, over the tilted dipole in float32, 8, and over the dipole in the 3D
# frame in float64, 8; each lane with one tangent row): a launch of at most
# GROUP_MAX_RAYS[codes] rays, codes the instance's (dtype, stepper, frame,
# medium, field) as step_chunk passes them, takes it (flag bit 8), where it
# measured faster than the one-thread body (latency_floor (a) and (f) on an
# H100, PERF.md), 512 attempts, group / one-thread body:
# - float32 2D: every width (10,240 rays 9.53 against 12.14 ms, 132-2,112
#   rays 8.3-8.7 against 11.7-12.7; the merged tails 0.71x);
# - float32 tilted: up to 6,336 rays, those of one wave (3 blocks of 16
#   rays an SM at 137 registers): 132-4,224 rays 11.7-12.0 against
#   20.9-21.6 ms, 6,336 14.1 against 21.6, 8,448 24.0 against 21.7, 10,240
#   24.6 against 22.1 (the merged tail 0.56x);
# - float64 2D: up to 8,448 rays, one wave (2 blocks of 32 rays an SM at
#   210 registers): 132-4,224 rays 13.4-13.7 against 19.9-20.2 ms, 6,336
#   and 8,448 14.9-15.1 against 20.2, 10,240 28.2-28.4 against 20.1-20.3
#   (the tails 0.67x);
# - float64 3D: up to 8,448 rays, two waves (2 blocks of 16 rays an SM at
#   255 registers): 132-2,112 rays 14.3-14.7 against 34.7-35.6 ms, 4,224
#   15.5-15.7 against 35.6, 6,336 29.2-29.5 against 35.2-35.5, 8,448
#   30.6-30.8 against 35.5, 10,240 42.0-42.4 against 35.2-35.5 (three
#   waves; the one-ray tail 0.42x).
GROUP_MAX_RAYS = {
    (0, 0, 0, AD, 0): 2 ** 31 - 1,  # float32 bs3 2d_lat AD
    (0, 0, 1, AD, 1): 6336,         # float32 bs3 3d AD, tilted dipole
    (1, 0, 0, AD, 0): 8448,         # float64 bs3 2d_lat AD
    (1, 0, 1, AD, 0): 8448,         # float64 bs3 3d AD, dipole
}


class StepParams(ctypes.Structure):
    """Scalars passed to the kernel by value (mirror of the C struct
    StepParams in csrc/step_chunk.cu; 123 doubles and two pointers, 1,000
    bytes). The medium codes: AXI (0), FULL (1), EXT (2), ALT (3), ALTX
    (4), AD (5, the autodiff set), ANY (6) and AD_ANY (7; medium_code)."""

    _fields_ = [(name, ctypes.c_double) for name in (
        # medium (make_env_lat feature set) and root
        "b0", "iono_n0", "iono_decay", "iono_r0", "lppi", "lppo",
        "ne_lppi", "ps_season", "ps_trough", "ps_weight", "de_weight",
        "root",
        # SolverConfig
        "rtol", "atol", "dt_min", "dt_max", "safety", "pi_alpha",
        "pi_beta", "fac_min", "fac_max", "accept_tol", "stall_dt_factor",
        "stall_count", "ds_max",
        # StopSpec
        "r_floor", "r_ceil", "t_max", "group_time_max", "stop_at_equator",
        "lat_sign", "lat_offset", "stop_retrograde",
        # the full medium: env fields (gcpm 1.0 = ps_model "gcpm")
        "iono_n0_b", "iono_decay_b", "iono_mix", "gcpm", "gcpm_bpow",
        "ps_smooth", "ps_refill", "ps_refill_q", "duct_amp", "duct_l0",
        "ps_mlt", "ps_mlt_a0", "ps_mlt_tamp", "ps_mlt_c3", "n_harm",
        # ... and the env-only subexpressions (fused.MediumConsts)
        *fused.MediumConsts._fields,
    )] + [
        ("ps_mlt_c", ctypes.c_double * (1 + 2 * MAX_HARM)),
        # the non-axial fields: dipole.moment_unit, dipole.mlon_axes and
        # the 15 Schmidt coefficients
        ("b_mom", ctypes.c_double * 3), ("b_xm", ctypes.c_double * 3),
        ("b_ym", ctypes.c_double * 3), ("igrf", ctypes.c_double * 15),
        # the local arc ceiling: frac, the shell count (0 = off), and each
        # shell's L and width, the knee first
        ("ds_local_frac", ctypes.c_double), ("n_shells", ctypes.c_double),
        ("shell_l", ctypes.c_double * MAX_SHELLS),
        ("shell_w", ctypes.c_double * MAX_SHELLS),
        # the ion species (dispersion.ion_species): count and coefficients
        ("n_ion", ctypes.c_double), ("ion_fpe2", ctypes.c_double * MAX_ION),
        ("ion_fce", ctypes.c_double * MAX_ION),
        # the reference scripts' modes (ALT and ALTX instances only; AD
        # reads legacy_freq): 1.0 = on
        ("ref_grads", ctypes.c_double), ("legacy_freq", ctypes.c_double),
        # the divisors of the density chain that the AD instances' value
        # chain divides by as the plain version does (1 / x formed in the
        # run dtype): the GCPM scale and knee, the duct's width
        ("gcpm_lscale", ctypes.c_double), ("gcpm_knee", ctypes.c_double),
        ("duct_w", ctypes.c_double),
        # the MLT coefficients past MAX_HARM harmonics and the shells past
        # MAX_SHELLS ((L, width) pairs), on the card in the run dtype
        # (_overflow; NULL where there are none)
        ("mlt_ext", ctypes.c_void_p), ("shell_ext", ctypes.c_void_p),
    ]


_LIB = None
BUILD_LOG = ""      # nvcc's output of the last build (-Xptxas -v)
BUILD_SECONDS = 0.0
BUILD_PART_SECONDS = []     # each part's nvcc wall in the last build


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the step kernel builds only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path():
    """Path of the shared library for the current source and flags."""
    with open(SOURCE, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                           + f" parts {PARTS}".encode())
    return os.path.join(BUILD_DIR, f"step_chunk_{h.hexdigest()[:16]}.so")


def build():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle. The PARTS objects compile in parallel nvcc processes into a
    temporary directory and link into a temporary name that is then
    renamed, so a cut build never leaves a half-written library behind."""
    global _LIB, BUILD_LOG, BUILD_SECONDS, BUILD_PART_SECONDS
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        work = tempfile.mkdtemp(dir=BUILD_DIR)
        objs = [os.path.join(work, f"part{k}.o") for k in range(PARTS)]
        tmp = os.path.join(work, "step_chunk.so")
        t0 = time.perf_counter()
        try:
            procs = []
            for k, obj in enumerate(objs):
                # each part's output goes to a file: no pipe to fill
                with open(obj + ".log", "w") as log:
                    procs.append(subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, f"-DSC_PARTS={PARTS}",
                         f"-DSC_PART={k}", "-c", "-o", obj, SOURCE],
                        stdout=log, stderr=subprocess.STDOUT))
            done = {}
            while len(done) < len(procs):
                for k, proc in enumerate(procs):
                    if k not in done and proc.poll() is not None:
                        done[k] = time.perf_counter() - t0
                time.sleep(0.05)
            BUILD_PART_SECONDS = [done[k] for k in range(len(procs))]
            rcs = [proc.returncode for proc in procs]
            BUILD_LOG = ""
            for obj in objs:
                with open(obj + ".log") as log:
                    BUILD_LOG += log.read()
            if not any(rcs):
                link = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                    capture_output=True, text=True)
                BUILD_LOG += link.stdout + link.stderr
                rcs.append(link.returncode)
            BUILD_SECONDS = time.perf_counter() - t0
            if any(rcs):
                raise RuntimeError(
                    f"nvcc failed building {SOURCE}:\n{BUILD_LOG}")
            os.replace(tmp, path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(path)
    lib.step_chunk_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(StepParams), ctypes.c_void_p,
    ]
    lib.step_chunk_launch.restype = ctypes.c_int
    for fn in (lib.step_chunk_team_warps, lib.step_chunk_tail_layout,
               lib.step_chunk_group_lanes):
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def team_warps(dtype, stepper, frame, medium, field):
    """Warps of a team of the kernel instance that these codes launch (the
    codes step_chunk passes: dtype 0 float32 / 1 float64, _STEPPER_CODE,
    the frame's code, medium_code, field_code); 0 for the one-thread
    body. The choice is the kernel source's, made at compile time."""
    return build().step_chunk_team_warps(dtype, stepper, frame, medium,
                                         field)


def tail_layout(dtype, stepper, frame, medium, field):
    """Whether the kernel instance of these codes (team_warps') takes the
    tail layout, one ray a warp; the source's compile-time choice."""
    return bool(build().step_chunk_tail_layout(dtype, stepper, frame,
                                               medium, field))


def group_lanes(dtype, stepper, frame, medium, field):
    """Lanes a ray of the group body of the kernel instance of these codes
    (team_warps'), 0 where it has none; the source's compile-time
    choice."""
    return build().step_chunk_group_lanes(dtype, stepper, frame, medium,
                                          field)


def layout_limit(team=False):
    """The most rays of a launch in the tail layout: TAIL_LAYOUT_MAX_RAYS,
    and on an instance whose tail layout is the team body (`team`) at
    most TEAM_LAYOUT_MAX_RAYS too."""
    return (min(TAIL_LAYOUT_MAX_RAYS, TEAM_LAYOUT_MAX_RAYS) if team
            else TAIL_LAYOUT_MAX_RAYS)


def launch_flags(b, finish=False, fresh=False, layout=False, limit=None,
                 group=None):
    """The kernel's flag bits for a launch of b rays: 1 finish, 2 fresh,
    4 the tail layout, where the instance takes it (`layout`, tail_layout)
    and b <= limit (layout_limit() by default); on an instance with a
    group body (group_lanes), `group` its codes, 8 the group body where b
    <= GROUP_MAX_RAYS[group]."""
    flags = int(bool(finish)) | 2 * bool(fresh)
    if group:
        return flags | 8 * (0 < b <= GROUP_MAX_RAYS[tuple(group)])
    limit = layout_limit() if limit is None else limit
    sparse = bool(layout) and 0 < b <= limit
    return flags | 4 * sparse


def count_launch(flags, team=False):
    """Counts one kernel launch with these flag bits on step_chunk's
    counters."""
    step_chunk.launches += 1
    step_chunk.team_launches += bool(team)
    step_chunk.finish_launches += bool(flags & 1)
    step_chunk.fresh_launches += bool(flags & 2)
    step_chunk.sparse_launches += bool(flags & 4)
    step_chunk.group_launches += bool(flags & 8)


def ptxas_usage(log):
    """{instance: "N registers, <stack and spill line>"} from nvcc's
    -Xptxas -v output (BUILD_LOG), one entry per template instance
    step_chunk_kernel<T, STEPPER, FRAME, MEDIUM, FIELD, K> (or with fewer
    parameters, as builds before the full medium, the non-axial fields and
    the team body named them). An instance of the team body (K > 0 warps
    a team) ends in "team<K>", e.g. "float bs3 3d full team4", and of the
    group body (K = -G, G lanes a ray) in "group<G>", e.g. "float bs3
    2d_lat ad group4"."""

    def key(name):
        m = re.search(r"step_chunk_kernelI([fd])Li(\d)ELi(\d)E"
                      r"(?:Li(\d)E)?(?:Li(\d)E)?(?:Li(n?\d+)E)?", name or "")
        if m is None:
            return None
        words = [("float", "double")[m[1] == "d"],
                 ("bs3", "dopri5", "rk4")[int(m[2])],
                 ("2d_lat", "3d", "2d_colat")[int(m[3])]]
        if m[4] is not None:
            words.append(_MEDIUM_NAMES[int(m[4])])
        if m[5] is not None and int(m[5]):
            words.append(("dipole", "tilted", "igrf")[int(m[5])])
        if m[6] is not None and m[6].startswith("n"):
            words.append(f"group{int(m[6][1:])}")
        elif m[6] is not None and int(m[6]):
            words.append(f"team{int(m[6])}")
        return " ".join(words)

    regs, spills, fn, entry = {}, {}, None, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w.$]+)", line)
        if m:
            fn = m[1]
            entry = fn if "Compiling entry" in line else entry
        elif "spill" in line and fn == entry and key(fn):
            spills[key(fn)] = line.strip()
        elif (r := re.search(r"Used (\d+) registers", line)) and key(entry):
            regs[key(entry)] = r[1]
    return {k: f"{regs.get(k, '?')} registers, {spills.get(k, '')}"
            for k in sorted(set(regs) | set(spills))}


def medium_code(env, cfg: SolverConfig = None, grad_mode="fused",
                legacy_freq_state=False):
    """0 (AXI): the axisymmetric medium of the first slices (one ionosphere
    fit, CA1992 with hard branches, optional DE factor, protons), which the
    kernel runs in its own instances; 1 (FULL): any other protons-only
    medium, and every such medium over a non-axial field, through the full
    density chain; 2 (EXT): any medium with He+ or O+, or any run of `cfg`
    with the local arc ceiling, through the full chain extended by the Stix
    sums over the ion species and the local ceiling; 3 (ALT): the
    axisymmetric medium under grad_mode="reference" or legacy_freq_state;
    4 (ALTX): any other medium (FULL or EXT) under either mode, through the
    extended chain; 5 (AD): any medium and field under grad_mode="autodiff"
    (with or without legacy_freq_state), through the value chain on dual
    numbers. Beyond the media those take (the plasmasphere and DE weights
    0 and 1, at most MAX_HARM MLT harmonics and MAX_SHELLS local-ceiling
    shells: `wide`), 6 (ANY): any medium under the fused or the reference
    set, through the extended chain under the modes; 7 (AD_ANY): more
    harmonics or shells under the autodiff set (AD blends any weight).
    Raises ValueError where the JAX package raises (the reference set over
    a multi-ion medium or a non-axial field; legacy_freq_state in 3D is
    refused by the frame) and on an unknown grad_mode."""
    gradients._check_mode(grad_mode)
    if grad_mode == "autodiff":
        return AD_ANY if wide(env, cfg, weights=False) else AD
    if grad_mode == "reference":
        gradients.require_reference_env(env)
    if wide(env, cfg):
        return ANY
    if grad_mode == "reference" or legacy_freq_state:
        return ALT if medium_code(env, cfg) == AXI else ALTX
    if (len(ion_species(env.eta_he, env.eta_o)) > 1
            or (cfg is not None and _shells(cfg))):
        return EXT
    full = (env.iono_mix != 1.0 or env.ps_model != "ca1992"
            or env.ps_smooth != 0.0 or env.ps_refill != 0.0
            or env.duct_amp != 0.0 or medium.mlt_on(env)
            or env.b_model != "dipole")
    return FULL if full else AXI


def wide(env, cfg: SolverConfig = None, weights=True):
    """Whether env and cfg need the ANY or AD_ANY instances: more than
    MAX_HARM MLT harmonics, more than MAX_SHELLS local-ceiling shells or
    (`weights`) a plasmasphere or DE weight other than 0 and 1."""
    return (_n_harm(env) > MAX_HARM
            or (cfg is not None and len(_shells(cfg)) > MAX_SHELLS)
            or (weights and (env.ps_weight not in (0.0, 1.0)
                             or env.de_weight not in (0.0, 1.0))))


def field_code(env):
    """0: the centered dipole; 1: the tilted dipole; 2: the IGRF
    truncation (the kernel's FIELD template value)."""
    return _FIELD_CODE[env.b_model]


def _n_harm(env):
    return (len(env.ps_mlt_c) - 1) // 2 if env.ps_mlt_c else 0


def _params(env, cfg: SolverConfig, spec: events.StopSpec, root,
            grad_mode="fused", legacy_freq_state=False):
    vals = dict(
        b0=env.b0, iono_n0=env.iono_n0, iono_decay=env.iono_decay,
        iono_r0=env.iono_r0, lppi=env.lppi, lppo=env.lppo,
        ne_lppi=env.ne_lppi, ps_season=env.ps_season,
        ps_trough=env.ps_trough, ps_weight=env.ps_weight,
        de_weight=env.de_weight, root=root,
        **{k: getattr(cfg, k) for k in (
            "rtol", "atol", "dt_min", "dt_max", "safety", "pi_alpha",
            "pi_beta", "fac_min", "fac_max", "accept_tol",
            "stall_dt_factor", "stall_count", "ds_max")},
        **spec._asdict(),
        **{k: getattr(env, k) for k in (
            "iono_n0_b", "iono_decay_b", "iono_mix", "gcpm_bpow",
            "ps_smooth", "ps_refill", "ps_refill_q", "duct_amp", "duct_l0",
            "ps_mlt", "ps_mlt_a0", "ps_mlt_tamp", "ps_mlt_c3")},
        gcpm=1.0 if env.ps_model == "gcpm" else 0.0,
        n_harm=_n_harm(env),
        **fused.medium_consts(env)._asdict(),
    )
    c = [float(x) for x in env.ps_mlt_c]
    xm, ym = dipole.mlon_axes(env.b_tilt, env.b_tilt_phi)
    vec3 = ctypes.c_double * 3
    shells = _shells(cfg)
    ions = ion_species(env.eta_he, env.eta_o)

    def pad(xs, n):
        return (ctypes.c_double * n)(*(list(xs) + [0.0] * (n - len(xs))))

    inline = shells[:MAX_SHELLS]
    return StepParams(**{k: float(v) for k, v in vals.items()},
                      ds_local_frac=float(cfg.ds_local_frac),
                      n_shells=float(len(shells)),
                      shell_l=pad([float(x) for x, _ in inline], MAX_SHELLS),
                      shell_w=pad([float(w) for _, w in inline], MAX_SHELLS),
                      n_ion=float(len(ions)),
                      ion_fpe2=pad([x for x, _ in ions], MAX_ION),
                      ion_fce=pad([y for _, y in ions], MAX_ION),
                      ref_grads=1.0 if grad_mode == "reference" else 0.0,
                      legacy_freq=1.0 if legacy_freq_state else 0.0,
                      gcpm_lscale=float(env.gcpm_lscale),
                      gcpm_knee=float(env.gcpm_knee),
                      duct_w=float(env.duct_w),
                      ps_mlt_c=pad(c[:1 + 2 * MAX_HARM], 1 + 2 * MAX_HARM),
                      b_mom=vec3(*dipole.moment_unit(env.b_tilt,
                                                     env.b_tilt_phi)),
                      b_xm=vec3(*xm), b_ym=vec3(*ym),
                      igrf=(ctypes.c_double * 15)(
                          *(env.igrf_coeffs or (0.0,) * 15)))


def _overflow(env, cfg: SolverConfig, dtype, device):
    """(MLT coefficients, shells) past what the kernel's parameters hold:
    the coefficients of the harmonics past MAX_HARM, (c, s) of each, and
    the (L, width) pairs of the shells past MAX_SHELLS, each a tensor of
    the run dtype on `device` (cast from double, as the kernel casts its
    parameters), or None where there are none."""
    extra = ([float(x) for x in env.ps_mlt_c][1 + 2 * MAX_HARM:],
             [float(v) for shell in _shells(cfg)[MAX_SHELLS:]
              for v in shell])
    return tuple(torch.tensor(x, dtype=torch.float64).to(device, dtype)
                 if x else None for x in extra)


def _shells(cfg: SolverConfig):
    """((L, width), ...) of the local arc ceiling, the knee first; () when
    it is off (ds_local_knee == 0)."""
    if cfg.ds_local_knee <= 0.0:
        return ()
    return ((cfg.ds_local_knee, cfg.ds_local_w),) + tuple(
        cfg.ds_local_shells)


def _check(carry: RayCarry, f, env, cfg, spec, stepper, adaptive, frame,
           grad_mode, legacy_freq_state):
    """Raises on anything the kernel does not take; returns the launch's
    medium code."""
    if frame == "3d" and legacy_freq_state:
        raise ValueError(rhs_mod.LEGACY_3D)
    code = medium_code(env, cfg, grad_mode, legacy_freq_state)
    if adaptive and stepper not in KERNEL_STEPPERS:
        raise ValueError(
            f"step_chunk runs {KERNEL_STEPPERS} (and rk4 with "
            f"adaptive=False); got stepper={stepper!r}"
        )
    if frame not in _FRAME_CODE:
        raise ValueError(
            f"unknown frame {frame!r}; the step kernel has "
            f"{sorted(_FRAME_CODE)}"
        )
    n = _FRAME_CODE[frame][1]
    check_supported(cfg, n - 1, adaptive, stepper)
    if frame != "3d":
        medium.require_dipole_2d(env)
    if f.dim() != 1 or f.dtype not in (torch.float32, torch.float64):
        raise ValueError("f must be a (B,) float32 or float64 tensor")
    b = f.shape[0]
    for name, x in zip(RayCarry._fields, carry):
        if x.device != f.device:
            raise ValueError(f"carry.{name} is on {x.device}, f on {f.device}")
        if name in _VEC:
            if tuple(x.shape) != (b, n) or x.dtype != f.dtype:
                raise ValueError(
                    f"carry.{name} must be ({b}, {n}) {f.dtype} in frame "
                    f"{frame!r}; got "
                    f"{tuple(x.shape)} {x.dtype}"
                )
        elif name in _INT:
            if tuple(x.shape) != (b,) or x.dtype != torch.int32:
                raise ValueError(f"carry.{name} must be ({b},) int32")
        elif tuple(x.shape) != (b,) or x.dtype != f.dtype:
            raise ValueError(f"carry.{name} must be ({b},) {f.dtype}")
    return code


def step_chunk_reference(carry: RayCarry, f, env, cfg: SolverConfig,
                         spec: events.StopSpec, *, stepper: str,
                         n_steps: int, root: float = 1.0,
                         adaptive: bool = True, frame: str = "2d_lat",
                         grad_mode: str = "fused",
                         legacy_freq_state: bool = False):
    """The plain PyTorch version: n_steps attempts of `_step_one` over the
    frame's right-hand side as torch ops on the tensors' device (leaving
    early once no ray is ACTIVE, which is exact)."""
    step_chunk_reference.calls += 1
    rhs_fn, group_idx = rhs_mod.frame_rhs(frame, env, root, grad_mode,
                                          legacy_freq_state)
    return step_loop(rhs_fn, carry, f, cfg, spec, group_idx=group_idx,
                     adaptive=adaptive, stepper=stepper,
                     n_steps=int(n_steps), check_every=16)


step_chunk_reference.calls = 0


class ResidentCarry:
    """A carry kept in the kernel's layout across launches: the trajectory
    channel steps one block of save_every attempts per launch and
    snapshots between launches, so the carry stays field-major on the
    card for all of a trace's blocks instead of being copied in and out
    at every launch.

    Takes step_chunk's arguments but n_steps; `advance(n, finish=...,
    fresh=...)` runs n attempted steps (one kernel launch on CUDA tensors,
    the plain version on CPU tensors), with step_chunk's two flags, and
    `carry()` returns the current RayCarry (on CUDA,
    always the same one, whose fields are views of the buffers -- (B, n)
    views of the field-major vectors -- which every advance updates in
    place)."""

    def __init__(self, carry: RayCarry, f, env, cfg: SolverConfig,
                 spec: events.StopSpec, *, stepper: str, root: float = 1.0,
                 adaptive: bool = True, frame: str = "2d_lat",
                 grad_mode: str = "fused", legacy_freq_state: bool = False):
        code = _check(carry, f, env, cfg, spec, stepper, adaptive, frame,
                      grad_mode, legacy_freq_state)
        self._args = (f, env, cfg, spec)
        self._kw = dict(stepper=stepper, root=root, adaptive=adaptive,
                        frame=frame, grad_mode=grad_mode,
                        legacy_freq_state=legacy_freq_state)
        self._fields = None
        if f.device.type == "cpu":
            self._carry = carry
            return
        if f.device.type != "cuda":
            raise ValueError(f"step_chunk runs on cuda or cpu, not {f.device}")
        # fresh buffers: carry fields may share storage (init_carry's
        # u/u_prev and zero counters), and the kernel writes in place
        self._fields = {
            name: (x.t() if name in _VEC else x).clone(
                memory_format=torch.contiguous_format)
            for name, x in zip(RayCarry._fields, carry)
        }
        self._f = f.contiguous()
        order = ("u", "k1", "u_prev", "u_lo", "t", "dt", "errold",
                 "dt_prev", *_INT)
        self._ptrs = (ctypes.c_void_p * (len(order) + 1))(
            *[self._fields[name].data_ptr() for name in order],
            self._f.data_ptr()
        )
        self._params = _params(env, cfg, spec, root, grad_mode,
                               legacy_freq_state)
        # kept alive with the carry: the kernel reads them at every launch
        self._ext = _overflow(env, cfg, f.dtype, f.device)
        self._params.mlt_ext, self._params.shell_ext = (
            None if x is None else x.data_ptr() for x in self._ext)
        self._codes = (0 if f.dtype == torch.float32 else 1,
                       _STEPPER_CODE[stepper if adaptive else "rk4"],
                       _FRAME_CODE[frame][0], code, field_code(env))
        # the RayCarry of (B, n) views that carry() returns
        self._views = RayCarry(**{
            name: (self._fields[name].t() if name in _VEC
                   else self._fields[name])
            for name in RayCarry._fields
        })
        self._lib = build()
        self._team = bool(self._lib.step_chunk_team_warps(*self._codes))
        self._layout = bool(self._lib.step_chunk_tail_layout(*self._codes))
        # the instance's codes where it has a group body (GROUP_MAX_RAYS)
        self._group = (self._codes
                       if self._lib.step_chunk_group_lanes(*self._codes)
                       else None)
        # the stream current when the carry was made: every launch of the
        # carry queues there, in order
        self._stream = ctypes.c_void_p(
            torch.cuda.current_stream(f.device).cuda_stream)

    def advance(self, n_steps: int, *, finish: bool = False,
                fresh: bool = False):
        """n_steps more attempted steps for every ray, in place; fresh:
        k1 = rhs(u) first, finish: refine_events after (step_chunk)."""
        if int(n_steps) < 0 or int(n_steps) >= 2 ** 31:
            raise ValueError(f"n_steps={n_steps} out of range")
        f, env, cfg, spec = self._args
        if self._fields is None:
            kw = self._kw
            rhs_fn = rhs_mod.frame_rhs(kw["frame"], env, kw["root"],
                                       kw["grad_mode"],
                                       kw["legacy_freq_state"])[0]
            carry = self._carry
            if fresh:
                carry = carry._replace(k1=rhs_fn(carry.u, f))
            carry = step_chunk_reference(carry, f, env, cfg, spec,
                                         n_steps=n_steps, **kw)
            if finish:
                carry = refine_events(rhs_fn, carry, f, spec)
            self._carry = carry
            return
        flags = launch_flags(f.shape[0], finish, fresh, self._layout,
                             layout_limit(self._team), self._group)
        with torch.cuda.device(f.device):
            rc = self._lib.step_chunk_launch(
                *self._codes, self._ptrs, f.shape[0], int(n_steps), flags,
                ctypes.byref(self._params), self._stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"step_chunk kernel launch failed: CUDA error {rc}")
        # the team body: every launch of its instances, but over the
        # non-axial fields (whose instances take the tail layout too) the
        # launches in the tail layout alone
        count_launch(flags, self._team and (bool(flags & 4)
                                            or not self._layout))

    def carry(self) -> RayCarry:
        return self._carry if self._fields is None else self._views


def step_chunk(carry: RayCarry, f, env, cfg: SolverConfig,
               spec: events.StopSpec, *, stepper: str, n_steps: int,
               root: float = 1.0, adaptive: bool = True,
               frame: str = "2d_lat", grad_mode: str = "fused",
               legacy_freq_state: bool = False, finish: bool = False,
               fresh: bool = False):
    """Advance every ray by n_steps attempted steps; returns a new carry.

    carry fields are (B, n) / (B,) tensors of f's dtype (int32 for the
    counters), all on f's device, with n = 4 in the 2D frames and 7 in
    the "3d" frame. grad_mode ("fused", "reference" or "autodiff") and
    legacy_freq_state (2D) select the right-hand side. fresh: k1 =
    rhs(u) for every ray before the attempts (init_carry's; the carry's
    k1 is not read). finish: after them, the rays that end on HIT_EARTH or
    HIT_EQUATOR are refined (refine_events: u and t, nothing else), in
    the kernel on CUDA. On CUDA the kernel
    works on field-major (n, B) copies of the vectors, updating them in
    place, and the result's vector fields are (B, n) views of those
    copies."""
    resident = ResidentCarry(carry, f, env, cfg, spec, stepper=stepper,
                             root=root, adaptive=adaptive, frame=frame,
                             grad_mode=grad_mode,
                             legacy_freq_state=legacy_freq_state)
    resident.advance(n_steps, finish=finish, fresh=fresh)
    return resident.carry()


step_chunk.launches = 0
step_chunk.team_launches = 0    # those of them through the team body
step_chunk.sparse_launches = 0  # ... in the tail layout, one ray a warp
step_chunk.group_launches = 0   # ... through the group body
step_chunk.finish_launches = 0  # ... with finish (the trace's end inside)
step_chunk.fresh_launches = 0   # ... with fresh (its first k1 inside)
