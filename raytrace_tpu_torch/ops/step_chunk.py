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

- On CUDA tensors it launches the hand-written kernel of
  csrc/step_chunk.cu, the whole carry in registers for all n_steps
  attempts: one thread per ray, or (the 3D full chain over the dipole) a
  team of four warps per 32 rays, one lane of each a ray: warp 0 steps
  them, three helper warps compute the pieces of each right-hand side
  (`team_warps`).
  The kernel is built from the source at first use
  with nvcc for sm_90a into raytrace_tpu_torch/_build/ (rebuilt when the
  source changes; PARTS nvcc processes at once, linked into one library)
  and loaded with ctypes. There is no fallback: a CUDA
  tensor launches the kernel or raises.
- On CPU tensors it runs `step_chunk_reference`, the plain PyTorch loop of
  `integrate.solve._step_one`.

`step_chunk.launches` counts kernel launches (`step_chunk.team_launches`
those through the team body) and `step_chunk_reference.calls` counts
calls of the plain version.
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
    KERNEL_STEPPERS, RayCarry, SolverConfig, check_supported, step_loop,
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
# over the axisymmetric medium, two for them over the extended chain and
# three for the autodiff set, csrc/step_chunk.cu), linked into one library
PARTS = 11

# harmonics of the MLT plasmapause shape the kernel takes (kMaxHarm)
MAX_HARM = 8
# shells of the local arc ceiling the kernel takes: the knee and up to
# three ds_local_shells (kMaxShells)
MAX_SHELLS = 4
# ion species: protons, He+, O+ (kMaxIon)
MAX_ION = 3
_VEC = ("u", "k1", "u_prev", "u_lo")
_INT = ("status", "n_accept", "n_reject", "rejected", "n_tiny", "caution")
# kernel stepper codes; rk4 is what adaptive=False runs, whatever the
# stepper argument names
_STEPPER_CODE = {"bs3": 0, "dopri5": 1, "rk4": 2}
_FIELD_CODE = {"dipole": 0, "tilted": 1, "igrf": 2}
# the kernel's medium codes (medium_code): AXI, FULL, EXT, and ALT and ALTX,
# the axisymmetric medium and the extended chain under the reference
# scripts' modes, and AD, any medium and field under the autodiff set
AXI, FULL, EXT, ALT, ALTX, AD = 0, 1, 2, 3, 4, 5


class StepParams(ctypes.Structure):
    """Scalars passed to the kernel by value (mirror of the C struct
    StepParams in csrc/step_chunk.cu; every field a double: 123 of
    them, 984 bytes). The medium codes: AXI (0), FULL (1), EXT (2), ALT
    (3), ALTX (4) and AD (5, the autodiff set; medium_code)."""

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
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(StepParams),
        ctypes.c_void_p,
    ]
    lib.step_chunk_launch.restype = ctypes.c_int
    lib.step_chunk_team_warps.argtypes = [ctypes.c_int] * 5
    lib.step_chunk_team_warps.restype = ctypes.c_int
    _LIB = lib
    return lib


def team_warps(dtype, stepper, frame, medium, field):
    """Warps of a team of the kernel instance that these codes launch (the
    codes step_chunk passes: dtype 0 float32 / 1 float64, _STEPPER_CODE,
    the frame's code, medium_code, field_code); 0 for the one-thread
    body. The choice is the kernel source's, made at compile time."""
    return build().step_chunk_team_warps(dtype, stepper, frame, medium,
                                         field)


def ptxas_usage(log):
    """{instance: "N registers, <stack and spill line>"} from nvcc's
    -Xptxas -v output (BUILD_LOG), one entry per template instance
    step_chunk_kernel<T, STEPPER, FRAME, MEDIUM, FIELD, K> (or with fewer
    parameters, as builds before the full medium, the non-axial fields and
    the team body named them). An instance of the team body (K > 0 warps
    a team) ends in "team<K>", e.g. "float bs3 3d full team4"."""

    def key(name):
        m = re.search(r"step_chunk_kernelI([fd])Li(\d)ELi(\d)E"
                      r"(?:Li(\d)E)?(?:Li(\d)E)?(?:Li(\d+)E)?", name or "")
        if m is None:
            return None
        words = [("float", "double")[m[1] == "d"],
                 ("bs3", "dopri5", "rk4")[int(m[2])],
                 ("2d_lat", "3d", "2d_colat")[int(m[3])]]
        if m[4] is not None:
            words.append(("axi", "full", "ext", "alt", "altx",
                          "ad")[int(m[4])])
        if m[5] is not None and int(m[5]):
            words.append(("dipole", "tilted", "igrf")[int(m[5])])
        if m[6] is not None and int(m[6]):
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
    numbers. Raises ValueError where the JAX package raises (the reference
    set over a multi-ion medium or a non-axial field; legacy_freq_state in
    3D is refused by the frame) and on an unknown grad_mode."""
    gradients._check_mode(grad_mode)
    if grad_mode == "autodiff":
        return AD
    if grad_mode == "reference":
        gradients.require_reference_env(env)
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

    return StepParams(**{k: float(v) for k, v in vals.items()},
                      ds_local_frac=float(cfg.ds_local_frac),
                      n_shells=float(len(shells)),
                      shell_l=pad([float(x) for x, _ in shells], MAX_SHELLS),
                      shell_w=pad([float(w) for _, w in shells], MAX_SHELLS),
                      n_ion=float(len(ions)),
                      ion_fpe2=pad([x for x, _ in ions], MAX_ION),
                      ion_fce=pad([y for _, y in ions], MAX_ION),
                      ref_grads=1.0 if grad_mode == "reference" else 0.0,
                      legacy_freq=1.0 if legacy_freq_state else 0.0,
                      gcpm_lscale=float(env.gcpm_lscale),
                      gcpm_knee=float(env.gcpm_knee),
                      duct_w=float(env.duct_w),
                      ps_mlt_c=(ctypes.c_double * (1 + 2 * MAX_HARM))(
                          *(c + [0.0] * (1 + 2 * MAX_HARM - len(c)))),
                      b_mom=vec3(*dipole.moment_unit(env.b_tilt,
                                                     env.b_tilt_phi)),
                      b_xm=vec3(*xm), b_ym=vec3(*ym),
                      igrf=(ctypes.c_double * 15)(
                          *(env.igrf_coeffs or (0.0,) * 15)))


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
    if len(_shells(cfg)) > MAX_SHELLS:
        raise ValueError(
            f"the local arc ceiling has {len(_shells(cfg))} shells (the knee "
            f"and ds_local_shells); the kernel takes at most {MAX_SHELLS}"
        )
    n = _FRAME_CODE[frame][1]
    check_supported(cfg, n - 1, adaptive, stepper)
    medium.check_env(env)
    if frame != "3d":
        medium.require_dipole_2d(env)
    n_harm = _n_harm(env)
    if (code == AD and frame == "3d" and medium.mlt_on(env)
            and n_harm < 1):
        raise ValueError(
            "the AD instances take the MLT plasmapause shape with at least "
            "one harmonic (ps_mlt_harmonics >= 1)")
    if n_harm > MAX_HARM:
        raise ValueError(
            f"the MLT plasmapause shape has {n_harm} harmonics; the kernel "
            f"takes at most {MAX_HARM} (ps_mlt_harmonics)"
        )
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

    Takes step_chunk's arguments but n_steps; `advance(n)` runs n
    attempted steps (one kernel launch on CUDA tensors, the plain version
    on CPU tensors) and `carry()` returns the current RayCarry (on CUDA,
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
        # the stream current when the carry was made: every launch of the
        # carry queues there, in order
        self._stream = ctypes.c_void_p(
            torch.cuda.current_stream(f.device).cuda_stream)

    def advance(self, n_steps: int):
        """n_steps more attempted steps for every ray, in place."""
        if int(n_steps) < 0 or int(n_steps) >= 2 ** 31:
            raise ValueError(f"n_steps={n_steps} out of range")
        f, env, cfg, spec = self._args
        if self._fields is None:
            self._carry = step_chunk_reference(self._carry, f, env, cfg,
                                               spec, n_steps=n_steps,
                                               **self._kw)
            return
        with torch.cuda.device(f.device):
            rc = self._lib.step_chunk_launch(
                *self._codes, self._ptrs, f.shape[0], int(n_steps),
                ctypes.byref(self._params), self._stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"step_chunk kernel launch failed: CUDA error {rc}")
        step_chunk.launches += 1
        if self._team:
            step_chunk.team_launches += 1

    def carry(self) -> RayCarry:
        return self._carry if self._fields is None else self._views


def step_chunk(carry: RayCarry, f, env, cfg: SolverConfig,
               spec: events.StopSpec, *, stepper: str, n_steps: int,
               root: float = 1.0, adaptive: bool = True,
               frame: str = "2d_lat", grad_mode: str = "fused",
               legacy_freq_state: bool = False):
    """Advance every ray by n_steps attempted steps; returns a new carry.

    carry fields are (B, n) / (B,) tensors of f's dtype (int32 for the
    counters), all on f's device, with n = 4 in the 2D frames and 7 in
    the "3d" frame. grad_mode ("fused", "reference" or "autodiff") and
    legacy_freq_state (2D) select the right-hand side. On CUDA the kernel
    works on field-major (n, B) copies of the vectors, updating them in
    place, and the result's vector fields are (B, n) views of those
    copies."""
    resident = ResidentCarry(carry, f, env, cfg, spec, stepper=stepper,
                             root=root, adaptive=adaptive, frame=frame,
                             grad_mode=grad_mode,
                             legacy_freq_state=legacy_freq_state)
    resident.advance(n_steps)
    return resident.carry()


step_chunk.launches = 0
step_chunk.team_launches = 0    # those of them through the team body
