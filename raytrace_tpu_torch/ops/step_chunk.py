"""Multi-step integration chunk: the port of ops/pallas_stepper.py.

`step_chunk(carry, f, env, cfg, spec, stepper=..., n_steps=...)` advances
every ray by exactly `n_steps` attempted `_step_one` steps (a ray that
stops earlier stays as it stopped, as in the JAX package) over the 2D
latitude frame's `rhs_2d_lat` and returns the new RayCarry.

- On CUDA tensors it launches the hand-written kernel of
  csrc/step_chunk.cu: one thread per ray, the whole carry in registers for
  all n_steps attempts. The kernel is built from the source at first use
  with nvcc for sm_90a into raytrace_tpu_torch/_build/ (rebuilt when the
  source changes) and loaded with ctypes. There is no fallback: a CUDA
  tensor launches the kernel or raises.
- On CPU tensors it runs `step_chunk_reference`, the plain PyTorch loop of
  `integrate.solve._step_one`.

`step_chunk.launches` counts kernel launches and
`step_chunk_reference.calls` counts calls of the plain version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from ..integrate import events
from ..integrate.solve import (
    KERNEL_STEPPERS, RayCarry, SolverConfig, check_supported, step_loop,
)
from ..models import medium
from . import rhs as rhs_mod

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "step_chunk.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
# no --use_fast_math (isfinite, the inf stop defaults and the two-sum need
# IEEE semantics); -fmad=false keeps every product and sum separately
# rounded, as in the plain PyTorch version (see the note in the source)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VEC = ("u", "k1", "u_prev", "u_lo")
_INT = ("status", "n_accept", "n_reject", "rejected", "n_tiny", "caution")
_STEPPER_CODE = {"bs3": 0, "dopri5": 1}


class StepParams(ctypes.Structure):
    """Scalars passed to the kernel by value (mirror of the C struct
    StepParams in csrc/step_chunk.cu; every field a double)."""

    _fields_ = [(name, ctypes.c_double) for name in (
        # medium (make_env_lat feature set) and root
        "b0", "iono_n0", "iono_decay", "iono_r0", "lppi", "lppo",
        "ne_lppi", "ps_season", "ps_trough", "ps_weight", "de_weight",
        "root",
        # SolverConfig
        "rtol", "atol", "dt_min", "dt_max", "safety", "pi_alpha",
        "pi_beta", "fac_min", "fac_max", "accept_tol", "stall_dt_factor",
        "stall_count",
        # StopSpec
        "r_floor", "r_ceil", "t_max", "group_time_max", "stop_at_equator",
        "lat_sign", "lat_offset", "stop_retrograde",
    )]


_LIB = None
BUILD_LOG = ""      # nvcc's output of the last build (-Xptxas -v)
BUILD_SECONDS = 0.0


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
        h = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"step_chunk_{h.hexdigest()[:16]}.so")


def build():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle. The build writes to a temporary name and renames, so a cut
    build never leaves a half-written library behind."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True,
        )
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.step_chunk_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(StepParams),
        ctypes.c_void_p,
    ]
    lib.step_chunk_launch.restype = ctypes.c_int
    _LIB = lib
    return lib


def _params(env, cfg: SolverConfig, spec: events.StopSpec, root):
    vals = dict(
        b0=env.b0, iono_n0=env.iono_n0, iono_decay=env.iono_decay,
        iono_r0=env.iono_r0, lppi=env.lppi, lppo=env.lppo,
        ne_lppi=env.ne_lppi, ps_season=env.ps_season,
        ps_trough=env.ps_trough, ps_weight=env.ps_weight,
        de_weight=env.de_weight, root=root,
        **{k: getattr(cfg, k) for k in (
            "rtol", "atol", "dt_min", "dt_max", "safety", "pi_alpha",
            "pi_beta", "fac_min", "fac_max", "accept_tol",
            "stall_dt_factor", "stall_count")},
        **spec._asdict(),
    )
    return StepParams(**{k: float(v) for k, v in vals.items()})


def _check(carry: RayCarry, f, env, cfg, spec, stepper, n_steps, adaptive):
    if stepper not in KERNEL_STEPPERS:
        raise ValueError(
            f"step_chunk runs {KERNEL_STEPPERS}; got stepper={stepper!r}"
        )
    check_supported(cfg, 3, adaptive, stepper)
    medium.check_env(env)
    if int(n_steps) < 0 or int(n_steps) >= 2 ** 31:
        raise ValueError(f"n_steps={n_steps} out of range")
    if f.dim() != 1 or f.dtype not in (torch.float32, torch.float64):
        raise ValueError("f must be a (B,) float32 or float64 tensor")
    b = f.shape[0]
    for name, x in zip(RayCarry._fields, carry):
        if x.device != f.device:
            raise ValueError(f"carry.{name} is on {x.device}, f on {f.device}")
        if name in _VEC:
            if tuple(x.shape) != (b, 4) or x.dtype != f.dtype:
                raise ValueError(
                    f"carry.{name} must be ({b}, 4) {f.dtype}; got "
                    f"{tuple(x.shape)} {x.dtype}"
                )
        elif name in _INT:
            if tuple(x.shape) != (b,) or x.dtype != torch.int32:
                raise ValueError(f"carry.{name} must be ({b},) int32")
        elif tuple(x.shape) != (b,) or x.dtype != f.dtype:
            raise ValueError(f"carry.{name} must be ({b},) {f.dtype}")


def step_chunk_reference(carry: RayCarry, f, env, cfg: SolverConfig,
                         spec: events.StopSpec, *, stepper: str,
                         n_steps: int, root: float = 1.0):
    """The plain PyTorch version: n_steps attempts of `_step_one` as torch
    ops on the tensors' device (leaving early once no ray is ACTIVE, which
    is exact)."""
    step_chunk_reference.calls += 1
    rhs_fn = lambda u, ff: rhs_mod.rhs_2d_lat(u, ff, env, root=root)  # noqa: E731
    return step_loop(rhs_fn, carry, f, cfg, spec, stepper=stepper,
                     n_steps=int(n_steps), check_every=16)


step_chunk_reference.calls = 0


def step_chunk(carry: RayCarry, f, env, cfg: SolverConfig,
               spec: events.StopSpec, *, stepper: str, n_steps: int,
               root: float = 1.0, adaptive: bool = True):
    """Advance every ray by n_steps attempted steps; returns a new carry.

    carry fields are (B, 4) / (B,) tensors of f's dtype (int32 for the
    counters), all on f's device. On CUDA the kernel works on field-major
    (4, B) copies of the vectors, updating them in place, and the result's
    vector fields are (B, 4) views of those copies."""
    _check(carry, f, env, cfg, spec, stepper, n_steps, adaptive)
    if f.device.type == "cpu":
        return step_chunk_reference(carry, f, env, cfg, spec,
                                    stepper=stepper, n_steps=n_steps,
                                    root=root)
    if f.device.type != "cuda":
        raise ValueError(f"step_chunk runs on cuda or cpu, not {f.device}")
    lib = build()
    # always fresh buffers: carry fields may share storage (init_carry's
    # u/u_prev and zero counters), and the kernel writes in place
    fields = {
        name: (x.t() if name in _VEC else x).clone(
            memory_format=torch.contiguous_format)
        for name, x in zip(RayCarry._fields, carry)
    }
    ff = f.contiguous()
    order = ("u", "k1", "u_prev", "u_lo", "t", "dt", "errold", "dt_prev",
             *_INT)
    ptrs = (ctypes.c_void_p * (len(order) + 1))(
        *[fields[name].data_ptr() for name in order], ff.data_ptr()
    )
    params = _params(env, cfg, spec, root)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = lib.step_chunk_launch(
            0 if f.dtype == torch.float32 else 1, _STEPPER_CODE[stepper],
            ptrs, f.shape[0], int(n_steps), ctypes.byref(params),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"step_chunk kernel launch failed: CUDA error {rc}")
    step_chunk.launches += 1
    return RayCarry(**{
        name: (fields[name].t() if name in _VEC else fields[name])
        for name in RayCarry._fields
    })


step_chunk.launches = 0
