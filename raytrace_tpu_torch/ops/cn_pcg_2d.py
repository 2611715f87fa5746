"""The Crank-Nicolson / conjugate-gradient kernel of the 2D Fokker-Planck
solver: the wrapper of csrc/cn_pcg_2d.cu.

`cn_pcg_2d(f0, op, dt, n_steps, save_every, tol, maxiter)` runs a whole
evolution of fokker_planck_2d.evolve_cn_2d -- every CN step and every
Jacobi-PCG iteration -- in one launch of one thread block, and returns
(f_end, snaps, iters): the final state, the snapshots every save_every
steps ((n_steps // save_every, n_a, n_p), empty when save_every is 0)
and each step's CG iteration count (int32, on the card). Float32 and
float64. It takes CUDA tensors only: the plain version of the same loop
is fokker_planck_2d.evolve_cn_2d_reference, and evolve_cn_2d calls this
wrapper for an operator on the card, with no fallback.

The kernel is built at first use from the source with nvcc for sm_90a
(no fast-math, -fmad=false) into raytrace_tpu_torch/_build/, named by a
hash of the source and flags, and loaded with ctypes, as ops/step_chunk.py
builds the step kernel. The search direction and the stencil's two
per-cell sums live in shared memory, so a grid holds at most
MAX_SHARED_BYTES / (3 itemsize) cells (9,386 in float64, 18,773 in
float32); a larger one raises ValueError.

`cn_pcg_2d.launches` counts launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from ..fokker_planck_2d import _stencil
from .step_chunk import BUILD_DIR, _nvcc

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "cn_pcg_2d.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# dynamic shared memory the kernel may ask for: the search direction and
# the stencil's two sums, three values a cell (the card allows 227 KB a
# block; the rest is left for the reductions' static buffers)
MAX_SHARED_BYTES = 220 * 1024

_LIB = None
BUILD_LOG = ""      # nvcc's output of the last build (-Xptxas -v)
BUILD_SECONDS = 0.0


def library_path():
    """Path of the shared library for the current source and flags."""
    with open(SOURCE, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"cn_pcg_2d_{h.hexdigest()[:16]}.so")


def build():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle. nvcc writes into a temporary directory and the library is
    renamed into place, so a cut build leaves no half-written library."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        work = tempfile.mkdtemp(dir=BUILD_DIR)
        tmp = os.path.join(work, "cn_pcg_2d.so")
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, SOURCE],
                capture_output=True, text=True)
            BUILD_LOG = out.stdout + out.stderr
            BUILD_SECONDS = time.perf_counter() - t0
            if out.returncode:
                raise RuntimeError(
                    f"nvcc failed building {SOURCE}:\n{BUILD_LOG}")
            os.replace(tmp, path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(path)
    vp = ctypes.c_void_p
    lib.cn_pcg_2d_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(vp), vp, vp, vp, vp, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int, vp,
    ]
    lib.cn_pcg_2d_launch.restype = ctypes.c_int
    _LIB = lib
    return lib


def max_cells(dtype):
    """The largest grid (n_a n_p cells) the kernel takes in `dtype`."""
    return MAX_SHARED_BYTES // (3 * torch.empty(
        (), dtype=dtype).element_size())


def cn_pcg_2d(f0, op, dt, n_steps, save_every, tol, maxiter):
    """One launch: n_steps CN steps of dt from f0 (n_a, n_p) under the
    operator op (fokker_planck_2d._Op2D on the card), each a Jacobi-PCG
    solve to tol (relative to |b|) or maxiter iterations. Returns
    (f_end, snaps, iters)."""
    dev, dtype = op.mass.device, op.mass.dtype
    n_a, n_p = op.n_a, op.n_p
    if dtype not in (torch.float32, torch.float64) or f0.dtype != dtype:
        raise ValueError(f"cn_pcg_2d takes float32 or float64 tensors of "
                         f"one dtype, got {f0.dtype} and {dtype}")
    if n_a * n_p > max_cells(dtype):
        raise ValueError(
            f"a grid of {n_a} x {n_p} = {n_a * n_p} cells exceeds the "
            f"kernel's limit of {max_cells(dtype)} cells in {dtype} (three "
            f"values a cell in {MAX_SHARED_BYTES} bytes of shared memory)")
    if dev.type != "cuda" or f0.device != dev:
        raise ValueError("cn_pcg_2d takes the operator and f0 on one CUDA "
                         "device (the plain version is "
                         "fokker_planck_2d.evolve_cn_2d_reference)")
    if tuple(f0.shape) != (n_a, n_p):
        raise ValueError(f"f0 has shape {tuple(f0.shape)}, the operator "
                         f"({n_a}, {n_p})")
    if n_steps < 0 or save_every < 0 or maxiter < 0:
        raise ValueError("n_steps, save_every and maxiter must be >= 0")
    half = 0.5 * dt
    st = _stencil(op)
    coef = [t.contiguous() for t in (
        st.ka, st.kp, st.qp, st.inv_dpc, op.r_x, op.k_lc, op.mass,
        1.0 / (op.mass + half * op.diag))]
    if any(t.device != dev or t.dtype != dtype for t in coef):
        raise ValueError("the operator's tensors must share one device and "
                         "dtype")
    x = f0.contiguous().clone()
    work = torch.empty((2, n_a, n_p), device=dev, dtype=dtype)
    n_out = n_steps // save_every if save_every else 0
    snaps = torch.empty((n_out, n_a, n_p), device=dev, dtype=dtype)
    iters = torch.zeros((n_steps,), device=dev, dtype=torch.int32)
    # the coefficient tensors made here are freed on return, while the
    # kernel may still read them: PyTorch's allocator hands their memory
    # only to work queued after it on this stream
    ptrs = (ctypes.c_void_p * len(coef))(*[t.data_ptr() for t in coef])
    lib = build()
    err = lib.cn_pcg_2d_launch(
        1 if dtype == torch.float64 else 0, n_a, n_p, st.inv_da, st.qa, ptrs,
        x.data_ptr(), work.data_ptr(), snaps.data_ptr(), iters.data_ptr(),
        int(n_steps), int(save_every), float(half), float(tol),
        int(maxiter), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cn_pcg_2d kernel launch failed: CUDA error "
                           f"{err}")
    cn_pcg_2d.launches += 1
    return x, snaps, iters


cn_pcg_2d.launches = 0
