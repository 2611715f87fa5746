"""The Crank-Nicolson / conjugate-gradient kernel of the 2D Fokker-Planck
solver: the wrapper of csrc/cn_pcg_2d.cu.

`cn_pcg_2d(f0, op, dt, n_steps, save_every, tol, maxiter, cluster=None)`
runs a whole evolution of fokker_planck_2d.evolve_cn_2d --
every CN step and every Jacobi-PCG iteration -- in one launch, and
returns (f_end, snaps, iters): the final state, the snapshots every
save_every steps ((n_steps // save_every, n_a, n_p), empty when
save_every is 0) and each step's CG iteration count (int32, on the card).
Float32 and float64. It takes CUDA tensors only: the plain version of
the same loop is fokker_planck_2d.evolve_cn_2d_reference, and
evolve_cn_2d calls this wrapper for an operator on the card, with no
fallback.

The launch is one thread-block cluster: the grid's rows split into
`cluster` bands, a block each (`layout` picks the cluster size, unless
the caller names it, the block's threads and the kernel's instance: how
many cells a thread holds in registers). As measured on an H100
(PERF.md, kernel_ab --cn-pcg), a grid of at most ONE_BLOCK_MAX_CELLS
cells runs on one block, a larger one on the largest cluster (up to 16
blocks, no more than its rows) whose blocks hold their bands: p and w of
the band and its two halo rows and v of the band in MAX_SHARED_BYTES of
shared memory each. So a grid holds at most max_cells(dtype) cells (16
blocks of three values a cell: 150,176 in float64, 300,368 in float32),
less what its halo rows need; a larger one raises ValueError. A cluster
of 16 blocks needs the card to co-schedule them: where it cannot
(cudaOccupancyMaxActiveClusters), the layout takes 8 before the launch.
A launch that fails raises RuntimeError: there is no fallback to one
block or to the plain version.

The kernel is built at first use from the source with nvcc for sm_90a
(no fast-math, -fmad=false) into raytrace_tpu_torch/_build/, named by a
hash of the source and flags, and loaded with ctypes, as ops/step_chunk.py
builds the step kernel. `floor_us(dtype, cluster, threads)` times the
loop's synchronisation skeleton alone (the latency floor of an
iteration).

`cn_pcg_2d.launches` counts launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import torch

from ..fokker_planck_2d import _stencil
from .step_chunk import BUILD_DIR, _nvcc

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "cn_pcg_2d.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# dynamic shared memory a block may ask for: p, v and w over its band and
# two halo rows, two edge rows of x and of r, the reductions' sums (the
# card allows 227 KB a block)
MAX_SHARED_BYTES = 220 * 1024
# the cluster sizes the layout takes (beyond 8 blocks the launch sets
# cudaFuncAttributeNonPortableClusterSizeAllowed)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_CLUSTER = CLUSTER_SIZES[-1]
# the kernel's instances, as csrc/cn_pcg_2d.cu::instances lists them: the
# cells a thread holds in registers with their coefficients (0: the state
# in global memory, any number of cells a thread)
VARIANTS = (0, 1, 2)
# the most threads a block (the kernel's __launch_bounds__)
MAX_THREADS = 512
# the layouts measured fastest (PERF.md, kernel_ab --cn-pcg): a grid of at
# most ONE_BLOCK_MAX_CELLS cells runs on one block; a larger one on the
# largest cluster its rows fill and its bands fit (16 blocks where the card can
# schedule them); a block's threads: the band's cells rounded up to a power
# of two, within AUTO_THREADS. One block against 16, us a CG iteration on
# an H100: float64 20 x 23 1.78-1.82 / 2.47, 24 x 28 2.34-2.38 / 2.40-2.42,
# 32 x 32 2.39-2.41 / 2.26-2.29; float32 32 x 32 1.92-2.16 / 2.24-2.25
ONE_BLOCK_MAX_CELLS = {torch.float64: 672, torch.float32: 1024}
AUTO_THREADS = (128, 512)

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
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.cn_pcg_2d_launch.argtypes = [
        ci, ci, ci, ci, ci, ci, cd, cd, ctypes.POINTER(vp), vp, vp, vp, vp,
        ci, ci, cd, cd, ci, vp,
    ]
    lib.cn_pcg_2d_launch.restype = ci
    lib.cn_pcg_2d_variants.argtypes = [ctypes.POINTER(ci), ci]
    lib.cn_pcg_2d_variants.restype = ci
    lib.cn_pcg_2d_floor_launch.argtypes = [ci, ci, ci, ci, vp, vp]
    lib.cn_pcg_2d_floor_launch.restype = ci
    lib.cn_pcg_2d_max_clusters.argtypes = [ci, ci, ci, ci, ci, ci,
                                           ctypes.POINTER(ci)]
    lib.cn_pcg_2d_max_clusters.restype = ci
    buf = (ci * (len(VARIANTS) + 1))()
    got = lib.cn_pcg_2d_variants(buf, len(VARIANTS) + 1)
    if tuple(buf[:got]) != VARIANTS:
        raise RuntimeError("ops/cn_pcg_2d.py::VARIANTS does not list the "
                           "instances of " + SOURCE)
    _LIB = lib
    return lib


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def smem_bytes(n_a, n_p, cluster, dtype):
    """Dynamic shared memory a block of this layout asks for (as
    csrc/cn_pcg_2d.cu::smem_bytes): four mbarrier words, the reductions'
    6 x 32 warp sums and 6 x 16 block sums, p and w over the largest band
    and its two halo rows, v over the band, the halo rows' r."""
    rows = -(-n_a // cluster)
    return 32 + (6 * 32 + 6 * 16 + (3 * rows + 6) * n_p) * _itemsize(dtype)


def max_cells(dtype):
    """The most cells (n_a n_p) the kernel takes in `dtype`: three values
    a cell in MAX_SHARED_BYTES on each of MAX_CLUSTER blocks. A grid also
    needs room for its bands' halo rows (`layout` says whether it fits)."""
    return MAX_CLUSTER * (MAX_SHARED_BYTES // (3 * _itemsize(dtype)))


class Layout(NamedTuple):
    cluster: int      # blocks in the cluster (1: one block)
    threads: int      # threads a block
    variant: int      # index into VARIANTS
    smem: int         # dynamic shared memory a block, bytes


def _variant(cells, threads):
    """The instance for `cells` cells a block on `threads` threads: the
    fewest cells a thread in registers that holds them, else the state in
    global memory."""
    fits = [k for k, cpt in enumerate(VARIANTS)
            if cpt and cpt * threads >= cells]
    return min(fits, key=lambda k: VARIANTS[k]) if fits else 0


def layout(n_a, n_p, dtype, cluster=None, threads=None):
    """The launch's layout for an n_a x n_p grid in `dtype`: `cluster` and
    `threads` as given, else as measured fastest (ONE_BLOCK_MAX_CELLS,
    AUTO_THREADS). Raises ValueError for a grid the kernel does not take
    or a layout that does not hold it."""
    n = n_a * n_p
    if n > max_cells(dtype):
        raise ValueError(
            f"a grid of {n_a} x {n_p} = {n} cells exceeds the kernel's "
            f"limit of {max_cells(dtype)} cells in {dtype} (three values a "
            f"cell in {MAX_SHARED_BYTES} bytes of shared memory on each of "
            f"{MAX_CLUSTER} blocks of a cluster)")
    if cluster is None:
        fit = [c for c in CLUSTER_SIZES
               if c <= max(n_a, 1)
               and smem_bytes(n_a, n_p, c, dtype) <= MAX_SHARED_BYTES]
        if not fit:
            c = min(MAX_CLUSTER, max(n_a, 1))
            raise ValueError(
                f"a grid of {n_a} x {n_p} cells does not fit the kernel's "
                f"layout: a band of {-(-n_a // c)} rows of {n_p} cells and "
                f"its two halo rows need {smem_bytes(n_a, n_p, c, dtype)} "
                f"bytes of shared memory a block, more than "
                f"{MAX_SHARED_BYTES}")
        one = fit[0] == 1 and n <= ONE_BLOCK_MAX_CELLS[dtype]
        cluster = 1 if one else fit[-1]
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster {cluster}: one of {CLUSTER_SIZES} "
                         f"blocks")
    cells = -(-n_a // cluster) * n_p
    if threads is None:
        pow2 = 1 << max(cells - 1, 0).bit_length()   # cells rounded up
        threads = min(AUTO_THREADS[1], max(AUTO_THREADS[0], pow2))
    if threads < 32 or threads > MAX_THREADS or threads & (threads - 1):
        raise ValueError(f"threads {threads}: a power of two, 32 to "
                         f"{MAX_THREADS}")
    smem = smem_bytes(n_a, n_p, cluster, dtype)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"a band of {-(-n_a // cluster)} rows of {n_p} cells and its two "
            f"halo rows need {smem} bytes of shared memory a block, more "
            f"than {MAX_SHARED_BYTES}")
    return Layout(cluster, threads, _variant(cells, threads), smem)


def coefficients(op, half):
    """The kernel's coefficient tensors of `op` at dt/2 = half, in its
    argument order: ka, kp, qp, inv_dpc, r_x, k_lc, mass, m_inv
    (contiguous), and (inv_da, qa)."""
    st = _stencil(op)
    coef = [t.contiguous() for t in (
        st.ka, st.kp, st.qp, st.inv_dpc, op.r_x, op.k_lc, op.mass,
        1.0 / (op.mass + half * op.diag))]
    return coef, (st.inv_da, st.qa)


def cn_pcg_2d(f0, op, dt, n_steps, save_every, tol, maxiter, cluster=None):
    """One launch: n_steps CN steps of dt from f0 (n_a, n_p) under the
    operator op (fokker_planck_2d._Op2D on the card), each a Jacobi-PCG
    solve to tol (relative to |b|) or maxiter iterations, on the layout
    `layout` gives (on `cluster` blocks where it is named). Returns
    (f_end, snaps, iters); sets cn_pcg_2d.last_layout."""
    dev, dtype = op.mass.device, op.mass.dtype
    n_a, n_p = op.n_a, op.n_p
    if dtype not in (torch.float32, torch.float64) or f0.dtype != dtype:
        raise ValueError(f"cn_pcg_2d takes float32 or float64 tensors of "
                         f"one dtype, got {f0.dtype} and {dtype}")
    lay = layout(n_a, n_p, dtype, cluster)
    if dev.type != "cuda" or f0.device != dev:
        raise ValueError("cn_pcg_2d takes the operator and f0 on one CUDA "
                         "device (the plain version is "
                         "fokker_planck_2d.evolve_cn_2d_reference)")
    if tuple(f0.shape) != (n_a, n_p) or tuple(op.mass.shape) != (n_a, n_p):
        raise ValueError(f"f0 has shape {tuple(f0.shape)} and the operator's "
                         f"mass {tuple(op.mass.shape)}, the operator's grid "
                         f"({n_a}, {n_p})")
    if n_steps < 0 or save_every < 0 or maxiter < 0:
        raise ValueError("n_steps, save_every and maxiter must be >= 0")
    half = 0.5 * dt
    coef, (inv_da, qa) = coefficients(op, half)
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
    if cluster is None and lay.cluster > 8 and not max_active_clusters(
            n_a, n_p, dtype, lay.cluster, lay.threads):
        # this card cannot co-schedule 16 blocks of this size: the next
        # largest cluster, chosen before the launch
        lay = layout(n_a, n_p, dtype, 8)
    err = lib.cn_pcg_2d_launch(
        1 if dtype == torch.float64 else 0, lay.variant, lay.cluster,
        lay.threads, n_a, n_p, inv_da, qa, ptrs, x.data_ptr(),
        work.data_ptr(), snaps.data_ptr(), iters.data_ptr(), int(n_steps),
        int(save_every), float(half), float(tol), int(maxiter),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cn_pcg_2d kernel launch failed on {lay}: CUDA "
                           f"error {err}")
    cn_pcg_2d.launches += 1
    cn_pcg_2d.last_layout = lay
    return x, snaps, iters


cn_pcg_2d.launches = 0
cn_pcg_2d.last_layout = None


def max_active_clusters(n_a, n_p, dtype, cluster, threads):
    """cudaOccupancyMaxActiveClusters for this layout on the current card
    (0: the cluster cannot be scheduled)."""
    lay = layout(n_a, n_p, dtype, cluster, threads)
    out = ctypes.c_int(-1)
    err = build().cn_pcg_2d_max_clusters(
        1 if dtype == torch.float64 else 0, lay.variant, lay.cluster,
        lay.threads, n_a, n_p, ctypes.byref(out))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {err}")
    return out.value


def floor_us(dtype, cluster, threads, n=20000, reps=3):
    """The loop's latency floor: us an iteration of its synchronisation
    skeleton alone (csrc/cn_pcg_2d.cu::cn_pcg_2d_floor_kernel) on
    `cluster` blocks of `threads`, the least of `reps` launches of n
    iterations timed with CUDA events on the current card."""
    lib = build()
    dev = torch.device("cuda")
    out = torch.zeros(1, device=dev, dtype=dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = 1 if dtype == torch.float64 else 0
    best = None
    for _ in range(reps + 1):   # the first a warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        err = lib.cn_pcg_2d_floor_launch(code, cluster, threads, n,
                                         out.data_ptr(), stream)
        end.record()
        if err:
            raise RuntimeError(f"cn_pcg_2d floor launch failed: CUDA error "
                               f"{err}")
        torch.cuda.synchronize(dev)
        t = start.elapsed_time(end) * 1e3 / n
        best = t if best is None or t < best else best
    return best
