"""The 2D Fokker-Planck CN/CG kernel (csrc/cn_pcg_2d.cu) against its plain
version, on the CPU, at every cluster size it takes.

There is no CUDA compiler here, but the kernel's source compiles as C++20
with stand-ins for the CUDA keywords, as tests/test_torch_kernel_host.py
builds the step kernel: a launch runs every thread of every block of the
cluster at once as an OS thread; __syncthreads is a std::barrier over the
block's threads, the cluster barrier one std::barrier over every thread of
the cluster, a warp's shuffle an exchange through memory between two
barriers of its 32 threads, and map_shared_rank returns the same offset in
the other block's shared memory. The launch takes its block width from
the layout, so a cluster of 1, 2, 4 or 8 blocks of 32 or 64 threads runs
here. Each layout's evolution is held to evolve_cn_2d_reference in
float64 (snapshots within 1e-12 of the max, CG counts within 1), two runs
to each other bit for bit, and a grid with fewer rows than blocks is run
right. The host program runs in a subprocess with a timeout, so that a
cluster barrier that deadlocks fails the test and does not hang the
suite. Needs g++ with C++20.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import fokker_planck_2d as fp2
from raytrace_tpu_torch.ops import cn_pcg_2d as cg

STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <condition_variable>
#include <mutex>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
namespace emu {
inline std::vector<std::vector<unsigned char>> smem;   // a block's
inline std::vector<std::unique_ptr<std::barrier<>>> bar;   // a block's
inline std::vector<std::unique_ptr<std::barrier<>>> wbar;  // a warp's
inline std::vector<double> wbuf;                            // a warp's lanes
inline std::unique_ptr<std::barrier<>> cbar;                // the cluster's
inline int nw = 0;
inline unsigned char* own() { return smem[blockIdx.x].data(); }
inline int wid() { return blockIdx.x * nw + threadIdx.x / 32; }
}
inline void __syncthreads() { emu::bar[blockIdx.x]->arrive_and_wait(); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int off) {
  const int w = emu::wid(), lane = threadIdx.x % 32;
  emu::wbuf[w * 32 + lane] = static_cast<double>(v);
  emu::wbar[w]->arrive_and_wait();
  const T got = static_cast<T>(emu::wbuf[w * 32 + (lane ^ off)]);
  emu::wbar[w]->arrive_and_wait();
  return got;
}
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu::cbar->arrive_and_wait(); }
  template <typename T>
  T* map_shared_rank(T* p, int rank) const {
    const std::ptrdiff_t off = reinterpret_cast<unsigned char*>(p)
                               - emu::own();
    return reinterpret_cast<T*>(emu::smem[rank].data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed,
};
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int cudaGetLastError() { return 0; }
template <typename K>
inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <typename K>
inline int cudaOccupancyMaxActiveClusters(int* n, K,
                                          const cudaLaunchConfig_t*) {
  *n = 1;
  return 0;
}
using std::sqrt;
namespace emu {
// an mbarrier: one arrival a phase and the bytes the stores bring
struct Mbar {
  std::mutex m;
  std::condition_variable cv;
  long tx = 0;
  int pending = 1;
  unsigned phase = 0;
};
inline std::mutex mbars_m;
inline std::vector<std::unique_ptr<Mbar>> mbars;
inline Mbar* mb(unsigned long long* bar) {
  return reinterpret_cast<Mbar*>(*bar);
}
inline void settle(Mbar* b) {
  if (b->pending == 0 && b->tx == 0) {
    ++b->phase;
    b->pending = 1;
    b->cv.notify_all();
  }
}
}
"""

# the stand-ins for csrc/cn_pcg_2d.cu's exchange primitives (its PTX)
PRIMS = r"""
template <typename T>
inline T ld_coef(const T* ptr) { return *ptr; }
inline void mbar_init(unsigned long long* bar) {
  std::lock_guard<std::mutex> g(emu::mbars_m);
  emu::mbars.emplace_back(new emu::Mbar());
  *bar = reinterpret_cast<unsigned long long>(emu::mbars.back().get());
}
inline void mbar_expect(unsigned long long* bar, unsigned bytes) {
  emu::Mbar* b = emu::mb(bar);
  std::lock_guard<std::mutex> g(b->m);
  b->tx += bytes;
  b->pending -= 1;
  emu::settle(b);
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  emu::Mbar* b = emu::mb(bar);
  std::unique_lock<std::mutex> g(b->m);
  b->cv.wait(g, [&] { return (b->phase & 1) != parity; });
}
template <typename T>
inline void push(T* slot, int rank, T v, unsigned long long* bar) {
  cooperative_groups::cluster_group cl;
  T* dst = cl.map_shared_rank(slot, rank);
  emu::Mbar* b = emu::mb(cl.map_shared_rank(bar, rank));
  std::lock_guard<std::mutex> g(b->m);
  *dst = v;
  b->tx -= static_cast<long>(sizeof(T));
  emu::settle(b);
}
"""

STUB_END = r"""
// every thread of every block at once: the cluster is co-resident
template <typename... P, typename... A>
inline int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                              void (*kernel)(P...), A... args) {
  const unsigned nb = cfg->gridDim.x, nt = cfg->blockDim.x;
  if (nt % 32) return cudaErrorInvalidValue;
  emu::nw = nt / 32;
  emu::smem.assign(nb, std::vector<unsigned char>(cfg->dynamicSmemBytes
                                                  + 64, 0xff));
  emu::bar.clear();
  emu::wbar.clear();
  for (unsigned b = 0; b < nb; ++b)
    emu::bar.emplace_back(new std::barrier<>(nt));
  for (unsigned w = 0; w < nb * emu::nw; ++w)
    emu::wbar.emplace_back(new std::barrier<>(32));
  emu::wbuf.assign(nb * nt, 0.0);
  emu::cbar.reset(new std::barrier<>(nb * nt));
  std::vector<std::thread> ts;
  for (unsigned b = 0; b < nb; ++b)
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([=] {
        blockIdx = dim3(b);
        threadIdx = dim3(t);
        blockDim = dim3(nt);
        gridDim = dim3(nb);
        kernel(args...);
      });
  for (auto& th : ts) th.join();
  return 0;
}
"""

MAIN = r"""
#include "stub.h"
#include <cstdio>
#include <cstdlib>
#include "kernel.inc"
// argv: input file, output file. The input: int32 variant, nb, nt, n_a,
// n_p, n_steps, save_every, maxiter; float64 inv_da, qa, half, tol; the
// coefficients ka, kp, qp, inv_dpc, r_x, k_lc, mass, m_inv; f0.
int main(int argc, char** argv) {
  FILE* fh = fopen(argv[1], "rb");
  int32_t h[8];
  double d[4];
  if (fread(h, 4, 8, fh) != 8 || fread(d, 8, 4, fh) != 4) return 3;
  const int n_a = h[3], n_p = h[4], n = n_a * n_p;
  const size_t sizes[9] = {
      (size_t)(n_a - 1) * n_p, (size_t)n_a * (n_p - 1), (size_t)n_p - 1,
      (size_t)n_p - 1, (size_t)n, (size_t)n_p, (size_t)n, (size_t)n,
      (size_t)n};
  std::vector<std::vector<double>> in(9);
  for (int k = 0; k < 9; ++k) {
    in[k].resize(sizes[k] + 1);
    if (fread(in[k].data(), 8, sizes[k], fh) != sizes[k]) return 3;
  }
  fclose(fh);
  const void* coef[8];
  for (int k = 0; k < 8; ++k) coef[k] = in[k].data();
  std::vector<double> x = in[8], work(2 * n);
  const int n_out = h[6] ? h[5] / h[6] : 0;
  std::vector<double> snaps((size_t)n_out * n + 1);
  std::vector<int32_t> iters(h[5] + 1);
  const int rc = cn_pcg_2d_launch(1, h[0], h[1], h[2], n_a, n_p, d[0], d[1],
                                  coef, x.data(), work.data(), snaps.data(),
                                  iters.data(), h[5], h[6], d[2], d[3], h[7],
                                  nullptr);
  FILE* out = fopen(argv[2], "wb");
  fwrite(&rc, 4, 1, out);
  fwrite(x.data(), 8, n, out);
  fwrite(snaps.data(), 8, (size_t)n_out * n, out);
  fwrite(iters.data(), 4, h[5], out);
  fclose(out);
  return 0;
}
"""


def _host_source(src):
    s, n = re.subn(r"// ---- the cluster's exchange primitives.*?"
                   r"// ---- end of the exchange primitives ----", PRIMS, src,
                   flags=re.S)
    assert n == 1
    s = s.replace("#include <cooperative_groups.h>", "")
    s = s.replace("#include <cuda_runtime.h>", "")
    s = s.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                  "unsigned char* smem_raw = emu::own();")
    assert "emu::own()" in s
    return s


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx is not None, "the host check of the kernel needs g++"
    d = tmp_path_factory.mktemp("cn_pcg_host")
    (d / "stub.h").write_text(STUB + STUB_END)
    (d / "kernel.inc").write_text(_host_source(open(cg.SOURCE).read()))
    (d / "main.cpp").write_text(MAIN)
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-w", "-o",
                           str(d / "cn_pcg_host"), str(d / "main.cpp")],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d


def _case(na, npp, seed=31, loss_cone="absorbing"):
    """A random SPD operator with a signed cross term on an na x npp grid,
    float64 on the CPU (tests/test_torch_cuda.py's _fp2d_case)."""
    rng = np.random.default_rng(seed)
    a11 = rng.uniform(0.3, 3.0, (na, npp))
    a22 = rng.uniform(0.3, 3.0, (na, npp))
    a12 = rng.uniform(-0.95, 0.95, (na, npp)) * np.sqrt(a11 * a22)
    g = fp2.make_grid_2d(np.radians(8.0), na, 0.5, 4.0, npp)
    op = fp2.make_operator_2d(g, *(torch.tensor(a) for a in (a11, a12, a22)),
                              loss_cone=loss_cone, device="cpu")
    f0 = torch.tensor(rng.uniform(0.5, 1.5, (na, npp)))
    return op, f0


def _run(d, tag, op, f0, dt, n_steps, save_every, lay, tol=1e-10,
         maxiter=500, timeout=300):
    """One launch of the host program on `lay`: (rc, x, snaps, iters)."""
    n_a, n_p = op.n_a, op.n_p
    coef, (inv_da, qa) = cg.coefficients(op, 0.5 * dt)
    head = np.array([lay.variant, lay.cluster, lay.threads, n_a, n_p,
                     n_steps, save_every, maxiter], np.int32)
    vals = np.array([inv_da, qa, 0.5 * dt, tol], np.float64)
    with open(d / f"{tag}.in", "wb") as fh:
        fh.write(head.tobytes() + vals.tobytes())
        for t in (*coef, f0):
            fh.write(t.to(torch.float64).contiguous().numpy().tobytes())
    subprocess.run([str(d / "cn_pcg_host"), str(d / f"{tag}.in"),
                    str(d / f"{tag}.out")], check=True, timeout=timeout)
    raw = (d / f"{tag}.out").read_bytes()
    n = n_a * n_p
    n_out = n_steps // save_every if save_every else 0
    rc = int(np.frombuffer(raw[:4], np.int32)[0])
    at = 4
    x = np.frombuffer(raw[at:at + 8 * n], np.float64).reshape(n_a, n_p)
    at += 8 * n
    snaps = np.frombuffer(raw[at:at + 8 * n_out * n], np.float64).reshape(
        n_out, n_a, n_p)
    at += 8 * n_out * n
    iters = np.frombuffer(raw[at:at + 4 * n_steps], np.int32)
    return rc, x, snaps, iters


# (grid, loss cone, cluster, threads): the layouts a grid of 20 x 23 and of
# 7 x 6 takes at 1, 2 and 4 blocks, on register instances and (threads
# too few for the cells in registers: one block of 32 threads for 460
# cells, two for 230 cells each) the state in global memory
LAYOUTS = [
    ((20, 23), c, lc, t)
    for lc in ("absorbing", "reflecting")
    for c, t in ((1, 64), (2, 64), (4, 32), (1, 32), (2, 32))
] + [((7, 6), c, lc, 32) for lc in ("absorbing", "reflecting")
     for c in (1, 2, 4)]


@pytest.mark.parametrize(
    "grid,cluster,loss_cone,threads", LAYOUTS,
    ids=[f"{g[0]}x{g[1]}-c{c}-t{t}-{lc[:3]}" for g, c, lc, t in LAYOUTS])
def test_cluster_sizes_match_plain_version_on_the_host(
        host_kernel, grid, cluster, loss_cone, threads):
    op, f0 = _case(*grid, loss_cone=loss_cone)
    lay = cg.layout(op.n_a, op.n_p, torch.float64, cluster, threads)
    assert lay.cluster == cluster and lay.threads == threads
    cells = -(-grid[0] // cluster) * grid[1]
    assert (cg.VARIANTS[lay.variant] == 0) == (2 * threads < cells)
    n_steps, every = 8, 4
    rc, x, snaps, iters = _run(host_kernel, "run", op, f0, 0.05, n_steps,
                               every, lay)
    assert rc == 0
    want, ref = fp2.evolve_cn_2d_reference(f0, op, 0.05, n_steps,
                                           save_every=every)
    it_p = fp2.evolve_cn_2d.cg_iterations.numpy()
    scale = float(want.abs().max())
    assert np.abs(x - want.numpy()).max() <= 1e-12 * scale
    assert snaps.shape == (2,) + tuple(grid)
    assert np.abs(snaps - ref.numpy()).max() <= 1e-12 * scale
    assert np.abs(iters.astype(np.int64) - it_p).max() <= 1
    assert iters.min() > 5


@pytest.mark.parametrize("cluster,threads", [(1, 32), (2, 64), (4, 32)])
def test_two_runs_are_bit_for_bit_on_the_host(host_kernel, cluster,
                                              threads):
    op, f0 = _case(20, 23, seed=7)
    lay = cg.layout(op.n_a, op.n_p, torch.float64, cluster, threads)
    a = _run(host_kernel, "a", op, f0, 0.05, 6, 3, lay)
    b = _run(host_kernel, "b", op, f0, 0.05, 6, 3, lay)
    assert a[0] == b[0] == 0
    for u, v in zip(a[1:], b[1:]):
        assert u.tobytes() == v.tobytes()


def test_fewer_rows_than_blocks_on_the_host(host_kernel):
    """The layout never chooses more blocks than rows, and a cluster that
    has them (blocks with no rows, taking part in every barrier) runs the
    evolution right."""
    op, f0 = _case(3, 9, seed=3)
    assert cg.layout(3, 9, torch.float64).cluster <= 3
    lay = cg.layout(3, 9, torch.float64, 8, 32)
    rc, x, snaps, iters = _run(host_kernel, "few", op, f0, 0.05, 5, 5, lay)
    assert rc == 0
    want = fp2.evolve_cn_2d_reference(f0, op, 0.05, 5)
    it_p = fp2.evolve_cn_2d.cg_iterations.numpy()
    scale = float(want.abs().max())
    assert np.abs(x - want.numpy()).max() <= 1e-12 * scale
    assert np.abs(snaps[0] - want.numpy()).max() <= 1e-12 * scale
    assert np.abs(iters.astype(np.int64) - it_p).max() <= 1


@pytest.mark.parametrize("variant", range(len(cg.VARIANTS)))
def test_every_instance_on_the_host(host_kernel, variant):
    """Each instance of the table on a layout it holds (a 7 x 6 grid on 2
    blocks of 32 threads: 24 cells a block) against the plain version, and
    the launch refusing a layout it does not hold (a 20 x 23 grid on one
    block of 32 threads: 460 cells, more than CPT x 32)."""
    op, f0 = _case(7, 6, seed=11)
    lay = cg.layout(7, 6, torch.float64, 2, 32)._replace(variant=variant)
    rc, x, _, iters = _run(host_kernel, f"v{variant}", op, f0, 0.05, 6, 0,
                           lay)
    assert rc == 0
    want = fp2.evolve_cn_2d_reference(f0, op, 0.05, 6)
    it_p = fp2.evolve_cn_2d.cg_iterations.numpy()
    assert np.abs(x - want.numpy()).max() <= 1e-12 * float(want.abs().max())
    assert np.abs(iters.astype(np.int64) - it_p).max() <= 1
    big, fb = _case(20, 23)
    wide = cg.layout(20, 23, torch.float64, 1, 32)._replace(variant=variant)
    rc = _run(host_kernel, f"w{variant}", big, fb, 0.05, 1, 0, wide)[0]
    assert rc == (0 if cg.VARIANTS[variant] == 0 else 1)


def test_layout_and_limits():
    """layout's choices and refusals, max_cells, the shared memory a
    layout asks for."""
    f64, f32 = torch.float64, torch.float32
    assert cg.max_cells(f64) == 150176 and cg.max_cells(f32) == 300368
    assert cg.max_cells(f64) >= 8 * 9386 and cg.max_cells(f32) >= 8 * 18773
    # a small grid on one block, the examples' grid on a cluster of 16
    lay = cg.layout(20, 23, f64)
    assert lay.cluster == 1 and cg.VARIANTS[lay.variant] > 0
    lay = cg.layout(48, 56, f64)
    assert (lay.cluster, lay.threads) == (16, 256)
    assert cg.VARIANTS[lay.variant] == 1
    # one block up to ONE_BLOCK_MAX_CELLS
    assert cg.layout(24, 28, f64).cluster == 1
    assert cg.layout(32, 32, f64).cluster == 16
    assert cg.layout(32, 32, f32).cluster == 1
    # no more blocks than rows
    assert cg.layout(5, 400, f64).cluster == 4
    # a grid past the one-block kernel's old limit, and one near the new
    for g in ((160, 100), (270, 270)):
        lay = cg.layout(*g, f64)
        assert lay.cluster == 16 and lay.smem <= cg.MAX_SHARED_BYTES
        assert lay.smem == cg.smem_bytes(*g, lay.cluster, f64)
    # bands past two cells a thread of 512 keep the state in global memory
    assert cg.layout(270, 270, f64).variant == 0
    assert cg.layout(64, 300, f64) == (16, 512, 0, cg.smem_bytes(
        64, 300, 16, f64))
    with pytest.raises(ValueError, match="150176 cells"):
        cg.layout(400, 400, f64)
    with pytest.raises(ValueError, match="300368 cells"):
        cg.layout(600, 600, f32)
    # rows too long for any band
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cg.layout(2, 20000, f64)
    with pytest.raises(ValueError, match="cluster 3"):
        cg.layout(48, 56, f64, 3, 256)
    with pytest.raises(ValueError, match="threads 100"):
        cg.layout(48, 56, f64, 1, 100)
    with pytest.raises(ValueError, match="threads 1024"):
        cg.layout(48, 56, f64, 1, 1024)
    # an instance holds the cells a thread it takes
    for cells, threads in ((2688, 256), (2688, 512), (672, 512),
                           (1024, 512), (1025, 512), (40000, 512)):
        cpt = cg.VARIANTS[cg._variant(cells, threads)]
        assert cpt == 0 or cpt * threads >= cells
        assert (cpt == 0) == (2 * threads < cells)
