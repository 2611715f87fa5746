// Crank-Nicolson evolution of the 2D pitch-angle x momentum
// Fokker-Planck equation, every step's Jacobi-preconditioned conjugate
// gradient solve included, in one launch: the hand-written Hopper kernel
// behind raytrace_tpu_torch/fokker_planck_2d.py::evolve_cn_2d.
//
// What it replaces. Not a Pallas kernel: the JAX package runs this loop
// (raytrace_tpu/fokker_planck_2d.py::evolve_cn_2d, a lax.scan of CN steps
// around the while_loop of _pcg) through XLA outside Pallas. Its plain
// PyTorch port (evolve_cn_2d_reference) dispatches ~40 torch ops per
// stencil and ~60 per CG iteration; at ~200 iterations per step and
// 1,440 steps an evolution, the card would spend its time launching them.
//
// What bounds it. The grids are small (the examples' 48 x 56 = 2,688
// cells): one iteration does ~1.3e5 operations and moves ~0.2 MB of
// coefficients, far below what the card could carry in a microsecond.
// The loop is bound by its chain of dependent steps and, in one block,
// by one SM's arithmetic: the stencil, two block-wide reductions and the
// search direction's update, each behind a barrier. So the design keeps
// everything in one block and one launch, with no host round trip per
// iteration, and keeps the work per cell small:
//   - one thread block of 1024 threads per evolution, each thread owning
//     the cells c = tid, tid + 1024, ... of the row-major (n_a, n_p) grid;
//   - the face coefficients formed once by the wrapper
//     (fokker_planck_2d._Stencil: ka, kp, qp, 1/dpc), so a face flux is
//     five operations and no division;
//   - the stencil in two passes over shared memory: each cell's r_x S_p
//     and r_x S_a (its face-gradient sums times the rank-1 weight), then,
//     after a barrier, each cell's four face fluxes and their divergence;
//   - the search direction p (f while a step's right-hand side is formed)
//     and the two sums in shared memory; x, r and A p in global scratch,
//     each cell touched only by its owner thread (they and the
//     coefficients stay in L1/L2);
//   - dot products as fixed-order block reductions: each thread sums its
//     cells in order, each warp by an xor butterfly, then every warp adds
//     the 32 warp sums by the same butterfly -- so every thread holds the
//     same bits and a run is deterministic;
//   - four barriers per CG iteration (the stencil's, the two reductions',
//     and p's).
// Built without fast-math and with -fmad=false: each product and sum
// rounds as the plain version's torch ops do, on the same coefficient
// tensors. The reductions run in another order than torch's, so the
// kernel and the plain version part in the last bits (and a step's
// iteration count may differ by one where the residual lands on the stop
// test). Making it fast across SMs (a cluster of blocks, the stencil in
// distributed shared memory) is later work.
//
// Per CN step (as fokker_planck_2d._cg_bodies): b = M f - dt/2 A f,
// r = b - (M f + dt/2 A f), z = m_inv r, p = z, eps = tol max(|b|,
// 1e-300); while |r| > eps and k < maxiter: hp = M p + dt/2 A p,
// alpha = rz / max(p.hp, tiny), x += alpha p, r -= alpha hp, z = m_inv r,
// p = z + (rz_new / max(rz, tiny)) p. tiny is 1e-37 in float, 1e-300 in
// double.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the second reduction stage is one warp wide");

template <typename T>
struct Op {
  const T* __restrict__ ka;       // (n_a-1, n_p) alpha-face coefficient
  const T* __restrict__ kp;       // (n_a, n_p-1) p-face coefficient
  const T* __restrict__ qp;       // (n_p-1,) 1 / (4 dpc)
  const T* __restrict__ inv_dpc;  // (n_p-1,)
  const T* __restrict__ r_x;      // (n_a, n_p) signed rank-1 weight
  const T* __restrict__ k_lc;     // (n_p,) loss-cone wall
  const T* __restrict__ mass;     // (n_a, n_p)
  const T* __restrict__ m_inv;    // 1 / (mass + dt/2 diag)
  int n_a, n_p;
  T inv_da, qa;                   // 1 / da, 1 / (4 da)
};

template <typename T> __device__ __forceinline__ T tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() {
  return 1.0e-37f;
}
template <> __device__ __forceinline__ double tiny_of<double>() {
  return 1.0e-300;
}

// pass 1 of the stencil at cell c = (i, j): v = r_x S_a and w = r_x S_p,
// S the sum of the cell's two face gradients (zero at the walls)
template <typename T>
__device__ __forceinline__ void sums(const Op<T>& op, const T* p, T* v,
                                     T* w, int c, int i, int j) {
  const int np_ = op.n_p;
  const T pc = p[c];
  const T ga_lo = i > 0 ? (pc - p[c - np_]) * op.inv_da : T(0);
  const T ga_hi = i < op.n_a - 1 ? (p[c + np_] - pc) * op.inv_da : T(0);
  const T gp_lo = j > 0 ? (pc - p[c - 1]) * op.inv_dpc[j - 1] : T(0);
  const T gp_hi = j < np_ - 1 ? (p[c + 1] - pc) * op.inv_dpc[j] : T(0);
  const T rx = op.r_x[c];
  v[c] = rx * (ga_lo + ga_hi);
  w[c] = rx * (gp_lo + gp_hi);
}

// pass 2 at cell c = (i, j): (A p)_c, the divergence of its four face
// fluxes F_a = ka d + qa (w_lo + w_hi), F_p = kp d + qp (v_lo + v_hi),
// and the loss-cone wall term on the first row
template <typename T>
__device__ __forceinline__ T divergence(const Op<T>& op, const T* p,
                                        const T* v, const T* w, int c,
                                        int i, int j) {
  const int np_ = op.n_p;
  const T pc = p[c];
  T fa_lo = T(0), fa_hi = T(0), fp_lo = T(0), fp_hi = T(0);
  if (i > 0)
    fa_lo = op.ka[c - np_] * (pc - p[c - np_])
            + op.qa * (w[c - np_] + w[c]);
  if (i < op.n_a - 1)
    fa_hi = op.ka[c] * (p[c + np_] - pc) + op.qa * (w[c] + w[c + np_]);
  const int f = i * (np_ - 1) + j;   // p face j of row i is kp[f - 1]
  if (j > 0)
    fp_lo = op.kp[f - 1] * (pc - p[c - 1])
            + op.qp[j - 1] * (v[c - 1] + v[c]);
  if (j < np_ - 1)
    fp_hi = op.kp[f] * (p[c + 1] - pc) + op.qp[j] * (v[c] + v[c + 1]);
  T out = (fa_lo - fa_hi) + (fp_lo - fp_hi);
  if (i == 0) out = out + op.k_lc[j] * pc;
  return out;
}

// sum of a value over a warp by an xor butterfly: every lane ends with the
// same bits (each step adds the same two partial sums on both lanes)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sums of N per-thread values, in a fixed order: each warp's
// butterfly, the warp sums through shared memory, then every warp the
// same butterfly over them. buf is one of three rotating shared buffers,
// written again only after two more barriers, so no thread still reads
// it.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T (*buf)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const T s = warp_sum(v[q]);
    if (lane == 0) buf[q][warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = warp_sum(buf[q][lane]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cn_pcg_2d_kernel(Op<T> op, T* __restrict__ x, T* __restrict__ r,
                 T* __restrict__ hp, T* __restrict__ snaps,
                 int* __restrict__ iters, int n_steps, int save_every,
                 T half, T tol, int maxiter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = op.n_a * op.n_p;
  T* p = reinterpret_cast<T*>(smem_raw);
  T* v = p + n;
  T* w = v + n;
  __shared__ T red[3][3][kWarps];
  const int tid = threadIdx.x;
  const T tiny = tiny_of<T>();
  const T floor_b = T(1.0e-300);

  for (int step = 0; step < n_steps; ++step) {
    // the right-hand side from f = x: the stencil reads f from shared
    for (int c = tid; c < n; c += kThreads) p[c] = x[c];
    __syncthreads();
    for (int c = tid; c < n; c += kThreads) {
      const int i = c / op.n_p;
      sums(op, p, v, w, c, i, c - i * op.n_p);
    }
    __syncthreads();
    T acc[3] = {T(0), T(0), T(0)};     // r.z, b.b, r.r
    for (int c = tid; c < n; c += kThreads) {
      const int i = c / op.n_p;
      const T f = p[c];
      const T af = divergence(op, p, v, w, c, i, c - i * op.n_p);
      const T b = op.mass[c] * f - half * af;
      const T rc = b - (op.mass[c] * f + half * af);
      r[c] = rc;
      const T z = op.m_inv[c] * rc;
      acc[0] = acc[0] + rc * z;
      acc[1] = acc[1] + b * b;
      acc[2] = acc[2] + rc * rc;
    }
    block_sum<T, 3>(acc, red[0]);
    T rz = acc[0];
    const T bnorm = sqrt(acc[1]);
    const T eps = tol * (bnorm > floor_b ? bnorm : floor_b);
    T rr = acc[2];
    for (int c = tid; c < n; c += kThreads) p[c] = op.m_inv[c] * r[c];
    __syncthreads();

    int k = 0;
    while (sqrt(rr) > eps && k < maxiter) {
      for (int c = tid; c < n; c += kThreads) {
        const int i = c / op.n_p;
        sums(op, p, v, w, c, i, c - i * op.n_p);
      }
      __syncthreads();
      T a1[1] = {T(0)};
      for (int c = tid; c < n; c += kThreads) {
        const int i = c / op.n_p;
        const T h = op.mass[c] * p[c]
                    + half * divergence(op, p, v, w, c, i, c - i * op.n_p);
        hp[c] = h;
        a1[0] = a1[0] + p[c] * h;
      }
      block_sum<T, 1>(a1, red[1]);
      const T alpha = rz / (a1[0] > tiny ? a1[0] : tiny);
      T a2[2] = {T(0), T(0)};          // r.z, r.r of the new residual
      for (int c = tid; c < n; c += kThreads) {
        x[c] = x[c] + alpha * p[c];
        const T rc = r[c] - alpha * hp[c];
        r[c] = rc;
        const T z = op.m_inv[c] * rc;
        a2[0] = a2[0] + rc * z;
        a2[1] = a2[1] + rc * rc;
      }
      block_sum<T, 2>(a2, red[2]);
      const T beta = a2[0] / (rz > tiny ? rz : tiny);
      rz = a2[0];
      rr = a2[1];
      ++k;
      for (int c = tid; c < n; c += kThreads)
        p[c] = op.m_inv[c] * r[c] + beta * p[c];
      __syncthreads();
    }
    if (tid == 0) iters[step] = k;
    if (save_every > 0 && (step + 1) % save_every == 0) {
      T* out = snaps + static_cast<long long>((step + 1) / save_every - 1) * n;
      for (int c = tid; c < n; c += kThreads) out[c] = x[c];
    }
  }
}

template <typename T>
int launch(const void* const* coef, int n_a, int n_p, double inv_da,
           double qa, void* x, void* work, void* snaps, int* iters,
           int n_steps, int save_every, double half, double tol,
           int maxiter, void* stream) {
  Op<T> op;
  op.ka = static_cast<const T*>(coef[0]);
  op.kp = static_cast<const T*>(coef[1]);
  op.qp = static_cast<const T*>(coef[2]);
  op.inv_dpc = static_cast<const T*>(coef[3]);
  op.r_x = static_cast<const T*>(coef[4]);
  op.k_lc = static_cast<const T*>(coef[5]);
  op.mass = static_cast<const T*>(coef[6]);
  op.m_inv = static_cast<const T*>(coef[7]);
  op.n_a = n_a;
  op.n_p = n_p;
  op.inv_da = static_cast<T>(inv_da);
  op.qa = static_cast<T>(qa);
  const long long n = static_cast<long long>(n_a) * n_p;
  const size_t smem = static_cast<size_t>(3 * n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      cn_pcg_2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  T* wk = static_cast<T*>(work);
  cn_pcg_2d_kernel<T><<<1, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<T*>(x), wk, wk + n, static_cast<T*>(snaps), iters,
      n_steps, save_every, static_cast<T>(half), static_cast<T>(tol),
      maxiter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 float64. coef: the device pointers of ka, kp, qp,
// inv_dpc, r_x, k_lc, mass, m_inv (contiguous, in the dtype); inv_da and
// qa = 1/(4 da) as doubles. x: (n_a, n_p), f0 on entry, f_end on return;
// work: 2 n_a n_p scratch; snaps: (n_steps / save_every, n_a, n_p) or
// unused; iters: (n_steps,) int32. Returns the CUDA error code of the
// launch (0 = launched).
int cn_pcg_2d_launch(int dtype, int n_a, int n_p, double inv_da, double qa,
                     const void* const* coef, void* x, void* work,
                     void* snaps, int* iters, int n_steps, int save_every,
                     double half, double tol, int maxiter, void* stream) {
  if (dtype == 0)
    return launch<float>(coef, n_a, n_p, inv_da, qa, x, work, snaps, iters,
                         n_steps, save_every, half, tol, maxiter, stream);
  return launch<double>(coef, n_a, n_p, inv_da, qa, x, work, snaps, iters,
                        n_steps, save_every, half, tol, maxiter, stream);
}

}  // extern "C"
