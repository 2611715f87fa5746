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
// cells): one iteration does ~9.4e4 operations, far below what the card
// could do in a microsecond. An iteration is a chain: the stencil, a
// reduction, the x/r update, a second reduction, the search direction,
// each behind a barrier. On one SM the passes over the cells also queue
// for its load/store path (p, v, w and the coefficients, ~260 bytes a
// cell in float64). So the design spreads the cells over the SMs of a
// cluster, keeps each pass's work in registers, and makes the chain's
// synchronisation as short as the hardware allows:
//   - one launch an evolution, no host round trip; one thread-block
//     cluster of nb blocks (nb = 1 is one block), the grid's rows split
//     into nb contiguous bands, block b owning band b;
//   - ownership fixed for the launch: thread t owns the cells t, t + nt,
//     ... of its band (at most CPT), their (i, j), smem and global
//     indices and wall flags computed once, so no pass divides;
//   - x, r, A p and z of the owned cells in registers; the coefficients
//     (ka and kp on both faces, qp and 1/dpc on both p faces, r_x, k_lc,
//     mass, m_inv) loaded once into registers by the instances that hold
//     1 or 2 cells a thread (CPT > 0), else read through the read-only
//     path, which keeps them in L1; only p, v = r_x S_a and w = r_x S_p,
//     which neighbours read, live in shared memory, p and w with one halo
//     row above and below the band;
//   - the halo rows without a barrier of their own: a block recomputes a
//     halo row's w from its p (the same expression, so the same bits as
//     the owner's), and forms a halo row's new p itself, m_inv r + beta p
//     (the owner's expression), from the owner's new r, which the owner
//     stores into the block's shared memory with the second reduction's
//     exchange; only a CN step's set-up reads a neighbour's p (= x) after
//     a cluster barrier;
//   - dot products as fixed-order reductions: each warp's xor butterfly,
//     the warps' sums in shared memory, every warp (one block) or warp 0
//     (a cluster) adding them by the same butterfly; in a cluster, lane r
//     of warp 0 stores the block's sum into block r's shared memory by
//     st.async, counted on that block's mbarrier, and every thread adds
//     the nb sums in rank order by the same butterfly once its block's
//     mbarrier completes -- so every thread of every block holds the same
//     bits, takes the same branch of the stop test, and a run is
//     deterministic (a block whose bits differed would leave the loop
//     alone and the others would wait on its stores forever). The
//     mbarrier makes the stored values visible without the cluster-scope
//     release and acquire that a cluster barrier would cost twice an
//     iteration;
//   - per CG iteration two block barriers (after the stencil's first
//     pass and after p) and two exchanges, a cluster barrier a CN step,
//     and one before any block exits, since a block must not leave while
//     another still reads or stores into its shared memory.
// Built without fast-math and with -fmad=false: each product and sum
// rounds as the plain version's torch ops do, on the same coefficient
// tensors. The reductions run in another order than torch's, so the
// kernel and the plain version part in the last bits (and a step's
// iteration count may differ by one where the residual lands on the stop
// test). The wrapper (ops/cn_pcg_2d.py::layout) picks the cluster size,
// the block width and the instance from the grid.
//
// Per CN step (as fokker_planck_2d._cg_bodies): b = M f - dt/2 A f,
// r = b - (M f + dt/2 A f), z = m_inv r, p = z, eps = tol max(|b|,
// 1e-300); while |r| > eps and k < maxiter: hp = M p + dt/2 A p,
// alpha = rz / max(p.hp, tiny), x += alpha p, r -= alpha hp, z = m_inv r,
// p = z + (rz_new / max(rz, tiny)) p. tiny is 1e-37 in float, 1e-300 in
// double.
//
// cn_pcg_2d_floor_launch runs the same loop's synchronisation skeleton
// alone (its barriers, reductions, divides and stop test, no stencil):
// the latency floor of an iteration at a cluster size and block width.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

namespace cgrp = cooperative_groups;

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

// a cell's wall flags: which of its four faces are interior, whether it
// lies on the loss-cone row, and whether it is its band's first or last
// row (whose values the neighbouring blocks read)
enum : int {
  kALo = 1, kAHi = 2, kPLo = 4, kPHi = 8, kWall = 16, kFirst = 32,
  kLast = 64,
};

// an owned cell: its index in the block's shared arrays (row-major over
// the band and its two halo rows), in the grid, of its upper p face in
// kp, its column and its flags
struct Cell {
  int s, c, f, j, fl;
};

// the cluster barrier (release / acquire: what every block wrote before
// it is visible after it); once a CN step and before a block exits
__device__ __forceinline__ void cluster_barrier() {
  cgrp::this_cluster().sync();
}

// ---- the cluster's exchange primitives (sm_90 PTX) ----
// An mbarrier in shared memory counts one arrival a phase (the block's
// own expect) and the bytes that the other blocks' st.async stores bring;
// a phase completes when both are in. Waiting on it makes the stored
// values visible to the block with no cluster-scope fence, which a
// release / acquire cluster barrier would pay twice an iteration.
__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// this block's arrival on its own barrier, with the bytes the phase waits
// for
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// v into block `rank`'s copy of *slot, counted on its copy of *bar
__device__ __forceinline__ void push(double* slot, int rank, double v,
                                     unsigned long long* bar) {
  unsigned a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a)
               : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(b)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, "
      "[%2];" ::"r"(a), "d"(v), "r"(b)
      : "memory");
}
__device__ __forceinline__ void push(float* slot, int rank, float v,
                                     unsigned long long* bar) {
  unsigned a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a)
               : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(b)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(a), "f"(v), "r"(b)
      : "memory");
}
// a coefficient through the read-only path, as a volatile load: the
// compiler keeps it where it is used and does not hoist the loop-invariant
// loads of every owned cell into registers (which spills)
__device__ __forceinline__ double ld_coef(const double* ptr) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(ptr));
  return v;
}
__device__ __forceinline__ float ld_coef(const float* ptr) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(ptr));
  return v;
}
// ---- end of the exchange primitives ----

// the coefficients of one cell, in registers
template <typename T>
struct CoefRegs {
  T ka_lo_, ka_hi_, kp_lo_, kp_hi_, qp_lo_, qp_hi_, id_lo_, id_hi_, rx_,
      mass_, minv_, klc_;
  __device__ __forceinline__ void load(const Op<T>& op, const Cell& e) {
    const T z = T(0);
    ka_lo_ = (e.fl & kALo) ? op.ka[e.c - op.n_p] : z;
    ka_hi_ = (e.fl & kAHi) ? op.ka[e.c] : z;
    kp_lo_ = (e.fl & kPLo) ? op.kp[e.f - 1] : z;
    kp_hi_ = (e.fl & kPHi) ? op.kp[e.f] : z;
    qp_lo_ = (e.fl & kPLo) ? op.qp[e.j - 1] : z;
    qp_hi_ = (e.fl & kPHi) ? op.qp[e.j] : z;
    id_lo_ = (e.fl & kPLo) ? op.inv_dpc[e.j - 1] : z;
    id_hi_ = (e.fl & kPHi) ? op.inv_dpc[e.j] : z;
    rx_ = op.r_x[e.c];
    mass_ = op.mass[e.c];
    minv_ = op.m_inv[e.c];
    klc_ = (e.fl & kWall) ? op.k_lc[e.j] : z;
  }
  __device__ __forceinline__ T ka_lo(const Op<T>&, const Cell&) const {
    return ka_lo_;
  }
  __device__ __forceinline__ T ka_hi(const Op<T>&, const Cell&) const {
    return ka_hi_;
  }
  __device__ __forceinline__ T kp_lo(const Op<T>&, const Cell&) const {
    return kp_lo_;
  }
  __device__ __forceinline__ T kp_hi(const Op<T>&, const Cell&) const {
    return kp_hi_;
  }
  __device__ __forceinline__ T qp_lo(const Op<T>&, const Cell&) const {
    return qp_lo_;
  }
  __device__ __forceinline__ T qp_hi(const Op<T>&, const Cell&) const {
    return qp_hi_;
  }
  __device__ __forceinline__ T id_lo(const Op<T>&, const Cell&) const {
    return id_lo_;
  }
  __device__ __forceinline__ T id_hi(const Op<T>&, const Cell&) const {
    return id_hi_;
  }
  __device__ __forceinline__ T rx(const Op<T>&, const Cell&) const {
    return rx_;
  }
  __device__ __forceinline__ T mass(const Op<T>&, const Cell&) const {
    return mass_;
  }
  __device__ __forceinline__ T minv(const Op<T>&, const Cell&) const {
    return minv_;
  }
  __device__ __forceinline__ T klc(const Op<T>&, const Cell&) const {
    return klc_;
  }
};

// the same, read where they are used (the read-only path keeps them in L1)
template <typename T>
struct CoefLoads {
  __device__ __forceinline__ void load(const Op<T>&, const Cell&) {}
  __device__ __forceinline__ T ka_lo(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.ka[e.c - op.n_p]);
  }
  __device__ __forceinline__ T ka_hi(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.ka[e.c]);
  }
  __device__ __forceinline__ T kp_lo(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.kp[e.f - 1]);
  }
  __device__ __forceinline__ T kp_hi(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.kp[e.f]);
  }
  __device__ __forceinline__ T qp_lo(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.qp[e.j - 1]);
  }
  __device__ __forceinline__ T qp_hi(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.qp[e.j]);
  }
  __device__ __forceinline__ T id_lo(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.inv_dpc[e.j - 1]);
  }
  __device__ __forceinline__ T id_hi(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.inv_dpc[e.j]);
  }
  __device__ __forceinline__ T rx(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.r_x[e.c]);
  }
  __device__ __forceinline__ T mass(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.mass[e.c]);
  }
  __device__ __forceinline__ T minv(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.m_inv[e.c]);
  }
  __device__ __forceinline__ T klc(const Op<T>& op, const Cell& e) const {
    return ld_coef(&op.k_lc[e.j]);
  }
};

// pass 1 of the stencil at an owned cell: v = r_x S_a and w = r_x S_p, S
// the sum of the cell's two face gradients (zero at the walls); p and w
// are indexed over the band and its halo rows, v over the band alone
template <typename T, class C>
__device__ __forceinline__ void sums(const Op<T>& op, const C& co,
                                     const Cell& e, const T* p, T* v, T* w) {
  const int s = e.s, np_ = op.n_p;
  const T pc = p[s];
  const T ga_lo = (e.fl & kALo) ? (pc - p[s - np_]) * op.inv_da : T(0);
  const T ga_hi = (e.fl & kAHi) ? (p[s + np_] - pc) * op.inv_da : T(0);
  const T gp_lo = (e.fl & kPLo) ? (pc - p[s - 1]) * co.id_lo(op, e) : T(0);
  const T gp_hi = (e.fl & kPHi) ? (p[s + 1] - pc) * co.id_hi(op, e) : T(0);
  const T rx = co.rx(op, e);
  v[s - np_] = rx * (ga_lo + ga_hi);
  w[s] = rx * (gp_lo + gp_hi);
}

// w = r_x S_p at a halo cell (smem index s, grid index c, column j): the
// owner's expression for w, so the same bits
template <typename T>
__device__ __forceinline__ void halo_w(const Op<T>& op, const T* p, T* w,
                                       int s, int c, int j) {
  const T pc = p[s];
  const T gp_lo = j > 0 ? (pc - p[s - 1]) * op.inv_dpc[j - 1] : T(0);
  const T gp_hi = j < op.n_p - 1 ? (p[s + 1] - pc) * op.inv_dpc[j] : T(0);
  w[s] = op.r_x[c] * (gp_lo + gp_hi);
}

// pass 2 at an owned cell: (A p) there, the divergence of its four face
// fluxes F_a = ka d + qa (w_lo + w_hi), F_p = kp d + qp (v_lo + v_hi),
// and the loss-cone wall term on the first row
template <typename T, class C>
__device__ __forceinline__ T divergence(const Op<T>& op, const C& co,
                                        const Cell& e, const T* p,
                                        const T* v, const T* w) {
  const int s = e.s, np_ = op.n_p;
  const T pc = p[s];
  T fa_lo = T(0), fa_hi = T(0), fp_lo = T(0), fp_hi = T(0);
  if (e.fl & kALo)
    fa_lo = co.ka_lo(op, e) * (pc - p[s - np_])
            + op.qa * (w[s - np_] + w[s]);
  if (e.fl & kAHi)
    fa_hi = co.ka_hi(op, e) * (p[s + np_] - pc)
            + op.qa * (w[s] + w[s + np_]);
  if (e.fl & kPLo)
    fp_lo = co.kp_lo(op, e) * (pc - p[s - 1])
            + co.qp_lo(op, e) * (v[s - np_ - 1] + v[s - np_]);
  if (e.fl & kPHi)
    fp_hi = co.kp_hi(op, e) * (p[s + 1] - pc)
            + co.qp_hi(op, e) * (v[s - np_] + v[s - np_ + 1]);
  T out = (fa_lo - fa_hi) + (fp_lo - fp_hi);
  if (e.fl & kWall) out = out + co.klc(op, e) * pc;
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

// the same butterfly over the lowest `width` lanes' pattern (width a power
// of two up to 32): lane l ends with the sum of the lanes l ^ m, m < width
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block or cluster the loop runs on: nb blocks (a power of two, 1 for
// one block), nw warps a block (a power of two), this block's rank.
struct Team {
  int nb, rank, nw, lane, warp;
};


// One exchange of the cluster: a reduction's block sums and, for the
// second reduction and the set-up's, the new residual of the band's edge
// rows. bar: this block's mbarrier; part: its N x 16 slots, one a block
// rank; phase: the barrier's uses so far (the same in every thread).
template <typename T>
struct Exchange {
  unsigned long long* bar;
  T* part;
  unsigned phase;
};

// Sums of N per-thread values over the block or cluster, in a fixed
// order. slot: N x 32 values of this block's shared memory for the
// warps' sums. One block: every warp adds the warp sums by the same
// butterfly. A cluster: warp 0 adds them so (the block's sum), lane r
// stores it into block r's slot for this rank (st.async), every thread
// waits on its block's barrier for the nb sums (and halo_bytes of edge
// rows) and adds them in rank order by the same butterfly. Every thread of
// every block returns the same bits.
template <typename T, int N>
__device__ __forceinline__ void team_sum(const Team& tm, T (&v)[N], T* slot,
                                         Exchange<T>& ex,
                                         unsigned halo_bytes) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const T s = warp_sum(v[q]);
    if (tm.lane == 0) slot[q * 32 + tm.warp] = s;
  }
  if (tm.nb > 1 && threadIdx.x == 0)
    mbar_expect(ex.bar, tm.nb * N * sizeof(T) + halo_bytes);
  __syncthreads();
  if (tm.nb == 1) {
#pragma unroll
    for (int q = 0; q < N; ++q)
      v[q] = group_sum(slot[q * 32 + (tm.lane & (tm.nw - 1))], tm.nw);
    return;
  }
  if (tm.warp == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const T b = group_sum(slot[q * 32 + (tm.lane & (tm.nw - 1))], tm.nw);
      if (tm.lane < tm.nb)
        push(ex.part + q * 16 + tm.rank, tm.lane, b, ex.bar);
    }
  }
  mbar_wait(ex.bar, ex.phase & 1);
  ++ex.phase;
#pragma unroll
  for (int q = 0; q < N; ++q)
    v[q] = group_sum(ex.part[q * 16 + (tm.lane & (tm.nb - 1))], tm.nb);
}

// An owned cell from its place: l over the band, il its row in the band,
// j its column.
__device__ __forceinline__ Cell cell_at(int l, int il, int j, int ra,
                                        int nr, int n_a, int np_) {
  Cell e;
  const int i = ra + il;
  e.s = l + np_;
  e.c = ra * np_ + l;
  e.f = i * (np_ - 1) + j;
  e.j = j;
  e.fl = (i > 0 ? kALo : 0) | (i < n_a - 1 ? kAHi : 0) | (j > 0 ? kPLo : 0)
         | (j < np_ - 1 ? kPHi : 0) | (i == 0 ? kWall : 0)
         | (il == 0 ? kFirst : 0) | (il == nr - 1 ? kLast : 0);
  return e;
}

// Runs its statements for every owned cell, with e (the Cell), X, R, HP,
// Z (the cell's x, r, A p and z, lvalues) and K (its coefficients): with
// CPT > 0 over the cells held in registers, the loop unrolled so that they
// stay there; with CPT == 0 over the band, x, r and A p in the global
// arrays (each touched only by its owner) and z a local. A macro, so that
// the statements are inlined in the kernel and no array goes to local
// memory.
#define CN_EACH(...)                                                       \
  if constexpr (CPT > 0) {                                                 \
    _Pragma("unroll") for (int q_ = 0; q_ < kN; ++q_) {                    \
      if (q_ < n_own) {                                                    \
        const Cell e = cell_at(tid + q_ * nt, own_il[q_], own_j[q_], ra,   \
                               nr, n_a, np_);                              \
        T& X = own_x[q_];                                                  \
        T& R = own_r[q_];                                                  \
        T& HP = own_hp[q_];                                                \
        T& Z = own_z[q_];                                                  \
        const Coef& K = co[q_];                                            \
        __VA_ARGS__                                                        \
      }                                                                    \
    }                                                                      \
  } else {                                                                 \
    int il_ = i0, j_ = j0;                                                 \
    for (int l_ = tid; l_ < nc; l_ += nt) {                                \
      const Cell e = cell_at(l_, il_, j_, ra, nr, n_a, np_);               \
      T& X = gx[e.c];                                                      \
      T& R = gr[e.c];                                                      \
      T& HP = ghp[e.c];                                                    \
      T z_ = T(0);                                                         \
      T& Z = z_;                                                           \
      const Coef& K = co[0];                                               \
      __VA_ARGS__                                                          \
      il_ += di;                                                           \
      j_ += dj;                                                            \
      if (j_ >= np_) {                                                     \
        j_ -= np_;                                                         \
        ++il_;                                                             \
      }                                                                    \
    }                                                                      \
  }

// Runs its statements for this thread's halo cells, with side (0: the row
// above the band, 1: the row below), j, s (its index in p and w) and c (in
// the grid).
#define CN_EACH_HALO(...)                                                  \
  if (up || down) {                                                        \
    int side = i0, j = j0;                                                 \
    while (side < 2) {                                                     \
      if (side == 0 ? up : down) {                                         \
        const int s = side == 0 ? j : (nr + 1) * np_ + j;                  \
        const int c = side == 0 ? (ra - 1) * np_ + j : (ra + nr) * np_ + j; \
        __VA_ARGS__                                                        \
      }                                                                    \
      side += di;                                                          \
      j += dj;                                                             \
      if (j >= np_) {                                                      \
        j -= np_;                                                          \
        ++side;                                                            \
      }                                                                    \
    }                                                                      \
  }

// the most threads a block (__launch_bounds__: up to 128 registers a
// thread; the layout takes 128 to 512)
constexpr int kMaxThreads = 512;

template <typename T, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
cn_pcg_2d_kernel(Op<T> op, T* __restrict__ gx, T* __restrict__ gr,
                 T* __restrict__ ghp, T* __restrict__ snaps,
                 int* __restrict__ iters, int n_steps, int save_every,
                 T half, T tol, int maxiter) {
  using Coef = typename std::conditional<(CPT > 0), CoefRegs<T>,
                                         CoefLoads<T>>::type;
  constexpr int kN = CPT > 0 ? CPT : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np_ = op.n_p, n_a = op.n_a, nt = blockDim.x;
  Team tm;
  tm.nb = gridDim.x;
  tm.rank = blockIdx.x;
  tm.nw = nt >> 5;
  tm.lane = threadIdx.x & 31;
  tm.warp = threadIdx.x >> 5;
  const int tid = threadIdx.x;
  // this block's band of rows [ra, ra + nr): n_a / nb rows each, the
  // first n_a % nb blocks one more
  const int base = n_a / tm.nb, extra = n_a % tm.nb;
  const int nr = base + (tm.rank < extra ? 1 : 0);
  const int ra = tm.rank * base + (tm.rank < extra ? tm.rank : extra);
  const int rows = base + (extra ? 1 : 0) + 2;   // with the halo rows
  const int nc = nr * np_;                       // the band's cells
  // the halo rows that exist
  const bool up = nr > 0 && ra > 0, down = nr > 0 && ra + nr < n_a;
  // shared memory: the three exchanges' mbarriers, the reductions' warp
  // sums (6 x 32) and the blocks' sums (6 x 16), then p and w over the band
  // and its halo rows, v over the band, then the halo rows' new residual
  // as their owners store it (side 0 the row above, 1 the row below)
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  T* slot = reinterpret_cast<T*>(bars + 4);
  T* part = slot + 6 * 32;
  T* p = part + 6 * 16;
  T* w = p + rows * np_;
  T* v = w + rows * np_;
  T* halo_r = v + (rows - 2) * np_;
  // the set-up's exchange, the first reduction's and the second's
  Exchange<T> ex_s{bars, part, 0}, ex_a{bars + 1, part + 3 * 16, 0},
      ex_b{bars + 2, part + 4 * 16, 0};
  // the bytes of edge rows a block receives in ex_s and ex_b
  const unsigned halo_bytes = ((up ? np_ : 0) + (down ? np_ : 0)) * sizeof(T);
  if (tm.nb > 1) {
    if (tid < 3) mbar_init(bars + tid);
    cluster_barrier();
  }
  const T tiny = tiny_of<T>();
  const T floor_b = T(1.0e-300);

  // the owned cells l = tid + q nt of the band, walked once: their row and
  // column (the one division of the launch), and with CPT > 0 their
  // coefficients and x
  const int i0 = tid / np_, j0 = tid - i0 * np_;
  const int di = nt / np_, dj = nt - di * np_;
  int own_il[kN], own_j[kN], n_own = 0;
  T own_x[kN], own_r[kN], own_hp[kN], own_z[kN];
  Coef co[kN];
  if constexpr (CPT > 0) {
    int il = i0, j = j0;
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      own_il[q] = il;
      own_j[q] = j;
      if (tid + q * nt < nc) {
        n_own = q + 1;
        const Cell e = cell_at(tid + q * nt, il, j, ra, nr, n_a, np_);
        co[q].load(op, e);
        own_x[q] = gx[e.c];
      }
      il += di;
      j += dj;
      if (j >= np_) {
        j -= np_;
        ++il;
      }
    }
  }
  // the rows of the neighbours' p a step's set-up reads: the last row of
  // the block above, the first of the block below
  const int nr_up = base + (tm.rank - 1 < extra ? 1 : 0);
  // a new residual on the band's first row goes to the block above (its
  // row below), on the last to the block below, in the exchange `ex`
  auto send_edge = [&](const Cell& e, T rc, Exchange<T>& ex) {
    if ((e.fl & kFirst) && up)
      push(halo_r + np_ + e.j, tm.rank - 1, rc, ex.bar);
    if ((e.fl & kLast) && down) push(halo_r + e.j, tm.rank + 1, rc, ex.bar);
  };

  for (int step = 0; step < n_steps; ++step) {
    // the right-hand side from f = x: the stencil reads f as p, the halo
    // rows from the neighbours' p (which no block writes again before the
    // set-up's reduction)
    CN_EACH(p[e.s] = X;)
    if (tm.nb > 1) {
      cluster_barrier();
      cgrp::cluster_group cl = cgrp::this_cluster();
      CN_EACH_HALO(p[s] = side == 0
                   ? cl.map_shared_rank(p, tm.rank - 1)[nr_up * np_ + j]
                   : cl.map_shared_rank(p, tm.rank + 1)[np_ + j];)
    }
    __syncthreads();
    CN_EACH(sums(op, K, e, p, v, w);)
    CN_EACH_HALO(halo_w(op, p, w, s, c, j);)
    __syncthreads();
    T acc[3] = {T(0), T(0), T(0)};     // r.z, b.b, r.r
    CN_EACH(
      const T f = p[e.s];
      const T af = divergence(op, K, e, p, v, w);
      const T b = K.mass(op, e) * f - half * af;
      const T rc = b - (K.mass(op, e) * f + half * af);
      R = rc;
      Z = K.minv(op, e) * rc;
      acc[0] = acc[0] + rc * Z;
      acc[1] = acc[1] + b * b;
      acc[2] = acc[2] + rc * rc;
      if (tm.nb > 1) send_edge(e, rc, ex_s);
    )
    team_sum<T, 3>(tm, acc, slot, ex_s, halo_bytes);
    T rz = acc[0];
    const T bnorm = sqrt(acc[1]);
    const T eps = tol * (bnorm > floor_b ? bnorm : floor_b);
    T rr = acc[2];
    // p = z = m_inv r, the halo rows' from the owners' r
    CN_EACH(p[e.s] = CPT > 0 ? Z : K.minv(op, e) * R;)
    CN_EACH_HALO(p[s] = op.m_inv[c] * halo_r[side * np_ + j];)
    __syncthreads();

    int k = 0;
    while (sqrt(rr) > eps && k < maxiter) {
      CN_EACH(sums(op, K, e, p, v, w);)
      CN_EACH_HALO(halo_w(op, p, w, s, c, j);)
      __syncthreads();
      T a1[1] = {T(0)};
      CN_EACH(
        const T h = K.mass(op, e) * p[e.s]
                    + half * divergence(op, K, e, p, v, w);
        HP = h;
        a1[0] = a1[0] + p[e.s] * h;
      )
      team_sum<T, 1>(tm, a1, slot + 3 * 32, ex_a, 0);
      const T alpha = rz / (a1[0] > tiny ? a1[0] : tiny);
      T a2[2] = {T(0), T(0)};          // r.z, r.r of the new residual
      CN_EACH(
        X = X + alpha * p[e.s];
        const T rc = R - alpha * HP;
        R = rc;
        Z = K.minv(op, e) * rc;
        a2[0] = a2[0] + rc * Z;
        a2[1] = a2[1] + rc * rc;
        if (tm.nb > 1) send_edge(e, rc, ex_b);
      )
      team_sum<T, 2>(tm, a2, slot + 4 * 32, ex_b, halo_bytes);
      const T beta = a2[0] / (rz > tiny ? rz : tiny);
      rz = a2[0];
      rr = a2[1];
      ++k;
      CN_EACH(p[e.s] = (CPT > 0 ? Z : K.minv(op, e) * R) + beta * p[e.s];)
      CN_EACH_HALO(p[s] = op.m_inv[c] * halo_r[side * np_ + j]
                          + beta * p[s];)
      __syncthreads();
    }
    if (tid == 0 && tm.rank == 0) iters[step] = k;
    if (save_every > 0 && (step + 1) % save_every == 0) {
      T* out = snaps + static_cast<long long>((step + 1) / save_every - 1)
                           * n_a * np_;
      CN_EACH(out[e.c] = X;)
    }
  }
  if constexpr (CPT > 0) {
    CN_EACH(gx[e.c] = X;)
  }
  if (tm.nb > 1) cluster_barrier();
}

#undef CN_EACH
#undef CN_EACH_HALO

// The synchronisation skeleton of one CG iteration of the kernel above,
// `n` times: the block barrier after the stencil's first pass, the two
// reductions (team_sum, the second with the edge rows of r: 64 values to
// each neighbour), alpha's and beta's divides, the halo rows' update, the
// block barrier after p, the stop test; no stencil. Its time an iteration
// is the loop's latency floor at this cluster size and block width.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cn_pcg_2d_floor_kernel(int n, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  Team tm;
  tm.nb = gridDim.x;
  tm.rank = blockIdx.x;
  tm.nw = nt >> 5;
  tm.lane = threadIdx.x & 31;
  tm.warp = threadIdx.x >> 5;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  T* slot = reinterpret_cast<T*>(bars + 4);
  T* part = slot + 6 * 32;
  T* halo_r = part + 6 * 16;
  const int tid = threadIdx.x;
  const bool up = tm.rank > 0, down = tm.rank < tm.nb - 1;
  const unsigned halo_bytes = ((up ? 64 : 0) + (down ? 64 : 0)) * sizeof(T);
  Exchange<T> ex_a{bars + 1, part + 3 * 16, 0}, ex_b{bars + 2, part + 4 * 16,
                                                     0};
  if (tm.nb > 1) {
    if (tid < 3) mbar_init(bars + tid);
    cluster_barrier();
  }
  const T tiny = tiny_of<T>(), scale = T(1) / T(nt * tm.nb);
  T rz = T(1), rr = T(1), p = T(1);
  int k = 0;
  const T eps = T(0);
  while (sqrt(rr) > eps && k < n) {
    __syncthreads();
    T a1[1] = {rz * scale * p};
    team_sum<T, 1>(tm, a1, slot + 3 * 32, ex_a, 0);
    const T alpha = rz / (a1[0] > tiny ? a1[0] : tiny);
    T a2[2] = {alpha * rz * scale, alpha * rr * scale};
    if (tm.nb > 1 && tid < 64) {
      if (up) push(halo_r + 64 + tid, tm.rank - 1, alpha, ex_b.bar);
      if (down) push(halo_r + tid, tm.rank + 1, alpha, ex_b.bar);
    }
    team_sum<T, 2>(tm, a2, slot + 4 * 32, ex_b, tm.nb > 1 ? halo_bytes : 0);
    const T beta = a2[0] / (rz > tiny ? rz : tiny);
    rz = a2[0];
    rr = a2[1];
    ++k;
    p = beta * p;
    if (tm.nb > 1 && tid < 64 && (up || down))
      p = p + T(1e-30) * halo_r[(up ? 0 : 64) + tid];
    __syncthreads();
  }
  if (tm.nb > 1) cluster_barrier();
  if (tid == 0 && tm.rank == 0) out[0] = rz + p;
}

// the instances, by the cells a thread holds in registers with their
// coefficients; CPT 0 keeps the state in global memory, reads the
// coefficients where it uses them and takes any number of cells a thread
template <typename T>
struct Instance {
  void (*kernel)(Op<T>, T*, T*, T*, T*, int*, int, int, T, T, int);
  int cpt;
};

template <typename T>
const Instance<T>* instances(int* count) {
  static const Instance<T> table[] = {
      {cn_pcg_2d_kernel<T, 0>, 0},
      {cn_pcg_2d_kernel<T, 1>, 1},
      {cn_pcg_2d_kernel<T, 2>, 2},
  };
  *count = static_cast<int>(sizeof(table) / sizeof(table[0]));
  return table;
}

// dynamic shared memory of a block: four mbarrier words, the reductions'
// 6 x 32 warp sums and 6 x 16 block sums, p and w over the largest band
// and its two halo rows, v over the band, the halo rows' r
size_t smem_bytes(int n_a, int n_p, int nb, size_t itemsize) {
  const long long rows = n_a / nb + (n_a % nb ? 1 : 0);
  return 32 + static_cast<size_t>(6 * 32 + 6 * 16 + (3 * rows + 6) * n_p)
                  * itemsize;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// The configuration of one cluster of nb blocks of nt threads (cfg and
// its attribute, which the caller keeps), after setting the kernel's
// shared memory and, beyond 8 blocks, the non-portable cluster size;
// returns the CUDA error.
template <typename K>
cudaError_t configure(K kernel, int nb, int nt, size_t smem,
                      cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && nb > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3(nb, 1, 1);
  cfg.blockDim = dim3(nt, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nb;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

// launch as one cluster (nb > 1) or one plain block; returns the CUDA error
template <typename K, typename... A>
int launch_on(K kernel, int nb, int nt, size_t smem, cudaStream_t stream,
              A... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, nb, nt, smem, stream, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.numAttrs = nb > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters of a layout into *out
template <typename T>
int max_clusters(int variant, int nb, int nt, int n_a, int n_p, int* out) {
  int count = 0;
  const Instance<T>* table = instances<T>(&count);
  if (variant < 0 || variant >= count)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(table[variant].kernel, nb, nt,
                              smem_bytes(n_a, n_p, nb, sizeof(T)), nullptr,
                              cfg, attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, table[variant].kernel, &cfg);
  return static_cast<int>(err);
}

template <typename T>
int launch(int variant, int nb, int nt, const void* const* coef, int n_a,
           int n_p, double inv_da, double qa, void* x, void* work,
           void* snaps, int* iters, int n_steps, int save_every,
           double half, double tol, int maxiter, void* stream) {
  int count = 0;
  const Instance<T>* table = instances<T>(&count);
  if (variant < 0 || variant >= count || !pow2(nb) || nb > 16
      || !pow2(nt) || nt < 32 || nt > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = (n_a / nb + (n_a % nb ? 1 : 0)) * n_p;
  if (table[variant].cpt > 0
      && static_cast<long long>(table[variant].cpt) * nt < cells)
    return static_cast<int>(cudaErrorInvalidValue);
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
  T* wk = static_cast<T*>(work);
  return launch_on(table[variant].kernel, nb, nt,
                   smem_bytes(n_a, n_p, nb, sizeof(T)),
                   static_cast<cudaStream_t>(stream), op,
                   static_cast<T*>(x), wk, wk + n, static_cast<T*>(snaps),
                   iters, n_steps, save_every, static_cast<T>(half),
                   static_cast<T>(tol), maxiter);
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 float64; variant: the instance (cn_pcg_2d_variants);
// nb blocks in one cluster (a power of two, at most 16), nt threads a
// block (a power of two, 32 to 512). coef: the device
// pointers of ka, kp, qp, inv_dpc, r_x, k_lc, mass, m_inv (contiguous, in
// the dtype); inv_da and qa = 1/(4 da) as doubles. x: (n_a, n_p), f0 on
// entry, f_end on return; work: 2 n_a n_p scratch; snaps: (n_steps /
// save_every, n_a, n_p) or unused; iters: (n_steps,) int32. Returns the
// CUDA error code of the launch (0 = launched; cudaErrorInvalidValue for
// a layout the instance does not take).
int cn_pcg_2d_launch(int dtype, int variant, int nb, int nt, int n_a,
                     int n_p, double inv_da, double qa,
                     const void* const* coef, void* x, void* work,
                     void* snaps, int* iters, int n_steps, int save_every,
                     double half, double tol, int maxiter, void* stream) {
  if (dtype == 0)
    return launch<float>(variant, nb, nt, coef, n_a, n_p, inv_da, qa, x,
                         work, snaps, iters, n_steps, save_every, half, tol,
                         maxiter, stream);
  return launch<double>(variant, nb, nt, coef, n_a, n_p, inv_da, qa, x,
                        work, snaps, iters, n_steps, save_every, half, tol,
                        maxiter, stream);
}

// the instances' cells a thread into out (count ints, count at most
// max); returns count
int cn_pcg_2d_variants(int* out, int max) {
  int count = 0;
  const Instance<float>* table = instances<float>(&count);
  for (int k = 0; k < count && k < max; ++k) out[k] = table[k].cpt;
  return count;
}

// the skeleton of n iterations on nb blocks of nt threads; out: one value
// of the dtype. Returns the CUDA error code of the launch.
int cn_pcg_2d_floor_launch(int dtype, int nb, int nt, int n, void* out,
                           void* stream) {
  if (!pow2(nb) || nb > 16 || !pow2(nt) || nt < 32 || nt > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_on(cn_pcg_2d_floor_kernel<float>, nb, nt,
                     32 + (6 * 32 + 6 * 16 + 128) * sizeof(float), s, n,
                     static_cast<float*>(out));
  return launch_on(cn_pcg_2d_floor_kernel<double>, nb, nt,
                   32 + (6 * 32 + 6 * 16 + 128) * sizeof(double), s, n,
                   static_cast<double*>(out));
}

// the most blocks of this layout's cluster that can run at once
// (cudaOccupancyMaxActiveClusters): 0 means the cluster cannot be
// scheduled. Returns the CUDA error code.
int cn_pcg_2d_max_clusters(int dtype, int variant, int nb, int nt, int n_a,
                           int n_p, int* out) {
  if (dtype == 0) return max_clusters<float>(variant, nb, nt, n_a, n_p, out);
  return max_clusters<double>(variant, nb, nt, n_a, n_p, out);
}

}  // extern "C"
