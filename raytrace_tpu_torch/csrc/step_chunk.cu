// Hopper step kernel of the whistler ray tracer.
//
// Replaces raytrace_tpu/ops/pallas_stepper.py::_chunk_kernel (the Pallas
// TPU kernel built by make_pallas_chunk, pallas_call at :107): n_steps
// attempted steps of raytrace_tpu/integrate/solve.py::_step_one over a
// batch of rays of the 2D latitude frame, with the right-hand side
// ops/rhs.py::rhs_2d_lat over ops/fused.py::mu_and_grads_2d_lat and the
// make_env_lat medium (centered dipole, one ionosphere fit, CA1992 with
// hard branches, optional diffusive-equilibrium factor), protons only.
// Template instances: float and double x bs3 and dopri5.
//
// Design for the card, not block by block:
//   - one thread per ray; the thread loads its ray's 14-field carry into
//     registers, runs up to n_steps attempts and writes the carry back IN
//     PLACE (the buffers are aliased in -> out, as the Pallas kernel's
//     input_output_aliases were);
//   - a thread leaves its loop as soon as its ray is no longer ACTIVE:
//     exact, because _step_one is a no-op on a ray that is not ACTIVE;
//   - field-major layout: vectors are (4, B), per-ray scalars (B,), so
//     neighbouring threads read neighbouring addresses (the Pallas
//     kernel's (n, B) layout, kept here for coalescing);
//   - every scalar of the medium, SolverConfig, StopSpec and the root is a
//     kernel argument passed by value (Pallas closed over them as
//     compile-time constants), so one build serves every medium.
//
// What bounds it: not bytes. A ray's carry is 144 bytes (float) read and
// written once per launch, while one attempt is three (bs3) or six
// (dopri5) evaluations of the fused right-hand side: about 15 dependent
// transcendentals (sin, cos, exp, log, sqrt, rsqrt) and 20 divisions each.
// Each thread is one long dependent chain, so the kernel is bound by the
// latency of that chain, and a 10,240-ray batch fills only part of the
// 132 SMs (80 blocks of 128 threads). What the design does about it:
// nothing leaves registers between attempts, the whole chain is inlined
// so the compiler can interleave independent sub-chains (the Stix terms,
// the four state components), and a finished ray costs its warp nothing
// but the loop exit. More rays per SM
// or splitting rays across threads is later work.
//
// Numerics: built WITHOUT --use_fast_math, so isfinite, the inf defaults
// of StopSpec.r_ceil/t_max/group_time_max, IEEE division and square root,
// and the order of the compensated two-sum update are kept. The kernel
// rounds as its plain PyTorch version does on the card, operation for
// operation: FMA contraction is OFF (-fmad=false, ops/step_chunk.py),
// quotients by constants are reciprocal products (recip below), and the
// error norm sums its components in order (integrate/steppers.py). The
// two then agree bit for bit (every field, float and double, both
// steppers, 256 steps of 1,024 ensemble10k rays, measured on an H100).
// That matters because the embedded error estimate cancels its stage
// terms to ~1e-9 of their size and so amplifies last-ulp differences into
// dt: with contraction on, 11 of those 1,024 float64 bs3 rays took a
// different accept/reject path within 256 steps. Contraction saved ~3% of
// the kernel's time (10,240 rays x 512 steps). min/max propagate NaN, as
// XLA's and torch's do, and sign(0) = 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// physical constants in double, in the expression order of constants.py;
// the kernel casts each to T as JAX casts the Python-float constants
constexpr double kPi = 3.141592653589793;
constexpr double kCLight = 2.99792458e8;
constexpr double kRE = 6.3712e6;
constexpr double kQE = 1.602e-19;
constexpr double kME = 9.1093e-31;
constexpr double kMP = 1.6726219e-27;
constexpr double kEps0 = 8.854e-12;
constexpr double kFPE2_E = kQE * kQE * 1.0e6 / (kEps0 * kME * 4.0 * kPi * kPi);
constexpr double kFPE2_P = kQE * kQE * 1.0e6 / (kEps0 * kMP * 4.0 * kPi * kPi);
constexpr double kFCE_E = kQE / (kME * 2.0 * kPi);
constexpr double kFCE_P = kQE / (kMP * 2.0 * kPi);
constexpr double kREOverC = kRE / kCLight;
constexpr double kLN10 = 2.302585092994046;
constexpr double kDeRbase = 7.37e6;
constexpr double kDeS =
    1.506 * 2500.0 * ((kDeRbase / 7370.0) * (kDeRbase / 7370.0));

// status codes (integrate/events.py)
constexpr int ACTIVE = 0;
constexpr int HIT_EARTH = 1;
constexpr int MAX_PHASE_TIME = 2;
constexpr int MAX_GROUP_TIME = 3;
constexpr int HIT_EQUATOR = 4;
constexpr int ESCAPED = 5;
constexpr int INVALID = 6;
constexpr int DT_UNDERFLOW = 7;
constexpr int EVANESCENT = 9;

constexpr int BS3 = 0;
constexpr int DOPRI5 = 1;
constexpr int kThreads = 128;

}  // namespace

// host-side scalars, all double (mirror of ops/step_chunk.py::StepParams)
struct StepParams {
  double b0, iono_n0, iono_decay, iono_r0, lppi, lppo, ne_lppi, ps_season,
      ps_trough, ps_weight, de_weight, root;
  double rtol, atol, dt_min, dt_max, safety, pi_alpha, pi_beta, fac_min,
      fac_max, accept_tol, stall_dt_factor, stall_count;
  double r_floor, r_ceil, t_max, group_time_max, stop_at_equator, lat_sign,
      lat_offset, stop_retrograde;
};

namespace {

// kernel-side scalars in T; products of Python floats that the JAX package
// forms before touching an array (dt_min * 2.0, ...) are formed in double
template <typename T>
struct KParams {
  T b0, iono_n0, iono_decay, iono_r0, lppi, lppo, ne_lppi, ps_season,
      ps_trough, root;
  bool ps_on, de_on;
  T rtol, atol, dt_min, dt_max, dt_min2, dt_min_uf, tiny_thr, safety,
      neg_pi_alpha, pi_beta, fac_min, fac_max, accept_tol, order, scale5;
  bool tiny_on;
  double stall_count;
  T r_floor, r_ceil, t_max, group_time_max, lat_sign, lat_offset;
  bool equator_on, retro_on;
};

template <typename T>
KParams<T> make_params(const StepParams& h, int stepper) {
  KParams<T> p;
  p.b0 = T(h.b0);
  p.iono_n0 = T(h.iono_n0);
  p.iono_decay = T(h.iono_decay);
  p.iono_r0 = T(h.iono_r0);
  p.lppi = T(h.lppi);
  p.lppo = T(h.lppo);
  p.ne_lppi = T(h.ne_lppi);
  p.ps_season = T(h.ps_season);
  p.ps_trough = T(h.ps_trough);
  p.root = T(h.root);
  p.ps_on = h.ps_weight != 0.0;
  p.de_on = h.de_weight != 0.0;
  const double order = stepper == BS3 ? 3.0 : 5.0;
  p.rtol = T(h.rtol);
  p.atol = T(h.atol);
  p.dt_min = T(h.dt_min);
  p.dt_max = T(h.dt_max);
  p.dt_min2 = T(h.dt_min * 2.0);
  p.dt_min_uf = T(h.dt_min * (1.0 + 1.0e-6));
  p.tiny_thr = T(h.dt_min * h.stall_dt_factor);
  p.tiny_on = h.stall_dt_factor > 0.0;
  p.stall_count = h.stall_count;
  p.safety = T(h.safety);
  p.neg_pi_alpha = T(-h.pi_alpha);
  p.pi_beta = T(h.pi_beta);
  p.fac_min = T(h.fac_min);
  p.fac_max = T(h.fac_max);
  p.accept_tol = T(h.accept_tol);
  p.order = T(order);
  p.scale5 = T(5.0 / order);
  p.r_floor = T(h.r_floor);
  p.r_ceil = T(h.r_ceil);
  p.t_max = T(h.t_max);
  p.group_time_max = T(h.group_time_max);
  p.lat_sign = T(h.lat_sign);
  p.lat_offset = T(h.lat_offset);
  p.equator_on = h.stop_at_equator > 0.5;
  p.retro_on = h.stop_retrograde > 0.5;
  return p;
}

__device__ __forceinline__ float d_sin(float x) { return sinf(x); }
__device__ __forceinline__ double d_sin(double x) { return sin(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double d_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }

// A Python-scalar division in the plain PyTorch version (x / 1.5,
// 7.37e6 / x) runs on the card as a multiplication by the reciprocal,
// formed in T; the kernel forms those quotients the same way, so the two
// round alike (the JAX package divides; the quotients differ by at most
// an ulp).
template <typename T>
__device__ __forceinline__ T recip(T x) {
  return T(1) / x;
}

// NaN-propagating min/max (jnp.minimum/maximum, torch.minimum/maximum)
template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
// sign with sign(0) = 0 and sign(NaN) = NaN (jnp.sign)
template <typename T>
__device__ __forceinline__ T jsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// ops/fused.py::_ne_and_grads + _compose_ne (axisymmetric CA1992 with hard
// branches): total density (m^-3) and its (r, lat) partials
template <typename T>
__device__ __forceinline__ void ne_and_grads(T r, T sl, T cl,
                                             const KParams<T>& p, T& ne,
                                             T& ne_r, T& ne_lat) {
  const T ni = p.iono_n0 * d_exp(-p.iono_decay * (r - p.iono_r0));
  const T ni_r = -p.iono_decay * ni;
  if (!p.ps_on) {
    ne = T(1.0e6) * ni;
    ne_r = T(1.0e6) * ni_r;
    ne_lat = T(0);
    return;
  }
  const T inv_cl = T(1) / cl;
  const T inv_cl2 = inv_cl * inv_cl;
  const T L = r * inv_cl2;
  const T L_r = inv_cl2;
  const T L_lat = T(2) * L * sl * inv_cl;

  const T e1 = d_exp((T(2) - L) * recip(T(1.5)));
  const T g1 = (T(-0.3145) * L + T(3.9043)) + p.ps_season * e1;
  const T ne1 = d_exp(T(kLN10) * g1);
  const T dne1 =
      T(kLN10) * ne1 * (T(-0.3145) - p.ps_season * e1 * recip(T(1.5)));
  const T ne2 = p.ne_lppi * d_exp(T(kLN10) * (p.lppi - L) * recip(T(0.1)));
  const T dne2 = T(-(kLN10 / 0.1)) * ne2;
  const T Ls = jmax(L, T(1.0e-6));
  // L^-4.5 as (1/L)^4 * rsqrt(L) (fused.py:137-142)
  const T inv_Ls = T(1) / Ls;
  const T inv_Ls2 = inv_Ls * inv_Ls;
  const T f45 = (inv_Ls2 * inv_Ls2) * d_rsqrt(Ls);
  const T p3 = p.ps_trough * f45;
  const T e3 = d_exp((T(2) - L) * T(0.1));
  const T ne3 = p3 + (T(1) - e3);
  const T dne3 = T(-4.5) * p3 * inv_Ls + e3 * T(0.1);
  // hard branches with <= (fused.py:230-233); ne2 may underflow to 0
  const bool in1 = L <= p.lppi;
  const bool in2 = L <= p.lppo;
  const T ne_p = in1 ? ne1 : (in2 ? ne2 : ne3);
  const T dne_p = in1 ? dne1 : (in2 ? dne2 : dne3);

  T de = T(1), de_r = T(0);
  if (p.de_on) {
    const T G = T(kDeRbase) * (T(1) - recip(r * T(kRE)) * T(kDeRbase));
    de = d_sqrt(d_exp(-G * recip(T(kDeS))));
    de_r = -de * T(kDeRbase) * T(kDeRbase) /
           (T(2.0 * kDeS) * r * r * T(kRE));
  }
  ne = T(1.0e6) * (ni + ne_p * de);
  ne_r = T(1.0e6) * (ni_r + (dne_p * L_r * de + ne_p * de_r));
  ne_lat = (T(1.0e6) * de) * (dne_p * L_lat);
}

// ops/fused.py::_stix_quartic_grads (protons only, psi form): mu and its
// partials w.r.t. (ne, |B|, f, psi)
template <typename T>
__device__ __forceinline__ void stix_quartic_grads(T ne, T bm, T f, T sinpsi,
                                                   T cospsi, T root, T& mu,
                                                   T& dmu_dn, T& dmu_db,
                                                   T& dmu_df, T& dmu_dpsi) {
  const T inv_f = T(1) / f;
  const T ncm = ne * T(1.0e-6);
  const T xe = T(kFPE2_E) * ncm * inv_f * inv_f;
  const T ye = T(kFCE_E) * bm * inv_f;
  const T inv_de = T(1) / (T(1) - ye * ye);
  const T ae = (T(1) + ye) * inv_de;
  const T be = (T(1) - ye) * inv_de;
  const T xi = T(kFPE2_P) * ncm * inv_f * inv_f;
  const T yi = T(kFCE_P) * bm * inv_f;
  const T inv_di = T(1) / (T(1) - yi * yi);
  const T ai = (T(1) - yi) * inv_di;
  const T bi = (T(1) + yi) * inv_di;
  const T Sa = xi * ai;
  const T Sb = xi * bi;
  const T Say = xi * ai * ai * yi;
  const T Sby = xi * bi * bi * yi;
  const T Sx = xi;
  const T R = T(1) - xe * ae - Sa;
  const T L = T(1) - xe * be - Sb;
  const T P = T(1) - xe - Sx;
  const T inv_ne = T(1) / ne;
  const T R_n = -(xe * ae + Sa) * inv_ne;
  const T L_n = -(xe * be + Sb) * inv_ne;
  const T P_n = -(xe + Sx) * inv_ne;
  const T inv_bm = T(1) / bm;
  const T R_b = (-xe * ae * ae * ye + Say) * inv_bm;
  const T L_b = (xe * be * be * ye - Sby) * inv_bm;
  const T R_f = (T(2) * (xe * ae + Sa) + (xe * ae * ae * ye - Say)) * inv_f;
  const T L_f = (T(2) * (xe * be + Sb) + (-xe * be * be * ye + Sby)) * inv_f;
  const T P_f = T(2) * (xe + Sx) * inv_f;

  const T s = jmax(jmax(d_abs(R), d_abs(L)), d_abs(P));
  const T inv_s = T(1) / s;
  const T Rn = R * inv_s, Ln = L * inv_s, Pn = P * inv_s;

  const T sin2 = sinpsi * sinpsi;
  const T cos2 = cospsi * cospsi;
  const T sin4 = sin2 * sin2;
  const T Sn = T(0.5) * (Rn + Ln);
  const T A = Sn * sin2 + Pn * cos2;
  const T RL = Rn * Ln;
  const T PS = Pn * Sn;
  const T B = RL * sin2 + PS * (T(1) + cos2);
  const T C = Pn * RL;
  const T G = RL - PS;
  const T H = Pn * (Rn - Ln);
  const T F2 = G * G * sin4 + H * H * cos2;
  const T F = d_sqrt(F2);
  const T inv_F = T(1) / F;

  const T halfP = T(0.5) * Pn;
  const T geo = sinpsi * cospsi;
  const T A_R = T(0.5) * sin2;
  const T A_L = T(0.5) * sin2;
  const T A_P = cos2;
  const T A_psi = (Sn - Pn) * T(2) * geo;
  const T onepcos2 = T(1) + cos2;
  const T B_R = Ln * sin2 + halfP * onepcos2;
  const T B_L = Rn * sin2 + halfP * onepcos2;
  const T B_P = Sn * onepcos2;
  const T B_psi = T(2) * G * geo;
  const T C_R = Pn * Ln;
  const T C_L = Pn * Rn;
  const T C_P = RL;
  const T F_R = (G * (Ln - halfP) * sin4 + H * Pn * cos2) * inv_F;
  const T F_L = (G * (Rn - halfP) * sin4 - H * Pn * cos2) * inv_F;
  const T F_P = (-G * Sn * sin4 + H * (Rn - Ln) * cos2) * inv_F;
  const T F_psi = geo * (T(2) * G * G * sin2 - H * H) * inv_F;

  // stable root: direct (B + root F)/2A where root*B >= 0, else the
  // product form 2C/(B - root F); both branches evaluated (fused.py:409)
  const T inv_2A = T(0.5) / A;
  const T inv_A = inv_2A + inv_2A;
  const T num_dir = B + root * F;
  const T mu2n_dir = num_dir * inv_2A;
  const T den_pro = B - root * F;
  const T inv_den = T(1) / den_pro;
  const T mu2n_pro = T(2) * C * inv_den;
  const bool use_dir = root * B >= T(0);
  const T mu2n = use_dir ? mu2n_dir : mu2n_pro;

#define MU2N_Q(Bq, Fq, Aq, Cq)                                          \
  (use_dir ? ((Bq) + root * (Fq)) * inv_2A - mu2n_dir * (Aq) * inv_A   \
           : (T(2) * (Cq) - mu2n_pro * ((Bq) - root * (Fq))) * inv_den)
  const T m_R = MU2N_Q(B_R, F_R, A_R, C_R);
  const T m_L = MU2N_Q(B_L, F_L, A_L, C_L);
  const T m_P = MU2N_Q(B_P, F_P, A_P, C_P);
  const T m_psi = MU2N_Q(B_psi, F_psi, A_psi, T(0));
#undef MU2N_Q

  // the traced root has mu^2 < 0 at these configs: mu = sqrt(|mu^2|)
  const T mu2 = s * mu2n;
  mu = d_sqrt(d_abs(mu2));
  const T gscale = jsign(mu2n) / (T(2) * mu);
  dmu_dn = gscale * (m_R * R_n + m_L * L_n + m_P * P_n);
  dmu_db = gscale * (m_R * R_b + m_L * L_b);
  dmu_df = gscale * (m_R * R_f + m_L * L_f + m_P * P_f);
  dmu_dpsi = gscale * s * m_psi;
}

// ops/rhs.py::rhs_2d_lat over ops/fused.py::mu_and_grads_2d_lat
template <typename T>
__device__ __forceinline__ void rhs_2d_lat(const T u[4], T f,
                                           const KParams<T>& p, T out[4]) {
  const T r = u[0], lat = u[1], chi = u[2];
  const T sl = d_sin(lat), cl = d_cos(lat);
  const T q2 = T(1) + T(3) * sl * sl;
  const T q = d_sqrt(q2);
  const T inv_r = T(1) / r;
  const T inv_r3 = inv_r * inv_r * inv_r;
  const T inv_q = T(1) / q;
  const T inv_q2 = inv_q * inv_q;
  const T bm = p.b0 * q * inv_r3;
  const T bm_r = T(-3) * bm * inv_r;
  const T bm_lat = T(3) * sl * cl * bm * inv_q2;
  const T sindip = T(2) * sl * inv_q;
  const T cosdip = cl * inv_q;
  const T sc = d_sin(chi), cc = d_cos(chi);
  const T sinpsi = cosdip * cc - sindip * sc;
  const T cospsi = -(sindip * cc + cosdip * sc);
  const T dpsi_dlat = T(2) * inv_q2;

  T ne, ne_r, ne_lat;
  ne_and_grads(r, sl, cl, p, ne, ne_r, ne_lat);
  T mu, dmu_dn, dmu_db, dmu_df, dmu_dpsi;
  stix_quartic_grads(ne, bm, f, sinpsi, cospsi, p.root, mu, dmu_dn, dmu_db,
                     dmu_df, dmu_dpsi);
  const T dmudr = dmu_dn * ne_r + dmu_db * bm_r;
  const T dmudlat = dmu_dn * ne_lat + dmu_db * bm_lat + dmu_dpsi * dpsi_dlat;

  const T inv_mu2 = T(1) / (mu * mu);
  const T inv_mu2_r = inv_mu2 * inv_r;
  out[0] = inv_mu2 * (mu * cc + dmu_dpsi * sc);
  out[1] = inv_mu2_r * (mu * sc - dmu_dpsi * cc);
  out[2] = inv_mu2_r * (dmudlat * cc - (r * dmudr + mu) * sc);
  out[3] = T(kREOverC) * (T(1) + (f * mu * inv_mu2) * dmu_df);
}

template <typename T>
__device__ __forceinline__ T err_norm(const T ev[4], const T u[4],
                                      const T u_new[4], const KParams<T>& p) {
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T scale = p.atol + p.rtol * jmax(d_abs(u[j]), d_abs(u_new[j]));
    const T x = ev[j] / scale;
    acc = j == 0 ? x * x : acc + x * x;
  }
  return d_sqrt(acc / T(4));
}

// integrate/steppers.py::bs3_step (Bogacki-Shampine 3(2), FSAL)
template <typename T>
__device__ __forceinline__ T bs3_step(const T u[4], const T k1[4], T h, T f,
                                      const KParams<T>& p, T u_new[4],
                                      T k_end[4], T incr[4]) {
  T y[4], k2[4], k3[4], ev[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = u[j] + (T(0.5) * h) * k1[j];
  rhs_2d_lat(y, f, p, k2);
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = u[j] + (T(0.75) * h) * k2[j];
  rhs_2d_lat(y, f, p, k3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    incr[j] = h * (T(2.0 / 9.0) * k1[j] + T(1.0 / 3.0) * k2[j] +
                   T(4.0 / 9.0) * k3[j]);
    u_new[j] = u[j] + incr[j];
  }
  rhs_2d_lat(u_new, f, p, k_end);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ev[j] = h * (T(2.0 / 9.0 - 7.0 / 24.0) * k1[j] +
                 T(1.0 / 3.0 - 0.25) * k2[j] +
                 T(4.0 / 9.0 - 1.0 / 3.0) * k3[j] - T(0.125) * k_end[j]);
  return err_norm(ev, u, u_new, p);
}

// integrate/steppers.py::dopri5_step (Dormand-Prince 5(4), FSAL); the
// zero tableau entries stay in the sums, as they do in the JAX package
template <typename T>
__device__ __forceinline__ T dopri5_step(const T u[4], const T k1[4], T h,
                                         T f, const KParams<T>& p,
                                         T u_new[4], T k_end[4], T incr[4]) {
  T y[4], k2[4], k3[4], k4[4], k5[4], k6[4], ev[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = u[j] + h * (T(0.2) * k1[j]);
  rhs_2d_lat(y, f, p, k2);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = u[j] + h * (T(3.0 / 40.0) * k1[j] + T(9.0 / 40.0) * k2[j]);
  rhs_2d_lat(y, f, p, k3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = u[j] + h * (T(44.0 / 45.0) * k1[j] + T(-56.0 / 15.0) * k2[j] +
                       T(32.0 / 9.0) * k3[j]);
  rhs_2d_lat(y, f, p, k4);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = u[j] + h * (T(19372.0 / 6561.0) * k1[j] +
                       T(-25360.0 / 2187.0) * k2[j] +
                       T(64448.0 / 6561.0) * k3[j] +
                       T(-212.0 / 729.0) * k4[j]);
  rhs_2d_lat(y, f, p, k5);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = u[j] + h * (T(9017.0 / 3168.0) * k1[j] +
                       T(-355.0 / 33.0) * k2[j] +
                       T(46732.0 / 5247.0) * k3[j] +
                       T(49.0 / 176.0) * k4[j] +
                       T(-5103.0 / 18656.0) * k5[j]);
  rhs_2d_lat(y, f, p, k6);
  // the 7th stage is evaluated at u + h * (b5 . k) == u_new (FSAL)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    incr[j] = h * (T(35.0 / 384.0) * k1[j] + T(0.0) * k2[j] +
                   T(500.0 / 1113.0) * k3[j] + T(125.0 / 192.0) * k4[j] +
                   T(-2187.0 / 6784.0) * k5[j] + T(11.0 / 84.0) * k6[j]);
    u_new[j] = u[j] + incr[j];
  }
  rhs_2d_lat(u_new, f, p, k_end);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ev[j] = h * (T(35.0 / 384.0 - 5179.0 / 57600.0) * k1[j] +
                 T(0.0 - 0.0) * k2[j] +
                 T(500.0 / 1113.0 - 7571.0 / 16695.0) * k3[j] +
                 T(125.0 / 192.0 - 393.0 / 640.0) * k4[j] +
                 T(-2187.0 / 6784.0 - -92097.0 / 339200.0) * k5[j] +
                 T(11.0 / 84.0 - 187.0 / 2100.0) * k6[j] +
                 T(0.0 - 1.0 / 40.0) * k_end[j]);
  return err_norm(ev, u, u_new, p);
}

// integrate/events.py::classify_step, with its priority order
template <typename T>
__device__ __forceinline__ int classify_step(const T u0[4], const T u1[4],
                                             T t1, const KParams<T>& p) {
  const bool surface = u1[0] <= p.r_floor;
  const T lat0 = p.lat_sign * u0[1] + p.lat_offset;
  const T lat1 = p.lat_sign * u1[1] + p.lat_offset;
  const bool equator = p.equator_on && (jsign(lat1) != jsign(lat0));
  const bool escaped = u1[0] >= p.r_ceil;
  const bool group = u1[3] >= p.group_time_max;
  const bool phase = t1 >= p.t_max;
  const bool invalid = !(isfinite(u1[0]) && isfinite(u1[1]) &&
                         isfinite(u1[2]) && isfinite(u1[3]));
  const bool retro = p.retro_on && (u1[3] < T(0));
  int st = phase ? MAX_PHASE_TIME : ACTIVE;
  if (retro) st = EVANESCENT;
  if (group) st = MAX_GROUP_TIME;
  if (escaped) st = ESCAPED;
  if (equator) st = HIT_EQUATOR;
  if (surface) st = HIT_EARTH;
  if (invalid) st = INVALID;
  return st;
}

template <typename T, int STEPPER>
__global__ void __launch_bounds__(kThreads)
    step_chunk_kernel(T* __restrict__ u_g, T* __restrict__ k1_g,
                      T* __restrict__ u_prev_g, T* __restrict__ u_lo_g,
                      T* __restrict__ t_g, T* __restrict__ dt_g,
                      T* __restrict__ errold_g, T* __restrict__ dt_prev_g,
                      int* __restrict__ status_g, int* __restrict__ n_acc_g,
                      int* __restrict__ n_rej_g, int* __restrict__ rejected_g,
                      int* __restrict__ n_tiny_g, int* __restrict__ caution_g,
                      const T* __restrict__ f_g, long long B, int n_steps,
                      KParams<T> p) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= B) return;
  int status = status_g[i];
  // a ray that is not ACTIVE stays as it is (_step_one is a no-op there)
  if (status != ACTIVE || n_steps <= 0) return;

  T u[4], k1[4], u_prev[4], u_lo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = u_g[j * B + i];
    k1[j] = k1_g[j * B + i];
    u_prev[j] = u_prev_g[j * B + i];
    u_lo[j] = u_lo_g[j * B + i];
  }
  T t = t_g[i], dt = dt_g[i], errold = errold_g[i], dt_prev = dt_prev_g[i];
  int n_acc = n_acc_g[i], n_rej = n_rej_g[i], rejected = rejected_g[i];
  int n_tiny = n_tiny_g[i], caution = caution_g[i];
  const T f = f_g[i];

  for (int s = 0; s < n_steps && status == ACTIVE; ++s) {
    // step ceiling, then no overshoot of the phase-path budget
    T dt_eff = jmin(dt, p.dt_max);
    dt_eff = jmin(dt_eff, jmax(p.t_max - t, p.dt_min));

    T u_new[4], k_end[4], incr[4];
    const T err_raw =
        STEPPER == BS3 ? bs3_step(u, k1, dt_eff, f, p, u_new, k_end, incr)
                       : dopri5_step(u, k1, dt_eff, f, p, u_new, k_end, incr);
    const bool accept = err_raw <= p.accept_tol;

    const T t1 = t + dt_eff;
    int status1 = classify_step(u, u_new, t1, p);
    if (status1 == ACTIVE && dt_eff <= p.dt_min2) status1 = DT_UNDERFLOW;
    const bool terminal = status1 == HIT_EARTH || status1 == HIT_EQUATOR;

    // PI controller; a non-finite error estimate is a hard rejection
    const T err = isfinite(err_raw) ? jmax(err_raw, T(1.0e-10)) : T(1.0e10);
    const T log_err = d_log(err);
    const T fac_cap =
        rejected > 0 ? T(1) : (caution > 8 ? T(1.3) : p.fac_max);
    const T fac_acc = jmin(
        jmax(p.safety * d_exp(p.scale5 * (p.neg_pi_alpha * log_err +
                                          p.pi_beta * d_log(errold))),
             p.fac_min),
        fac_cap);
    const T fac_rej =
        jmin(jmax(p.safety * d_exp(-log_err * recip(p.order)), T(0.05)),
             T(1));
    const T dt_next =
        jmin(jmax(dt_eff * (accept ? fac_acc : fac_rej), p.dt_min), p.dt_max);
    const bool underflow = !accept && dt_eff <= p.dt_min_uf;

    int status_new = accept ? status1 : (underflow ? DT_UNDERFLOW : ACTIVE);
    // device-side wedge retirement (SolverConfig.stall_dt_factor)
    const bool tiny = p.tiny_on && dt_eff < p.tiny_thr;
    const int n_tiny_new = accept ? (tiny ? n_tiny + 1 : 0) : n_tiny;
    if (accept && double(n_tiny_new) >= p.stall_count &&
        status_new == ACTIVE)
      status_new = DT_UNDERFLOW;

    if (accept) {
      if (terminal) {  // snapshot the terminating step for refine_events
#pragma unroll
        for (int j = 0; j < 4; ++j) u_prev[j] = u[j];
        dt_prev = dt_eff;
      }
      // compensated state update (fast two-sum)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T d = incr[j] + u_lo[j];
        const T uc = u[j] + d;
        u_lo[j] = d - (uc - u[j]);
        u[j] = uc;
        k1[j] = k_end[j];
      }
      t = t1;
      errold = jmax(err, T(1.0e-4));
      n_acc += 1;
    } else {
      n_rej += 1;
    }
    dt = dt_next;
    status = status_new;
    rejected = accept ? 0 : 1;
    n_tiny = n_tiny_new;
    caution = min(max(caution + (accept ? -1 : 4), 0), 60);
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u_g[j * B + i] = u[j];
    k1_g[j * B + i] = k1[j];
    u_prev_g[j * B + i] = u_prev[j];
    u_lo_g[j * B + i] = u_lo[j];
  }
  t_g[i] = t;
  dt_g[i] = dt;
  errold_g[i] = errold;
  dt_prev_g[i] = dt_prev;
  status_g[i] = status;
  n_acc_g[i] = n_acc;
  n_rej_g[i] = n_rej;
  rejected_g[i] = rejected;
  n_tiny_g[i] = n_tiny;
  caution_g[i] = caution;
}

template <typename T, int STEPPER>
void launch(void** ptrs, long long B, int n_steps, const StepParams& h,
            cudaStream_t stream) {
  const long long blocks = (B + kThreads - 1) / kThreads;
  step_chunk_kernel<T, STEPPER><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (T*)ptrs[0], (T*)ptrs[1], (T*)ptrs[2], (T*)ptrs[3], (T*)ptrs[4],
      (T*)ptrs[5], (T*)ptrs[6], (T*)ptrs[7], (int*)ptrs[8], (int*)ptrs[9],
      (int*)ptrs[10], (int*)ptrs[11], (int*)ptrs[12], (int*)ptrs[13],
      (const T*)ptrs[14], B, n_steps, make_params<T>(h, STEPPER));
}

}  // namespace

// ptrs: u, k1, u_prev, u_lo (4, B); t, dt, errold, dt_prev (B,) of T;
// status, n_accept, n_reject, rejected, n_tiny, caution (B,) int32; f (B,).
// dtype 0 = float, 1 = double; stepper 0 = bs3, 1 = dopri5. Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int step_chunk_launch(int dtype, int stepper, void** ptrs,
                                 long long B, int n_steps,
                                 const StepParams* h, void* stream) {
  if (B <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || (stepper != BS3 && stepper != DOPRI5))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (stepper == BS3)
      launch<float, BS3>(ptrs, B, n_steps, *h, s);
    else
      launch<float, DOPRI5>(ptrs, B, n_steps, *h, s);
  } else {
    if (stepper == BS3)
      launch<double, BS3>(ptrs, B, n_steps, *h, s);
    else
      launch<double, DOPRI5>(ptrs, B, n_steps, *h, s);
  }
  return (int)cudaGetLastError();
}
