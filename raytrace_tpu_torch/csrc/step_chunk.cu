// Hopper step kernel of the whistler ray tracer.
//
// Replaces raytrace_tpu/ops/pallas_stepper.py::_chunk_kernel (the Pallas
// TPU kernel built by make_pallas_chunk, pallas_call at :107): n_steps
// attempted steps of raytrace_tpu/integrate/solve.py::_step_one over a
// batch of rays: bs3 or dopri5 under the step controller, with the
// arc-length step ceiling ds_max or the local arc ceiling
// (_local_arc_ceiling, solve.py:216-240, 283-317) when one is on, or with
// adaptive=False fixed-step rk4 (steppers.py:29-37: no ceiling, no
// controller, every step accepted). Three frames, each with its
// right-hand side inlined:
//   - the 2D latitude frame, 4-state carry (r, lat, chi, T), group delay
//     at index 3: ops/rhs.py::rhs_2d_lat over
//     ops/fused.py::mu_and_grads_2d_lat;
//   - the 2D colatitude frame, 4-state carry (r, theta, chi, T):
//     ops/rhs.py::rhs_2d_colat over the same chain at lat = pi/2 - theta,
//     formed in T as the JAX package forms it;
//   - the 3D Kimura frame, 7-state carry (r, theta, phi, rho_r,
//     rho_theta, rho_phi, T), group delay at index 6: ops/rhs.py::rhs_3d
//     over ops/fused.py::mu_and_grads_3d in the cos(psi) form (the psi
//     form divides a 0/0 back out at field-aligned propagation, which
//     float32 cannot resolve);
// over the centered dipole (FIELD = DIPOLE) or, in the 3D
// frame with the full medium, over a non-axial field (FIELD = TILTED, the
// tilted dipole; FIELD = IGRF, the degree-3 IGRF truncation): rhs_3d over
// ops/fused.py::mu_and_grads_3d_general, whose geometry (the field's three
// components, the magnetic latitude and longitude of the tilted frame)
// and its fifteen tangents d/dr, d/dtheta, d/dphi are the closed forms of
// models/dipole.py (tilted_field, igrf_field, magnetic_coords), a scalar
// per thread each, in front of the same density chain and Stix quartic.
// The field is a template value and not a runtime flag of the full chain:
// the full chain with every flag off already costs the axisymmetric
// launches 15% (bs3) to 100% (3D float dopri5) (PERF.md), so the dipole
// instances keep their code, their registers and their times. The tilt's
// sines and cosines (the moment unit vector and the two rotated axes of
// the magnetic longitude) are formed in double on the host by the
// functions the plain version uses (models/dipole.py::moment_unit,
// mlon_axes) and ride by value with the 15 IGRF coefficients. asin, atan2
// and sqrt are the card's own in both the kernel and the plain version
// (torch.asin and torch.atan2 on a CUDA tensor call the same functions).
// One of two media:
//   - the axisymmetric medium (MEDIUM = AXI: one ionosphere fit, CA1992
//     with hard branches, optional diffusive-equilibrium factor), the
//     code of the first two slices, kept as it was;
//   - the full density chain (MEDIUM = FULL: ops/fused.py::_ne_and_grads
//     + _compose_ne whole): the day/night ionosphere, CA1992 with hard or
//     sigmoid-smoothed plasmapause and the trough refill (per L with
//     ps_refill_q), the simplified GCPM, the field-aligned duct, the
//     diffusive-equilibrium factor, and in the 3D frame the MLT-resolved
//     plasmasphere (models/medium.py::mlt_ps_params, mlt_gcpm_params),
//     whose d ne/dphi feeds rhs_3d's dmu/dphi. Each feature is a runtime
//     flag of KParams, the same for every thread (no divergence). With
//     every flag off it performs the AXI chain's operations in the same
//     order (chip_smoke.py phase 8 holds the two bit for bit), but runs
//     the axisymmetric launches 17% (bs3) to 105% (3D float dopri5)
//     slower than AXI on an H100 (PERF.md), so AXI keeps its instances.
// The AXI and FULL instances keep the code of the first slices: protons
// only, and no local arc ceiling. A medium with He+ or O+
// (dispersion.ion_species) or a run with the local ceiling takes the EXT
// instances: the full chain (which with its flags off is the AXI chain, bit
// for bit) whose Stix sums run over a species count and coefficients,
// formed in double on the host, that ride by value (a species whose
// fraction is 0 is not formed: 0 * inf at y = 1 would be NaN), and whose
// step ceiling takes the local one (up to kMaxShells shells), both at run
// time. The species count at run time in every instance cost the
// protons-only launches 2-9% and the 3D float dopri5 one 30% (its register
// allocation fell to 128 with spills), and the local ceiling's code cost
// the 3D full float64 bs3 one 5-7% wherever it sat (PERF.md), hence the
// third medium value. The root (+1 whistler, -1 EMIC) rides by value.
// The reference scripts' modes (ops/gradients.py grad_mode="reference":
// the closed-form dmu/dpsi of ops/analytic.py, dmu/dr = 0, and in 3D the
// Kimura rho partials; ops/rhs.py legacy_freq_state: the 2D frequency read
// as f + T) take the fourth medium value, ALT: the axisymmetric medium with
// both modes as run-time flags, so that they cost the other instances
// nothing; over any other medium over the dipole, the fifth, ALTX: the
// extended chain (EXT: the full density chain, the Stix sums over the ion
// species, the local arc ceiling) with the same two flags. The closed form
// takes the density, |B| and field direction the fused chain has
// computed, as the plain version does, and sign(0) = 0 as torch.sign has
// it; in 3D over the MLT-resolved medium its density is the chain's at the
// base parameters (the JAX package reads it without longitude), a second
// evaluation of the chain.
// The autodiff gradient set (ops/gradients.py grad_mode="autodiff") takes
// the sixth medium value, AD: the value chain of ops/dispersion.py over
// the whole medium on dual numbers (forward mode, the tangents by torch's
// formulas; the section "the autodiff gradient set" below), in every frame
// and, in 3D, over every field.
// Every medium and step ceiling the JAX package takes runs here. The media
// above take what the JAX package's presets give: the plasmasphere and DE
// weights 0 and 1, up to kMaxHarm MLT harmonics (none included) and up to
// kMaxShells local-ceiling shells, all riding in the parameters. The rest
// take two more medium values, each its instances' code at compile time
// (`wide` below), so that the instances above keep theirs: ANY, the
// extended chain under the reference scripts' modes (ALTX's code, and over
// the non-axial fields EXT's) that also blends a fractional plasmasphere
// or DE weight in the plain version's order and reads the MLT harmonics
// and the shells past those of the parameters from buffers on the card;
// and AD_ANY, the AD chain with those buffers (AD itself blends the
// weights, and takes a shape of no harmonic as the zero-padded
// coefficients give it: c0 with a tangent of zeros). Run-time branches for
// these in the media above cost their instances up to 8% at the default
// media (PERF.md).
// Template instances: float and double x bs3, dopri5 and rk4 x the three
// frames x the eight media over the dipole (2 x 3 x 3 x 8 = 144), and x the
// two non-axial fields in the 3D frame over FULL, EXT, AD, ANY and AD_ANY
// (60): 204, compiled in seventeen parts (one per frame, one per non-axial
// field, one for ALT, two for ALTX, three for AD, three for ANY and three
// for AD_ANY) by parallel nvcc processes and linked into one library
// (SC_PART below).
//
// Design for the card, not block by block:
//   - the carry of a ray lives in registers for all n_steps attempts and
//     is written back IN PLACE (the buffers are aliased in -> out, as the
//     Pallas kernel's input_output_aliases were);
//   - _step_one is a no-op on a ray that is not ACTIVE, so a ray that
//     stops stays as it stopped;
//   - field-major layout: vectors are (n, B), per-ray scalars (B,), so
//     neighbouring rays read neighbouring addresses (the Pallas kernel's
//     (n, B) layout, kept here for coalescing);
//   - every scalar of the medium, SolverConfig, StopSpec and the root is a
//     kernel argument passed by value (Pallas closed over them as
//     compile-time constants), so one build serves every medium;
//   - a trace's launch ends its rays itself: with `finish`, after the loop,
//     it refines every ray that ends on HIT_EARTH or HIT_EQUATOR
//     (integrate/solve.py::refine_events: one more right-hand side at
//     u_prev, 32 bisections of the Hermite interpolant), and with `fresh`,
//     before the loop, it forms k1 = rhs(u) (init_carry's right-hand side),
//     so the ~1,600 torch ops of the post-pass each trace call and the
//     ~400-700 of the first right-hand side leave the host (JAX runs both
//     as XLA ops around the Pallas call). Both are run-time flags of every
//     instance.
//
// What bounds it: operations, not bytes. A launch moves ~210 bytes a
// ray (float, 2D) or ~310 (float, 3D), the carry read and written once,
// while one attempt is three (bs3) or six (dopri5) evaluations
// of the fused right-hand side plus the controller. Counted per attempt
// from the plain version's elementwise operations
// (chip_smoke.py::ops_per_attempt, a transcendental counting one), a
// bs3 attempt is ~1,480 operations in 2D and ~1,780 in 3D (dopri5
// ~2,960 and ~3,620; over the full medium ~1,620 in 2D and ~2,010 in 3D
// with the MLT plasmapause), so 10,240 rays x 512 float32 bs3 attempts is
// bound at ~0.07-0.11 ms by the card's 67 TFLOP/s, against ~1e-3 ms for
// the bytes. But one ray is one long dependent chain: its attempts come
// one after another, its three right-hand sides too, and a 10,240-ray
// batch is 320 warps for the card's 528 warp schedulers, so each
// scheduler has at most one warp to issue from while that warp waits on
// its chain (2.7 ms in 2D, 4.3 ms in 3D over the MLT medium, 25-50x above
// the bound, PERF.md). The long-tailed runs end on a merged tail of 4-50
// rays that runs thousands of attempts on one warp a ray.
//
// One ray's chain (measured on an H100, PERF.md): the float bs3 2D
// attempt's SASS chain -- its register dependencies at nominal latencies,
// sass_census -- is ~4,000 cycles; one ray alone in a launch took ~8,430
// cycles an attempt, a merged tail 2-5% more (the divergence of 32 rays a
// warp is small), the full launch ~10,050. The chain binds: its latency
// floor (chain cycles x the longest ray's attempts) is 9x the throughput
// bound of a 10,240 x 512 launch. What lies above it is mostly
// instruction fetch: the attempt loop was 57 KB of code, three inlined
// right-hand sides, and the tail launched one ray a warp (four rays on
// different paths through the loop on each SM) ran 6-10% slower than 32
// rays a warp. The main path's instances (chain_instance below) take
//   - the stage loop: bs3's three right-hand sides through one inlined
//     copy (bs3_step), a 25 KB attempt loop: 14% off the full launch,
//     1-10% off the tails, 7-8% off one ray alone;
//   - the tail layout: a launch of at most ops/step_chunk.py::
//     TAIL_LAYOUT_MAX_RAYS rays runs one ray a warp in blocks of four
//     warps, so no two rays share a warp's branches: with the stage
//     loop's code 2-6% off the tails (6-7% off 528 rays, 7-9% slower
//     at 1,056).
// Measured and dropped: 1/f and log(errold) formed once a ray and the
// Stix terms of the field formed ahead of the density. They shortened the
// SASS chain by a fifth but moved no time by more than 1%, and cost 7
// registers: the nominal chain is not what the card waits on. Not tried
// again: the 2D team body (7-13% slower: a helper warp adds a
// barrier pair to a chain it cannot shorten), a __noinline__ right-hand
// side (B3: slower on the tails, where the call is paid on every stage),
// FMA contraction (~3%, and not bit for bit).
//
// Two bodies, chosen per instance at compile time (team_warps below), and
// a third beside the one-thread body of two AD instances:
//   - the one-thread body: one thread per ray, blocks of kThreads rays; a
//     thread leaves its loop once its ray stops. The whole chain is
//     inlined so that the compiler can interleave independent sub-chains
//     within the thread.
//   - the team body (team_warps below: every 3D full-chain instance over
//     the dipole): one ray is served by a team, the same lane in each of
//     the K = kTeamWarps = 4 warps of a block, so a block serves 32 rays.
//     Warp 0 holds the carry and runs the attempt, the controller, the
//     classification and the two-sum update; the other three warps are
//     helpers that compute the pieces of each right-hand side (the geometry,
//     the psi cosines and the Stix terms of the field; the ionosphere and
//     the MLT-resolved plasmapause; the density's terms in L and the Kimura
//     rows' trigonometry) while warp 0 waits. The exchange is shared memory
//     laid out [slot][lane] with two barriers a right-hand side: warp 0
//     posts the stage's state, the helpers post their pieces. Warps, never
//     lanes, take the roles (lanes of one warp that run different code
//     serialize), and the helpers skip the rays that are not live, so a ray
//     that has stopped (its state may sit at a wedge, where divisions take
//     their slow paths) costs nothing. Warp 0 leaves its loop once none of
//     its rays is ACTIVE (__any_sync) and posts an exit that the helpers
//     read at their next barrier; a lane with no ray rides along, never
//     live.
//     This design replaced a first one in which every warp ran the
//     controller and the Stix core redundantly: that one ran 1.0-2.2x
//     slower than the one-thread body, the four warps issuing four times
//     the remainder of each right-hand side (PERF.md).
//   - both, in the float bs3 instances over the non-axial fields (those of
//     ensemble10k_tilted and ensemble10k_igrf; general_team below): the
//     team body (rhs_general_team: the field's geometry beside the
//     density's head and its terms in L) in the tail layout, a launch of at
//     most ops/step_chunk.py::TEAM_LAYOUT_MAX_RAYS rays, the one-thread
//     body in wider ones (launch below). On one ray's chain the team body
//     is the faster: the merged tails (4 and 18 rays) ran 0.80 / 0.81x the
//     one-thread body's time, 15,040-15,390 / 15,760-16,410 cycles an
//     attempt against 18,760-19,070 / 19,610-20,160. At the full launch,
//     where 320 blocks share 132 SMs, its helpers' issue crowds the SMs:
//     10,240 rays x 512 attempts ran 1.15 / 1.27x slower; at 528 rays 1.04-
//     1.14x, at 132-264 0.76-0.91x (PERF.md). Tried and dropped: bs3's
//     stage loop in warp 0 (the tails 1.24 / 1.16x the unrolled team's
//     time) and warp 0's part of the right-hand side out of line (1.09 /
//     1.12x).
//   - the group body, in the bs3 AD instances of ensemble10k and
//     ensemble10k_local (float and double), ensemble10k_tilted (float) and
//     ensemble10k_3d (double) under the autodiff set
//     (group_instance below): a ray is served by a group of G =
//     group_lanes lanes of one warp (4 in 2D, N = 4; 8 in 3D, N = 7, the
//     eighth lane seeding no input), in blocks of kThreads lanes. Every
//     lane of a group loads the ray's carry and runs the attempt, the
//     controller, the classification and the two-sum update on the same
//     values: the branches read values only, so a group never diverges,
//     and its first lane writes the carry back. What differs is the dual
//     chain (ad_mu_grads_group): lane j seeds input j alone, so its chain
//     is the value chain and one tangent row, where the one-thread body
//     carries all N rows on one thread (1 + N rules an op; the rules of a
//     quotient, a square root and a log are an IEEE division each), and
//     shuffles within the group then hand every lane the N rows. Each row
//     is computed alone from the values and its own row, so the two bodies
//     agree bit for bit. A lane's out-of-line right-hand side is 0.61x
//     (2D) / 0.52x (3D) the one-thread body's instructions in float,
//     0.63x / 0.56x in double (where it also drops the 3D instance's
//     spills); the merged tails ran 0.71x / 0.56x its time in float,
//     0.67x / 0.42x in double (PERF.md). A launch takes it by flag bit 3
//     where it measured faster (ops/step_chunk.py::GROUP_MAX_RAYS: the
//     float 2D instance at every width, the others up to one wave, or two
//     in double 3D). Measured and dropped: one group a warp (the tails
//     1.03x / 1.00x, 1.3-5.4x slower from 2,112 rays up), the right-hand
//     side inlined (the tails 1.13-1.57x, the full launch 1.05 / 1.30x;
//     in double the tails 1.25x), in double the group body held to three
//     blocks an SM (168 registers: the full launch 0.63x / 0.80x its
//     unbounded time, the tails 1.07x / 1.09x, the 3D one spilling 398
//     bytes) and in 3D four lanes of two rows a ray (the one-ray tail
//     1.55x).
// The 7-state axisymmetric double dopri5 instance spills 64 bytes, and the
// team body's double instances, held to 168 registers (kTeamBlocks
// below), spill too (PERF.md lists -Xptxas -v).
//
// The FULL medium's scalars that depend on the env alone (1/ps_smooth,
// log(gcpm_ne0), cos(ps_mlt_a0), ...: ops/fused.py::MediumConsts) are
// formed once in double on the host, by the same Python function the plain
// version uses, and cast to T here, so both round them alike.
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
//
// rsqrt: the 3D chain normalizes rho with rsqrt (ops/fused.py, as the JAX
// package does) and the 2D chain forms L^-4.5 with it. CUDA's rsqrtf and
// rsqrt are not correctly rounded (2 and 1 ulp), and neither is
// anything that would copy XLA's. The kernel and the plain version share
// the card's own: torch.rsqrt on a CUDA tensor calls the same CUDA rsqrt
// as d_rsqrt below, so the two agree bit for bit on the card. On the CPU
// torch.rsqrt is 1/sqrt, and the plain version is held to the JAX
// package at the tests' stated tolerance.

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
// sqrt(3), sqrt(6), sqrt(15), sqrt(10) of the Schmidt normalization
constexpr double kRt3 = 1.7320508075688772;
constexpr double kRt6 = 2.449489742783178;
constexpr double kRt15 = 3.872983346207417;
constexpr double kRt10 = 3.1622776601683795;

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
constexpr int RK4 = 2;      // fixed step: what adaptive=False runs
constexpr int LAT2D = 0;    // the 2D latitude frame, 4-state carry
constexpr int KIM3D = 1;    // the 3D Kimura frame, 7-state carry
constexpr int COLAT2D = 2;  // the 2D colatitude frame, 4-state carry
constexpr int AXI = 0;    // the axisymmetric medium of the first slices
constexpr int FULL = 1;   // the full density chain
constexpr int EXT = 2;    // the full chain with the ion species and ds_local
constexpr int ALT = 3;    // AXI under the reference scripts' modes
constexpr int ALTX = 4;   // EXT under the reference scripts' modes
constexpr int AD = 5;     // the autodiff set over any medium and field
constexpr int ANY = 6;    // ALTX (EXT over the non-axial fields) with any
                          // weight, harmonic count and shell count
constexpr int AD_ANY = 7;  // AD with any harmonic count and shell count
constexpr int DIPOLE = 0;  // the centered dipole
constexpr int TILTED = 1;  // the tilted dipole (3D frame, full medium)
constexpr int IGRF = 2;    // the degree-3 IGRF truncation (likewise)
constexpr int kThreads = 128;
constexpr int kMaxHarm = 8;  // MLT harmonics in the parameters
constexpr int kMaxShells = 4;  // local-ceiling shells in the parameters
constexpr int kMaxIon = 3;     // ion species: protons, He+, O+

// Warps of a team in the team body (the design note above), and which
// instances take it; 0: the one-thread body. dtype 0 = float, 1 = double.
// A compile-time choice per instance, by the times measured against the
// one-thread body at the full launch (10,240 rays x 512 attempts) and on
// the merged tails (PERF.md): the 3D full chain over the dipole takes it in
// every instance (faster at both shapes); over the non-axial fields its
// float bs3 instances (general_team) take it in the tail layout alone
// (faster on the tails, slower at the full launch). Every other instance
// keeps the one-thread body: the 2D axisymmetric chain ran 7-13% slower on
// the team body in float bs3 and dopri5 and double bs3 and rk4, at the full
// launch and on its runs' tails, and its double dopri5 instance, faster at
// the full launch, ran raymain's one ray 8% slower. The general-field
// siblings (double, dopri5, rk4) are not measured on it yet (ROADMAP B4).
constexpr int kTeamWarps = 4;
// blocks of the team body resident on an SM that its register allocation
// must leave room for: 10,240 rays are 320 blocks over 132 SMs (unbounded,
// the double instances took 216-255 registers, two blocks a SM, and ran
// the launch in two waves)
constexpr int kTeamBlocks = 3;

__host__ __device__ constexpr bool general_team(int dtype, int stepper,
                                                int frame, int medium,
                                                int field) {
  return dtype == 0 && stepper == BS3 && frame == KIM3D && medium == FULL &&
         field != DIPOLE;
}

constexpr int team_warps(int dtype, int stepper, int frame, int medium,
                         int field) {
  return frame == KIM3D && medium == FULL &&
                 (field == DIPOLE ||
                  general_team(dtype, stepper, frame, medium, field))
             ? kTeamWarps
             : 0;
}

// The one-thread body's redesign for one ray's chain (the note "one ray's
// chain" above), and the instances that take each of its two elements:
// the float bs3 instances of the 2D frames over the axisymmetric medium,
// the main path's (ensemble10k and its colatitude fan; the production fan
// with ds_max and the trajectory channel's blocks launch them too). Their
// double siblings share the template and keep the code they had.
__host__ __device__ constexpr bool chain_instance(int dtype, int stepper,
                                                  int frame, int medium,
                                                  int field) {
  return dtype == 0 && stepper == BS3 && (frame == LAT2D || frame == COLAT2D)
         && medium == AXI && field == DIPOLE;
}
// the tail layout: a launch of few rays (the wrapper's threshold) runs one
// ray a warp, or over the non-axial fields on the team body
__host__ __device__ constexpr bool tail_layout(int dtype, int stepper,
                                               int frame, int medium,
                                               int field) {
  return chain_instance(dtype, stepper, frame, medium, field) ||
         general_team(dtype, stepper, frame, medium, field);
}
// one inlined right-hand side for bs3's three stages
__host__ __device__ constexpr bool stage_loop(int dtype, int stepper,
                                              int frame, int medium,
                                              int field) {
  return chain_instance(dtype, stepper, frame, medium, field);
}
// The AD instances redesigned for one ray's chain (the note "the group
// body" above): the float bs3 ones of the 2D latitude frame over the dipole
// (ensemble10k and ensemble10k_local under grad_mode="autodiff") and of
// the 3D frame over the tilted dipole (ensemble10k_tilted), and the double
// bs3 ones of the 2D latitude frame and the 3D frame over the dipole (the
// float64 runs of ensemble10k, ensemble10k_local and ensemble10k_3d). Each
// keeps its one-thread body and has the group body beside it, which a
// launch takes by flag bit 3 (ops/step_chunk.py::launch_flags: where it
// measured faster). Their siblings keep the one-thread body alone (ROADMAP
// B4).
__host__ __device__ constexpr bool group_instance(int dtype, int stepper,
                                                  int frame, int medium,
                                                  int field) {
  return stepper == BS3 && medium == AD &&
         ((frame == LAT2D && field == DIPOLE) ||
          (dtype == 0 && frame == KIM3D && field == TILTED) ||
          (dtype == 1 && frame == KIM3D && field == DIPOLE));
}
// the lanes of a group: one a seeded input (N = 4 in 2D, 7 in 3D), a
// power of two
__host__ __device__ constexpr int group_lanes(int frame) {
  return frame == KIM3D ? 8 : 4;
}

// the media whose density is the full chain (AXI and ALT: the
// axisymmetric one)
__host__ __device__ constexpr bool full_density(int medium) {
  return medium == FULL || medium == EXT || medium == ALTX || medium == ANY;
}

// the media of the extended chain: the Stix sums over the ion species and
// the local arc ceiling at run time (AD: its own chain, with both)
__host__ __device__ constexpr bool extended(int medium) {
  return medium == EXT || medium == ALTX || medium == AD || medium == ANY ||
         medium == AD_ANY;
}

// the media that read the reference scripts' modes (p.ref_grads,
// p.legacy_freq)
__host__ __device__ constexpr bool ref_modes(int medium) {
  return medium == ALT || medium == ALTX || medium == ANY;
}

// the media of the autodiff set
__host__ __device__ constexpr bool autodiff(int medium) {
  return medium == AD || medium == AD_ANY;
}

// the media that take any weight, harmonic count and shell count: fused
// chains that blend the weights, the harmonics and the shells past the
// parameters' from their buffers on the card
__host__ __device__ constexpr bool wide(int medium) {
  return medium == ANY || medium == AD_ANY;
}

// state dimension of a frame; the group delay is the last component
template <int FRAME>
struct FrameDim {
  static constexpr int N = FRAME == KIM3D ? 7 : 4;
};

}  // namespace

// host-side scalars (mirror of ops/step_chunk.py::StepParams): 123 doubles
// and two pointers, 1,000 bytes; the kernel's own KParams<double> stays
// near 1.2 KB, far below the 4 KB a kernel's parameters may take
struct StepParams {
  double b0, iono_n0, iono_decay, iono_r0, lppi, lppo, ne_lppi, ps_season,
      ps_trough, ps_weight, de_weight, root;
  double rtol, atol, dt_min, dt_max, safety, pi_alpha, pi_beta, fac_min,
      fac_max, accept_tol, stall_dt_factor, stall_count, ds_max;
  double r_floor, r_ceil, t_max, group_time_max, stop_at_equator, lat_sign,
      lat_offset, stop_retrograde;
  // the FULL medium: env fields (gcpm 1.0 = ps_model "gcpm")
  double iono_n0_b, iono_decay_b, iono_mix, gcpm, gcpm_bpow, ps_smooth,
      ps_refill, ps_refill_q, duct_amp, duct_l0, ps_mlt, ps_mlt_a0,
      ps_mlt_tamp, ps_mlt_c3, n_harm;
  // ... and ops/fused.py::MediumConsts, formed in double on the host
  double one_m_mix, ln_ne_lppi, inv_smooth, one_m_refill, ln_lref, ln_keep,
      ln_gcpm_ne0, inv_lscale, inv_knee, inv_duct_w, duct_slope, cos_a0;
  double ps_mlt_c[1 + 2 * kMaxHarm];  // (c0, c1, s1, c2, s2, ...)
  // the non-axial fields: models/dipole.py::moment_unit and mlon_axes of
  // (b_tilt, b_tilt_phi), and the 15 Schmidt coefficients (nT)
  double b_mom[3], b_xm[3], b_ym[3], igrf[15];
  // the local arc ceiling: frac, the shell count (0 = off) and each
  // shell's L and width, the knee first
  double ds_local_frac, n_shells, shell_l[kMaxShells], shell_w[kMaxShells];
  // the ion species: count, then fpe2 coefficient x fraction and fce
  // coefficient of each (dispersion.ion_species)
  double n_ion, ion_fpe2[kMaxIon], ion_fce[kMaxIon];
  // the reference scripts' modes, read by the ALT instances only (1.0 =
  // on): the reference gradient set, and the 2D frequency read as f + T
  double ref_grads, legacy_freq;
  // the divisors the AD instances' value chain divides by as the plain
  // version does (1 / x formed in T): the GCPM scale and knee, the duct's
  // width
  double gcpm_lscale, gcpm_knee, duct_w;
  // on the card, in T: the MLT coefficients past kMaxHarm harmonics (c, s
  // of each) and the shells past kMaxShells ((L, width) of each), read by
  // the wide media; NULL where there are none
  const void* mlt_ext;
  const void* shell_ext;
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
  T ds_max;
  bool ds_on;
  T ds_local_frac, shell_l[kMaxShells], shell_w[kMaxShells];
  int n_shells;
  bool ds_local_on;
  T ion_fpe2[kMaxIon], ion_fce[kMaxIon];
  int n_ion;
  T r_floor, r_ceil, t_max, group_time_max, lat_sign, lat_offset;
  bool equator_on, retro_on;
  // the FULL medium
  T iono_n0_b, iono_decay_b, iono_mix, gcpm_bpow, ps_refill, ps_refill_q,
      duct_amp, duct_l0, ps_mlt_a0, ps_mlt_tamp, ps_mlt_c3;
  T one_m_mix, ln_ne_lppi, inv_smooth, one_m_refill, ln_lref, ln_keep,
      ln_gcpm_ne0, inv_lscale, inv_knee, inv_duct_w, duct_slope, cos_a0;
  T mlt_c[1 + 2 * kMaxHarm];
  T mom[3], xm[3], ym[3], igrf[15];  // the non-axial fields
  int n_harm;
  bool iono_mix_on, gcpm_on, smooth_on, refill_on, refill_q_on, duct_on,
      mlt_on;
  // the ALT instances' two modes (AD reads legacy_freq)
  bool ref_grads, legacy_freq;
  // the AD instances' value chain (ops/dispersion.py over models/): the
  // env scalars as the plain version's Python floats are cast to T
  // (products and negations of them formed in double), and the Python
  // scalar divisors as reciprocals formed in T, as torch forms them for a
  // quotient by a Python scalar on the card
  T neg_decay, neg_decay_b, de_w, one_m_de_w, ps_w, neg2b0, negb0;
  T inv_smooth_t, inv_lscale_t, inv_knee_t, inv_duct_w_t;
};

// The wide media's kernel parameters: KParams and past it 1e6 ps_weight (a
// product of Python floats in the plain version, formed in double) and the
// buffers past the parameters. A struct of their own, so that the other
// instances' parameters stay what they were: an instance that passes them
// to an out-of-line right-hand side copies them to its stack, and a larger
// copy changed its code. Every function takes KParams; the wide code reads
// the rest through wide_params.
template <typename T>
struct KParamsWide : KParams<T> {
  T ne_w;
  const T* mlt_ext;
  const T* shell_ext;
};

template <typename T, bool WIDE>
struct ParamsOf {
  using type = KParams<T>;
};

template <typename T>
struct ParamsOf<T, true> {
  using type = KParamsWide<T>;
};

// the rest of a wide instance's parameters (p is its KParamsWide)
template <typename T>
__device__ __forceinline__ const KParamsWide<T>& wide_params(
    const KParams<T>& p) {
  return static_cast<const KParamsWide<T>&>(p);
}

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
  // the controller's order (rk4 has no controller; _step_one sets 5)
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
  p.ds_max = T(h.ds_max);
  p.ds_on = h.ds_max > 0.0;
  p.ds_local_frac = T(h.ds_local_frac);
  p.n_shells = (int)h.n_shells;
  p.ds_local_on = p.n_shells > 0;
  for (int k = 0; k < kMaxShells; ++k) {
    p.shell_l[k] = T(h.shell_l[k]);
    p.shell_w[k] = T(h.shell_w[k]);
  }
  p.n_ion = (int)h.n_ion;
  for (int k = 0; k < kMaxIon; ++k) {
    p.ion_fpe2[k] = T(h.ion_fpe2[k]);
    p.ion_fce[k] = T(h.ion_fce[k]);
  }
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
  p.iono_n0_b = T(h.iono_n0_b);
  p.iono_decay_b = T(h.iono_decay_b);
  p.iono_mix = T(h.iono_mix);
  p.gcpm_bpow = T(h.gcpm_bpow);
  p.ps_refill = T(h.ps_refill);
  p.ps_refill_q = T(h.ps_refill_q);
  p.duct_amp = T(h.duct_amp);
  p.duct_l0 = T(h.duct_l0);
  p.ps_mlt_a0 = T(h.ps_mlt_a0);
  p.ps_mlt_tamp = T(h.ps_mlt_tamp);
  p.ps_mlt_c3 = T(h.ps_mlt_c3);
  p.one_m_mix = T(h.one_m_mix);
  p.ln_ne_lppi = T(h.ln_ne_lppi);
  p.inv_smooth = T(h.inv_smooth);
  p.one_m_refill = T(h.one_m_refill);
  p.ln_lref = T(h.ln_lref);
  p.ln_keep = T(h.ln_keep);
  p.ln_gcpm_ne0 = T(h.ln_gcpm_ne0);
  p.inv_lscale = T(h.inv_lscale);
  p.inv_knee = T(h.inv_knee);
  p.inv_duct_w = T(h.inv_duct_w);
  p.duct_slope = T(h.duct_slope);
  p.cos_a0 = T(h.cos_a0);
  for (int k = 0; k < 1 + 2 * kMaxHarm; ++k) p.mlt_c[k] = T(h.ps_mlt_c[k]);
  for (int k = 0; k < 3; ++k) {
    p.mom[k] = T(h.b_mom[k]);
    p.xm[k] = T(h.b_xm[k]);
    p.ym[k] = T(h.b_ym[k]);
  }
  for (int k = 0; k < 15; ++k) p.igrf[k] = T(h.igrf[k]);
  p.n_harm = (int)h.n_harm;
  p.iono_mix_on = h.iono_mix != 1.0;
  p.gcpm_on = h.gcpm != 0.0;
  p.smooth_on = h.ps_smooth != 0.0;
  p.refill_on = h.ps_refill != 0.0;
  p.refill_q_on = h.ps_refill_q != 0.0;
  p.duct_on = h.duct_amp != 0.0;
  p.mlt_on = h.ps_mlt != 0.0;
  p.ref_grads = h.ref_grads != 0.0;
  p.legacy_freq = h.legacy_freq != 0.0;
  p.neg_decay = T(-h.iono_decay);
  p.neg_decay_b = T(-h.iono_decay_b);
  p.de_w = T(h.de_weight);
  p.one_m_de_w = T(1.0 - h.de_weight);
  p.ps_w = T(h.ps_weight);
  p.neg2b0 = T(-2.0 * h.b0);
  p.negb0 = T(-h.b0);
  const auto inv_t = [](double x) { return x != 0.0 ? T(1) / T(x) : T(0); };
  p.inv_smooth_t = inv_t(h.ps_smooth);
  p.inv_lscale_t = inv_t(h.gcpm_lscale);
  p.inv_knee_t = inv_t(h.gcpm_knee);
  p.inv_duct_w_t = inv_t(h.duct_w);
  return p;
}

// an instance's parameters: KParams, or for the wide media KParamsWide
template <typename T, bool WIDE>
typename ParamsOf<T, WIDE>::type params_of(const StepParams& h, int stepper) {
  if constexpr (WIDE) {
    KParamsWide<T> p;
    static_cast<KParams<T>&>(p) = make_params<T>(h, stepper);
    p.ne_w = T(1.0e6 * h.ps_weight);
    p.mlt_ext = static_cast<const T*>(h.mlt_ext);
    p.shell_ext = static_cast<const T*>(h.shell_ext);
    return p;
  } else {
    return make_params<T>(h, stepper);
  }
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
__device__ __forceinline__ float d_tan(float x) { return tanf(x); }
__device__ __forceinline__ double d_tan(double x) { return tan(x); }
__device__ __forceinline__ float d_atan(float x) { return atanf(x); }
__device__ __forceinline__ double d_atan(double x) { return atan(x); }
__device__ __forceinline__ float d_acos(float x) { return acosf(x); }
__device__ __forceinline__ double d_acos(double x) { return acos(x); }
__device__ __forceinline__ float d_asin(float x) { return asinf(x); }
__device__ __forceinline__ double d_asin(double x) { return asin(x); }
__device__ __forceinline__ float d_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double d_atan2(double y, double x) {
  return atan2(y, x);
}
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
// torch.sign: (0 < x) - (x < 0), so +0 for 0, -0 and NaN
template <typename T>
__device__ __forceinline__ T tsign(T x) {
  return T(T(0) < x ? 1 : 0) - T(x < T(0) ? 1 : 0);
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

// The pieces of the team body (the design note above): the parts of a
// right-hand side that depend on few inputs (the field geometry, the
// ionosphere, the plasmasphere's terms in L, the Stix terms of the field
// alone), each computed by one helper warp and handed to warp 0 whole
// through shared memory (a piece is a struct of T), and the remainder that
// combines them. The geometry and the Stix pieces serve both bodies. The
// density pieces (ne_head, ne_lterms, ne_tail below) compute what
// ne_and_grads_full computes, operation for operation, so that the bodies
// agree bit for bit; the one-thread body keeps ne_and_grads_full whole,
// since composed from the pieces (their flag checks repeated between
// them) its instances ran 2-4% slower (PERF.md).

// L = r / cos^2(lat) and dL/dr; 1/cos(lat) for dL/dlat = 2 L sin/cos
template <typename T>
struct LShell {
  T L, L_r, inv_cl;
};

template <typename T>
__device__ __forceinline__ LShell<T> l_shell(T r, T cl) {
  LShell<T> s;
  s.inv_cl = T(1) / cl;
  const T inv_cl2 = s.inv_cl * s.inv_cl;
  s.L = r * inv_cl2;
  s.L_r = inv_cl2;
  return s;
}

// the diffusive-equilibrium factor and its d/dr
template <typename T>
__device__ __forceinline__ void de_factor(T r, T& de, T& de_r) {
  const T G = T(kDeRbase) * (T(1) - recip(r * T(kRE)) * T(kDeRbase));
  de = d_sqrt(d_exp(-G * recip(T(kDeS))));
  de_r = -de * T(kDeRbase) * T(kDeRbase) / (T(2.0 * kDeS) * r * r * T(kRE));
}

// models/medium.py::_mlt_shape: the Fourier plasmapause shape at a0 + phi
// and its phi-slope by angle recursion (one sin, one cos), and the
// day-night trough with its phi-slope. Unrolled to kMaxHarm so that every
// coefficient index is a constant (no local copy of the parameters); WIDE
// (the wide media): the harmonics past it from their buffer, in a rolled
// loop that goes on with the recursion and the sums in the same order.
template <typename T, bool WIDE = false>
__device__ __forceinline__ void mlt_shape(T phi, const KParams<T>& p,
                                          T& shape, T& dshape, T& trough_e,
                                          T& dtrough) {
  const T ang = p.ps_mlt_a0 + phi;
  const T s1a = d_sin(ang), c1a = d_cos(ang);
  T sk = s1a, ck = c1a;
  shape = p.mlt_c[0];
  dshape = T(0);
#pragma unroll
  for (int k = 1; k <= kMaxHarm; ++k) {
    if (k > p.n_harm) break;
    if (k > 1) {
      const T sn = sk * c1a + ck * s1a;
      const T cn = ck * c1a - sk * s1a;
      sk = sn;
      ck = cn;
    }
    shape = shape + p.mlt_c[2 * k - 1] * ck + p.mlt_c[2 * k] * sk;
    dshape = dshape + T(k) * (p.mlt_c[2 * k] * ck - p.mlt_c[2 * k - 1] * sk);
  }
  if constexpr (WIDE) {
    for (int k = kMaxHarm + 1; k <= p.n_harm; ++k) {
      const T sn = sk * c1a + ck * s1a;
      const T cn = ck * c1a - sk * s1a;
      sk = sn;
      ck = cn;
      const T* c = wide_params(p).mlt_ext + 2 * (k - kMaxHarm - 1);
      shape = shape + c[0] * ck + c[1] * sk;
      dshape = dshape + T(k) * (c[1] * ck - c[0] * sk);
    }
  }
  trough_e = p.ps_trough + p.ps_mlt_tamp * (c1a - p.cos_a0);
  dtrough = -p.ps_mlt_tamp * s1a;
}

// ops/fused.py::_ne_and_grads + _gcpm_and_grads + _compose_ne over the
// whole medium: total density (m^-3) and its (r, lat) partials and, with
// `mlt` (the 3D frame over the MLT-resolved medium, phi the longitude),
// its phi partial; ne_phi is 0 otherwise. Every gate is a flag of p. WIDE
// (the wide media): any harmonic count (mlt_shape), and the plasmasphere
// and DE weights blended as the plain version blends them; else the
// weights are 0 or 1, the flags p.ps_on and p.de_on.
template <typename T, bool WIDE = false>
__device__ __forceinline__ void ne_and_grads_full(T r, T sl, T cl, T phi,
                                                  bool mlt,
                                                  const KParams<T>& p, T& ne,
                                                  T& ne_r, T& ne_lat,
                                                  T& ne_phi) {
  const T dr0 = r - p.iono_r0;
  T ni = p.iono_n0 * d_exp(-p.iono_decay * dr0);
  T ni_r = -p.iono_decay * ni;
  if (p.iono_mix_on) {  // day/night blend of two fits
    const T nb = p.iono_n0_b * d_exp(-p.iono_decay_b * dr0);
    ni = p.iono_mix * ni + p.one_m_mix * nb;
    ni_r = p.iono_mix * ni_r + p.one_m_mix * (-p.iono_decay_b * nb);
  }
  ne_phi = T(0);
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

  T ne_p, dne_p, ne_p_phi = T(0), lat_direct = T(0);
  if (p.gcpm_on) {
    // simplified GCPM: log-space value, d/dL and the direct d/dlat at
    // fixed L (the mirror ratio); the knee and trough move with MLT
    T lppo_e = p.lppo, trough_e = p.ps_trough, dlppo = T(0), dtrough = T(0);
    if (mlt) {
      T shape, dshape;
      mlt_shape<T, WIDE>(phi, p, shape, dshape, trough_e, dtrough);
      lppo_e = p.lppo * shape;
      dlppo = p.lppo * dshape;
    }
    const T q2g = T(1) + T(3) * sl * sl;
    const T ln_m = T(0.5) * d_log(q2g) - T(6) * d_log(cl);
    const T dln_m = T(3) * sl * cl / q2g + T(6) * sl / cl;
    const T ln_ps =
        (p.ln_gcpm_ne0 - (L - T(2)) * p.inv_lscale) + p.gcpm_bpow * ln_m;
    const T Lsg = jmax(L, T(1.0e-6));
    const T f45g = d_exp(T(-4.5) * d_log(Lsg));
    const T p3g = trough_e * f45g;
    const T e3g = d_exp((T(2) - L) * recip(T(10)));
    const T ne3g = p3g + (T(1) - e3g);
    const T ln_tr = d_log(ne3g);
    const T dln_tr = (T(-4.5) * p3g / Lsg + e3g * recip(T(10))) / ne3g;
    const T wk = T(1) / (T(1) + d_exp(-(lppo_e - L) * p.inv_knee));
    const T dwk = -wk * (T(1) - wk) * p.inv_knee;
    ne_p = d_exp(wk * ln_ps + (T(1) - wk) * ln_tr);
    dne_p = ne_p * (dwk * (ln_ps - ln_tr) - wk * p.inv_lscale +
                    (T(1) - wk) * dln_tr);
    lat_direct = ne_p * wk * p.gcpm_bpow * dln_m;
    if (mlt) {
      const T dwk_phi = wk * (T(1) - wk) * p.inv_knee * dlppo;
      const T dln_tr_phi = dtrough * f45g / ne3g;
      ne_p_phi =
          ne_p * (dwk_phi * (ln_ps - ln_tr) + (T(1) - wk) * dln_tr_phi);
    }
  } else {
    // CA1992 at the effective (MLT-resolved) or the env parameters
    T lppi_e = p.lppi, lppo_e = p.lppo, ne_lppi_e = p.ne_lppi,
      trough_e = p.ps_trough;
    T dlppi = T(0), dlppo = T(0), dg1i = T(0), dtrough = T(0);
    if (mlt) {  // models/medium.py::mlt_ps_params
      T shape, dshape;
      mlt_shape<T, WIDE>(phi, p, shape, dshape, trough_e, dtrough);
      lppi_e = p.lppi * shape;
      dlppi = p.lppi * dshape;
      const T e_i = d_exp((T(2) - lppi_e) * recip(T(1.5)));
      const T g1i = (T(-0.3145) * lppi_e + T(3.9043)) + p.ps_season * e_i;
      dg1i = (T(-0.3145) - p.ps_season * e_i * recip(T(1.5))) * dlppi;
      ne_lppi_e = d_exp(T(kLN10) * g1i);
      lppo_e = lppi_e + T(0.1) * (g1i - p.ps_mlt_c3);
      dlppo = dlppi + T(0.1) * dg1i;
    }
    const T e1 = d_exp((T(2) - L) * recip(T(1.5)));
    const T g1 = (T(-0.3145) * L + T(3.9043)) + p.ps_season * e1;
    const T ne1 = d_exp(T(kLN10) * g1);
    const T dne1 =
        T(kLN10) * ne1 * (T(-0.3145) - p.ps_season * e1 * recip(T(1.5)));
    const T ne2 =
        ne_lppi_e * d_exp(T(kLN10) * (lppi_e - L) * recip(T(0.1)));
    const T dne2 = T(-(kLN10 / 0.1)) * ne2;
    const T Ls = jmax(L, T(1.0e-6));
    const T inv_Ls = T(1) / Ls;
    const T inv_Ls2 = inv_Ls * inv_Ls;
    const T f45 = (inv_Ls2 * inv_Ls2) * d_rsqrt(Ls);
    const T p3 = trough_e * f45;
    const T e3 = d_exp((T(2) - L) * T(0.1));
    T ne3 = p3 + (T(1) - e3);
    T dne3 = T(-4.5) * p3 * inv_Ls + e3 * T(0.1);
    T dln2_phi = T(0), dne2_phi = T(0), dne3_phi = T(0);
    if (mlt) {
      dln2_phi = T(kLN10) * (dg1i + dlppi * recip(T(0.1)));
      dne2_phi = ne2 * dln2_phi;
      dne3_phi = dtrough * f45;
    }
    if (p.refill_on) {  // log-space trough refill toward branch 1
      const T ln3 = d_log(ne3);
      const T ln1 = T(kLN10) * g1;
      T w_r = p.ps_refill, one_m_w = p.one_m_refill, dw = T(0);
      if (p.refill_q_on) {  // per-L weight (plasmasphere.refill_weight)
        const T e_r = d_exp(p.ps_refill_q * (p.ln_lref - d_log(Ls)));
        const T keep = d_exp(e_r * p.ln_keep);
        w_r = T(1) - keep;
        one_m_w = T(1) - w_r;
        dw = keep * p.ln_keep * p.ps_refill_q * e_r / Ls;
      }
      const T ln3_eff = one_m_w * ln3 + w_r * ln1;
      T dln3_eff = one_m_w * (dne3 / ne3) + w_r * (dne1 / ne1);
      if (p.refill_q_on) dln3_eff = dln3_eff + dw * (ln1 - ln3);
      const T ne3_eff = d_exp(ln3_eff);
      if (mlt) dne3_phi = ne3_eff * one_m_w * (dne3_phi / ne3);
      ne3 = ne3_eff;
      dne3 = ne3 * dln3_eff;
    }
    if (p.smooth_on) {
      // log-space sigmoid blends; ln2 analytically (ne2 may underflow)
      const T inv_w = p.inv_smooth;
      const T s1 = T(1) / (T(1) + d_exp(-(lppi_e - L) * inv_w));
      const T s2 = T(1) / (T(1) + d_exp(-(lppo_e - L) * inv_w));
      const T ds1 = -s1 * (T(1) - s1) * inv_w;
      const T ds2 = -s2 * (T(1) - s2) * inv_w;
      const T ln1 = T(kLN10) * g1;
      const T dln1 = dne1 / ne1;
      const T ln_nl = mlt ? d_log(ne_lppi_e) : p.ln_ne_lppi;
      const T ln2 = ln_nl + T(kLN10) * (lppi_e - L) * recip(T(0.1));
      const T dln2 = T(-(kLN10 / 0.1));
      const T ln3 = d_log(ne3);
      const T dln3 = dne3 / ne3;
      const T inner = s2 * ln2 + (T(1) - s2) * ln3;
      const T dinner = ds2 * (ln2 - ln3) + s2 * dln2 + (T(1) - s2) * dln3;
      const T lns = s1 * ln1 + (T(1) - s1) * inner;
      ne_p = d_exp(lns);
      dne_p = ne_p * (ds1 * (ln1 - inner) + s1 * dln1 + (T(1) - s1) * dinner);
      if (mlt) {
        const T ds1_phi = -ds1 * dlppi;
        const T ds2_phi = -ds2 * dlppo;
        const T dln3_phi = dne3_phi / ne3;
        const T dinner_phi = ds2_phi * (ln2 - ln3) + s2 * dln2_phi +
                             (T(1) - s2) * dln3_phi;
        ne_p_phi = ne_p * (ds1_phi * (ln1 - inner) + (T(1) - s1) * dinner_phi);
      }
    } else {
      // hard branches with <= at the effective boundaries; the d/dphi of
      // branch 1 is exactly 0
      const bool in1 = L <= lppi_e;
      const bool in2 = L <= lppo_e;
      ne_p = in1 ? ne1 : (in2 ? ne2 : ne3);
      dne_p = in1 ? dne1 : (in2 ? dne2 : dne3);
      if (mlt) ne_p_phi = in1 ? T(0) : (in2 ? dne2_phi : dne3_phi);
    }
  }

  if (p.duct_on) {  // Gaussian duct: value and d/dL together
    const T x = (L - p.duct_l0) * p.inv_duct_w;
    const T e = d_exp(T(-0.5) * x * x);
    const T g = T(1) + p.duct_amp * e;
    const T dg = p.duct_slope * x * e;
    dne_p = dne_p * g + ne_p * dg;
    ne_p = ne_p * g;
    lat_direct = lat_direct * g;
    ne_p_phi = ne_p_phi * g;
  }
  T de = T(1), de_r = T(0);
  if (p.de_on) {
    const T G = T(kDeRbase) * (T(1) - recip(r * T(kRE)) * T(kDeRbase));
    de = d_sqrt(d_exp(-G * recip(T(kDeS))));
    de_r = -de * T(kDeRbase) * T(kDeRbase) /
           (T(2.0 * kDeS) * r * r * T(kRE));
  }
  T lat_term = dne_p * L_lat;
  if (p.gcpm_on) lat_term = lat_term + lat_direct;
  if constexpr (WIDE) {
    // ops/fused.py::_compose_ne: de = w_de de + (1 - w_de), and with the
    // plasmasphere's weight w: 1e6 (ni + (w ne_p) de), 1e6 (ni_r + w (...))
    // and the angular partials scaled by (1e6 w) de, 1e6 w formed in double
    T scale = wide_params(p).ne_w;
    if (p.de_on) {
      de = p.de_w * de + p.one_m_de_w;
      de_r = p.de_w * de_r;
      scale = wide_params(p).ne_w * de;
    }
    ne = T(1.0e6) * (ni + p.ps_w * ne_p * de);
    ne_r = T(1.0e6) * (ni_r + p.ps_w * (dne_p * L_r * de + ne_p * de_r));
    ne_lat = scale * lat_term;
    if (mlt) ne_phi = scale * ne_p_phi;
  } else {
    ne = T(1.0e6) * (ni + ne_p * de);
    ne_r = T(1.0e6) * (ni_r + (dne_p * L_r * de + ne_p * de_r));
    ne_lat = (T(1.0e6) * de) * lat_term;
    if (mlt) ne_phi = (T(1.0e6) * de) * ne_p_phi;
  }
}

// ne_and_grads_full in three pieces: ne_head (the ionosphere and, with
// `mlt`, the plasmapause's parameters at the longitude phi, models/
// medium.py::mlt_ps_params and mlt_gcpm_params), ne_lterms (what depends on
// r, lat and L alone), and ne_tail, which combines them into the total
// density and its partials. They take no field geometry, so a team body of
// the general-field chain can call them at (mlat, mlon) (ROADMAP B4).
template <typename T>
struct NeHead {
  T ni, ni_r;
  // the effective plasmapause (the env's own without `mlt`) and its
  // phi-slopes; log of the effective ne at lppi for the smoothed blend
  T lppi_e, lppo_e, ne_lppi_e, trough_e, dlppi, dlppo, dg1i, dtrough, ln_nl;
};

template <typename T>
struct NeLTerms {
  T L, L_r, L_lat;
  T g1, ne1, dne1, Ls, inv_Ls, f45, e3;  // CA1992
  T w_r, one_m_w, dw;                    // the trough refill's weight
  T dln_m, ln_ps, Lsg, f45g, e3g;        // GCPM
  T duct_g, duct_dg;                     // the duct and its d/dL
  T de, de_r;                            // diffusive equilibrium
};

template <typename T>
__device__ __forceinline__ NeHead<T> ne_head(T r, T phi, bool mlt,
                                             const KParams<T>& p) {
  NeHead<T> h;
  const T dr0 = r - p.iono_r0;
  h.ni = p.iono_n0 * d_exp(-p.iono_decay * dr0);
  h.ni_r = -p.iono_decay * h.ni;
  if (p.iono_mix_on) {  // day/night blend of two fits
    const T nb = p.iono_n0_b * d_exp(-p.iono_decay_b * dr0);
    h.ni = p.iono_mix * h.ni + p.one_m_mix * nb;
    h.ni_r = p.iono_mix * h.ni_r + p.one_m_mix * (-p.iono_decay_b * nb);
  }
  h.lppi_e = p.lppi;
  h.lppo_e = p.lppo;
  h.ne_lppi_e = p.ne_lppi;
  h.trough_e = p.ps_trough;
  h.dlppi = h.dlppo = h.dg1i = h.dtrough = T(0);
  h.ln_nl = p.ln_ne_lppi;
  if (!p.ps_on || !mlt) return h;
  // the knee and trough move with MLT
  T shape, dshape;
  mlt_shape(phi, p, shape, dshape, h.trough_e, h.dtrough);
  if (p.gcpm_on) {
    h.lppo_e = p.lppo * shape;
    h.dlppo = p.lppo * dshape;
  } else {  // CA1992 at the MLT-resolved parameters
    h.lppi_e = p.lppi * shape;
    h.dlppi = p.lppi * dshape;
    const T e_i = d_exp((T(2) - h.lppi_e) * recip(T(1.5)));
    const T g1i = (T(-0.3145) * h.lppi_e + T(3.9043)) + p.ps_season * e_i;
    h.dg1i = (T(-0.3145) - p.ps_season * e_i * recip(T(1.5))) * h.dlppi;
    h.ne_lppi_e = d_exp(T(kLN10) * g1i);
    h.lppo_e = h.lppi_e + T(0.1) * (g1i - p.ps_mlt_c3);
    h.dlppo = h.dlppi + T(0.1) * h.dg1i;
    if (p.smooth_on) h.ln_nl = d_log(h.ne_lppi_e);
  }
  return h;
}

template <typename T>
__device__ __forceinline__ NeLTerms<T> ne_lterms(T r, T sl, T cl,
                                                 const KParams<T>& p) {
  NeLTerms<T> b{};
  if (!p.ps_on) return b;
  const LShell<T> s = l_shell(r, cl);
  const T L = s.L;
  b.L = L;
  b.L_r = s.L_r;
  b.L_lat = T(2) * L * sl * s.inv_cl;
  if (p.gcpm_on) {
    // simplified GCPM: the log-space value's L part and the direct d/dlat
    // at fixed L (the mirror ratio)
    const T q2g = T(1) + T(3) * sl * sl;
    const T ln_m = T(0.5) * d_log(q2g) - T(6) * d_log(cl);
    b.dln_m = T(3) * sl * cl / q2g + T(6) * sl / cl;
    b.ln_ps =
        (p.ln_gcpm_ne0 - (L - T(2)) * p.inv_lscale) + p.gcpm_bpow * ln_m;
    b.Lsg = jmax(L, T(1.0e-6));
    b.f45g = d_exp(T(-4.5) * d_log(b.Lsg));
    b.e3g = d_exp((T(2) - L) * recip(T(10)));
  } else {
    const T e1 = d_exp((T(2) - L) * recip(T(1.5)));
    b.g1 = (T(-0.3145) * L + T(3.9043)) + p.ps_season * e1;
    b.ne1 = d_exp(T(kLN10) * b.g1);
    b.dne1 =
        T(kLN10) * b.ne1 * (T(-0.3145) - p.ps_season * e1 * recip(T(1.5)));
    b.Ls = jmax(L, T(1.0e-6));
    b.inv_Ls = T(1) / b.Ls;
    const T inv_Ls2 = b.inv_Ls * b.inv_Ls;
    b.f45 = (inv_Ls2 * inv_Ls2) * d_rsqrt(b.Ls);
    b.e3 = d_exp((T(2) - L) * T(0.1));
    if (p.refill_on) {
      b.w_r = p.ps_refill;
      b.one_m_w = p.one_m_refill;
      b.dw = T(0);
      if (p.refill_q_on) {  // per-L weight (plasmasphere.refill_weight)
        const T e_r = d_exp(p.ps_refill_q * (p.ln_lref - d_log(b.Ls)));
        const T keep = d_exp(e_r * p.ln_keep);
        b.w_r = T(1) - keep;
        b.one_m_w = T(1) - b.w_r;
        b.dw = keep * p.ln_keep * p.ps_refill_q * e_r / b.Ls;
      }
    }
  }
  if (p.duct_on) {  // Gaussian duct: value and d/dL together
    const T x = (L - p.duct_l0) * p.inv_duct_w;
    const T e = d_exp(T(-0.5) * x * x);
    b.duct_g = T(1) + p.duct_amp * e;
    b.duct_dg = p.duct_slope * x * e;
  }
  b.de = T(1);
  b.de_r = T(0);
  if (p.de_on) de_factor(r, b.de, b.de_r);
  return b;
}

template <typename T>
__device__ __forceinline__ void ne_tail(const NeHead<T>& h,
                                        const NeLTerms<T>& b, bool mlt,
                                        const KParams<T>& p, T& ne, T& ne_r,
                                        T& ne_lat, T& ne_phi) {
  ne_phi = T(0);
  if (!p.ps_on) {
    ne = T(1.0e6) * h.ni;
    ne_r = T(1.0e6) * h.ni_r;
    ne_lat = T(0);
    return;
  }
  const T L = b.L;
  T ne_p, dne_p, ne_p_phi = T(0), lat_direct = T(0);
  if (p.gcpm_on) {
    // simplified GCPM: log-space value, d/dL and the direct d/dlat
    const T p3g = h.trough_e * b.f45g;
    const T ne3g = p3g + (T(1) - b.e3g);
    const T ln_tr = d_log(ne3g);
    const T dln_tr = (T(-4.5) * p3g / b.Lsg + b.e3g * recip(T(10))) / ne3g;
    const T wk = T(1) / (T(1) + d_exp(-(h.lppo_e - L) * p.inv_knee));
    const T dwk = -wk * (T(1) - wk) * p.inv_knee;
    ne_p = d_exp(wk * b.ln_ps + (T(1) - wk) * ln_tr);
    dne_p = ne_p * (dwk * (b.ln_ps - ln_tr) - wk * p.inv_lscale +
                    (T(1) - wk) * dln_tr);
    lat_direct = ne_p * wk * p.gcpm_bpow * b.dln_m;
    if (mlt) {
      const T dwk_phi = wk * (T(1) - wk) * p.inv_knee * h.dlppo;
      const T dln_tr_phi = h.dtrough * b.f45g / ne3g;
      ne_p_phi =
          ne_p * (dwk_phi * (b.ln_ps - ln_tr) + (T(1) - wk) * dln_tr_phi);
    }
  } else {
    // CA1992 at the effective (MLT-resolved) or the env parameters
    const T ne2 =
        h.ne_lppi_e * d_exp(T(kLN10) * (h.lppi_e - L) * recip(T(0.1)));
    const T dne2 = T(-(kLN10 / 0.1)) * ne2;
    const T p3 = h.trough_e * b.f45;
    T ne3 = p3 + (T(1) - b.e3);
    T dne3 = T(-4.5) * p3 * b.inv_Ls + b.e3 * T(0.1);
    T dln2_phi = T(0), dne2_phi = T(0), dne3_phi = T(0);
    if (mlt) {
      dln2_phi = T(kLN10) * (h.dg1i + h.dlppi * recip(T(0.1)));
      dne2_phi = ne2 * dln2_phi;
      dne3_phi = h.dtrough * b.f45;
    }
    if (p.refill_on) {  // log-space trough refill toward branch 1
      const T ln3 = d_log(ne3);
      const T ln1 = T(kLN10) * b.g1;
      const T ln3_eff = b.one_m_w * ln3 + b.w_r * ln1;
      T dln3_eff = b.one_m_w * (dne3 / ne3) + b.w_r * (b.dne1 / b.ne1);
      if (p.refill_q_on) dln3_eff = dln3_eff + b.dw * (ln1 - ln3);
      const T ne3_eff = d_exp(ln3_eff);
      if (mlt) dne3_phi = ne3_eff * b.one_m_w * (dne3_phi / ne3);
      ne3 = ne3_eff;
      dne3 = ne3 * dln3_eff;
    }
    if (p.smooth_on) {
      // log-space sigmoid blends; ln2 analytically (ne2 may underflow)
      const T inv_w = p.inv_smooth;
      const T s1 = T(1) / (T(1) + d_exp(-(h.lppi_e - L) * inv_w));
      const T s2 = T(1) / (T(1) + d_exp(-(h.lppo_e - L) * inv_w));
      const T ds1 = -s1 * (T(1) - s1) * inv_w;
      const T ds2 = -s2 * (T(1) - s2) * inv_w;
      const T ln1 = T(kLN10) * b.g1;
      const T dln1 = b.dne1 / b.ne1;
      const T ln2 = h.ln_nl + T(kLN10) * (h.lppi_e - L) * recip(T(0.1));
      const T dln2 = T(-(kLN10 / 0.1));
      const T ln3 = d_log(ne3);
      const T dln3 = dne3 / ne3;
      const T inner = s2 * ln2 + (T(1) - s2) * ln3;
      const T dinner = ds2 * (ln2 - ln3) + s2 * dln2 + (T(1) - s2) * dln3;
      const T lns = s1 * ln1 + (T(1) - s1) * inner;
      ne_p = d_exp(lns);
      dne_p = ne_p * (ds1 * (ln1 - inner) + s1 * dln1 + (T(1) - s1) * dinner);
      if (mlt) {
        const T ds1_phi = -ds1 * h.dlppi;
        const T ds2_phi = -ds2 * h.dlppo;
        const T dln3_phi = dne3_phi / ne3;
        const T dinner_phi = ds2_phi * (ln2 - ln3) + s2 * dln2_phi +
                             (T(1) - s2) * dln3_phi;
        ne_p_phi = ne_p * (ds1_phi * (ln1 - inner) + (T(1) - s1) * dinner_phi);
      }
    } else {
      // hard branches with <= at the effective boundaries; the d/dphi of
      // branch 1 is exactly 0
      const bool in1 = L <= h.lppi_e;
      const bool in2 = L <= h.lppo_e;
      ne_p = in1 ? b.ne1 : (in2 ? ne2 : ne3);
      dne_p = in1 ? b.dne1 : (in2 ? dne2 : dne3);
      if (mlt) ne_p_phi = in1 ? T(0) : (in2 ? dne2_phi : dne3_phi);
    }
  }

  if (p.duct_on) {
    dne_p = dne_p * b.duct_g + ne_p * b.duct_dg;
    ne_p = ne_p * b.duct_g;
    lat_direct = lat_direct * b.duct_g;
    ne_p_phi = ne_p_phi * b.duct_g;
  }
  T lat_term = dne_p * b.L_lat;
  if (p.gcpm_on) lat_term = lat_term + lat_direct;
  ne = T(1.0e6) * (h.ni + ne_p * b.de);
  ne_r = T(1.0e6) * (h.ni_r + (dne_p * b.L_r * b.de + ne_p * b.de_r));
  ne_lat = (T(1.0e6) * b.de) * lat_term;
  if (mlt) ne_phi = (T(1.0e6) * b.de) * ne_p_phi;
}

// ops/fused.py::_stix_quartic_grads: mu and its partials w.r.t. (ne, |B|,
// f, geometry), over the protons alone (stix_field, then stix_protons) or,
// with IONS, over the p.n_ion species of p.ion_fpe2/p.ion_fce; the
// geometry variable is psi (2D) or, with WRT_COS, cos(psi) (3D).
//
// The terms of the field alone, electrons and protons: 1/f, y = fc/f,
// a = 1/(1 +- y), b = 1/(1 -+ y), 1/|B|
template <typename T>
struct StixField {
  T inv_f, ye, ae, be, yi, ai, bi, inv_bm;
};

template <typename T>
__device__ __forceinline__ StixField<T> stix_field(T bm, T f) {
  StixField<T> s;
  s.inv_f = T(1) / f;
  s.ye = T(kFCE_E) * bm * s.inv_f;
  const T inv_de = T(1) / (T(1) - s.ye * s.ye);
  s.ae = (T(1) + s.ye) * inv_de;
  s.be = (T(1) - s.ye) * inv_de;
  s.yi = T(kFCE_P) * bm * s.inv_f;
  const T inv_di = T(1) / (T(1) - s.yi * s.yi);
  s.ai = (T(1) - s.yi) * inv_di;
  s.bi = (T(1) + s.yi) * inv_di;
  s.inv_bm = T(1) / bm;
  return s;
}

// the quartic from the electrons' terms and the species sums in species
// order, Sa = sum x a, Say = sum x a^2 y (ditto b) with a = 1/(1 + y),
// b = 1/(1 - y)
template <typename T, bool WRT_COS>
__device__ __forceinline__ void stix_quartic(T ne, T xe, T ye, T ae, T be,
                                             T Sa, T Sb, T Say, T Sby, T Sx,
                                             T inv_f, T inv_bm, T sinpsi,
                                             T cospsi, const KParams<T>& p,
                                             T& mu, T& dmu_dn, T& dmu_db,
                                             T& dmu_df, T& dmu_dpsi) {
  const T root = p.root;
  const T R = T(1) - xe * ae - Sa;
  const T L = T(1) - xe * be - Sb;
  const T P = T(1) - xe - Sx;
  const T inv_ne = T(1) / ne;
  const T R_n = -(xe * ae + Sa) * inv_ne;
  const T L_n = -(xe * be + Sb) * inv_ne;
  const T P_n = -(xe + Sx) * inv_ne;
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
  const T geo = WRT_COS ? -cospsi : sinpsi * cospsi;
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

// over the protons alone, from the field's terms
template <typename T, bool WRT_COS>
__device__ __forceinline__ void stix_protons(T ne, const StixField<T>& s,
                                             T sinpsi, T cospsi,
                                             const KParams<T>& p, T& mu,
                                             T& dmu_dn, T& dmu_db, T& dmu_df,
                                             T& dmu_dpsi) {
  const T ncm = ne * T(1.0e-6);
  const T xe = T(kFPE2_E) * ncm * s.inv_f * s.inv_f;
  const T xi = T(kFPE2_P) * ncm * s.inv_f * s.inv_f;
  stix_quartic<T, WRT_COS>(ne, xe, s.ye, s.ae, s.be, xi * s.ai, xi * s.bi,
                           xi * s.ai * s.ai * s.yi, xi * s.bi * s.bi * s.yi,
                           xi, s.inv_f, s.inv_bm, sinpsi, cospsi, p, mu,
                           dmu_dn, dmu_db, dmu_df, dmu_dpsi);
}

template <typename T, bool WRT_COS, bool IONS>
__device__ __forceinline__ void stix_quartic_grads(T ne, T bm, T f, T sinpsi,
                                                   T cospsi,
                                                   const KParams<T>& p, T& mu,
                                                   T& dmu_dn, T& dmu_db,
                                                   T& dmu_df, T& dmu_dpsi) {
  if constexpr (!IONS) {
    stix_protons<T, WRT_COS>(ne, stix_field(bm, f), sinpsi, cospsi, p, mu,
                             dmu_dn, dmu_db, dmu_df, dmu_dpsi);
  } else {
    const T inv_f = T(1) / f;
    const T ncm = ne * T(1.0e-6);
    const T xe = T(kFPE2_E) * ncm * inv_f * inv_f;
    const T ye = T(kFCE_E) * bm * inv_f;
    const T inv_de = T(1) / (T(1) - ye * ye);
    const T ae = (T(1) + ye) * inv_de;
    const T be = (T(1) - ye) * inv_de;
    // the protons start each sum
    T Sa = T(0), Sb = T(0), Say = T(0), Sby = T(0), Sx = T(0);
#pragma unroll
    for (int k = 0; k < kMaxIon; ++k) {
      if (k >= p.n_ion) break;
      const T xi = p.ion_fpe2[k] * ncm * inv_f * inv_f;
      const T yi = p.ion_fce[k] * bm * inv_f;
      const T inv_di = T(1) / (T(1) - yi * yi);
      const T ai = (T(1) - yi) * inv_di;
      const T bi = (T(1) + yi) * inv_di;
      if (k == 0) {
        Sa = xi * ai;
        Sb = xi * bi;
        Say = xi * ai * ai * yi;
        Sby = xi * bi * bi * yi;
        Sx = xi;
      } else {
        Sa = Sa + xi * ai;
        Sb = Sb + xi * bi;
        Say = Say + xi * ai * ai * yi;
        Sby = Sby + xi * bi * bi * yi;
        Sx = Sx + xi;
      }
    }
    stix_quartic<T, WRT_COS>(ne, xe, ye, ae, be, Sa, Sb, Say, Sby, Sx, inv_f,
                             T(1) / bm, sinpsi, cospsi, p, mu, dmu_dn, dmu_db,
                             dmu_df, dmu_dpsi);
  }
}

// One ray's team in the team body: the same lane in each of the K warps
// of a block. Warp 0 holds the ray's carry and runs the attempt; the other
// K - 1 warps (the helpers) compute the pieces of each right-hand side.
// For a right-hand side warp 0 writes its input (the stage's state and
// whether the ray is live) to `xch`, the block's exchange in shared memory
// laid out [slot][lane], and meets the helpers at a barrier; each helper
// computes its pieces for the live rays, writes them, and meets warp 0 at
// a second barrier; warp 0 reads them and runs the rest. The inputs and
// the pieces have slots of their own, and every write of one is separated
// from the reads of the last by a barrier, so one buffer serves.
template <typename T>
struct Team {
  T* xch;
  int warp, lane;
  bool live;  // warp 0: its ray is ACTIVE in this attempt
};

template <typename S, typename T>
__host__ __device__ constexpr int n_slots() {
  static_assert(sizeof(S) % sizeof(T) == 0, "a piece is a struct of T");
  return int(sizeof(S) / sizeof(T));
}

template <typename T, typename S>
__device__ __forceinline__ void put(T* x, int lane, int slot, const S& s) {
  const T* v = reinterpret_cast<const T*>(&s);
#pragma unroll
  for (int k = 0; k < n_slots<S, T>(); ++k) x[(slot + k) * 32 + lane] = v[k];
}

template <typename S, typename T>
__device__ __forceinline__ S get(const T* x, int lane, int slot) {
  S s;
  T* v = reinterpret_cast<T*>(&s);
#pragma unroll
  for (int k = 0; k < n_slots<S, T>(); ++k) v[k] = x[(slot + k) * 32 + lane];
  return s;
}

// the helper that computes piece `role` (roles 0-2 over the K - 1 helpers)
template <int K, typename T>
__device__ __forceinline__ bool serves(const Team<T>& tm, int role) {
  return tm.warp == 1 + role % (K - 1);
}

// warp 0's side of an exchange: post the input (team_post), then, after
// any piece of its own, wait for the helpers' pieces (team_wait)
template <typename T, int N_IN>
__device__ __forceinline__ void team_post(const Team<T>& tm,
                                          const T (&in)[N_IN]) {
#pragma unroll
  for (int k = 0; k < N_IN; ++k) tm.xch[k * 32 + tm.lane] = in[k];
  tm.xch[N_IN * 32 + tm.lane] = tm.live ? T(1) : T(0);
  __syncthreads();  // the helpers take the input
}

__device__ __forceinline__ void team_wait() {
  __syncthreads();  // the pieces are in
}

// |B| of the dipole at (r, sin lat), with sqrt(1 + 3 sin^2) and 1/r
template <typename T>
struct Bmag {
  T q, inv_r, bm;
};

template <typename T>
__device__ __forceinline__ Bmag<T> dipole_bm(T r, T sl, const KParams<T>& p) {
  Bmag<T> b;
  const T q2 = T(1) + T(3) * sl * sl;
  b.q = d_sqrt(q2);
  b.inv_r = T(1) / r;
  const T inv_r3 = b.inv_r * b.inv_r * b.inv_r;
  b.bm = p.b0 * b.q * inv_r3;
  return b;
}

// The reference gradient set of the ALT instances (ops/gradients.py,
// grad_mode="reference"; ops/analytic.py), operation for operation as the
// plain version computes it on the card.

// ops/analytic.py::mu_and_dmudpsi's dmu/dpsi (root 1, as the reference
// calls it), the reference's formula as written (the extra factor 2 on
// the dA term, no abs() guard), over dispersion.stix_rlp's protons
template <typename T>
__device__ __forceinline__ T ref_dmudpsi(T ne, T bm, T f, T psi) {
  const T n_cm3 = ne * T(1.0e-6);
  const T f2 = f * f;
  const T xe = T(kFPE2_E) * n_cm3 / f2;
  const T ye = T(kFCE_E) * bm / f;
  T R = T(1) - xe / (T(1) - ye);
  T L = T(1) - xe / (T(1) + ye);
  T P = T(1) - xe;
  const T xi = T(kFPE2_P) * n_cm3 / f2;
  const T yi = T(kFCE_P) * bm / f;
  R = R - xi / (T(1) + yi);
  L = L - xi / (T(1) - yi);
  P = P - xi;
  const T s = jmax(jmax(d_abs(R), d_abs(L)), d_abs(P));
  const T rn = R / s, ln = L / s, pn = P / s;
  const T dn = T(0.5) * (rn - ln);
  const T sn = T(0.5) * (rn + ln);
  const T sinpsi = d_sin(psi), cospsi = d_cos(psi);
  const T sin2 = sinpsi * sinpsi, cos2 = cospsi * cospsi;
  const T a = sn * sin2 + pn * cos2;
  const T b = rn * ln * sin2 + pn * sn * (T(1) + cos2);
  const T rl_ps = rn * ln - pn * sn;
  const T pdc = pn * dn * cospsi;
  const T fd = d_sqrt(rl_ps * rl_ps * sin2 * sin2 + T(4) * (pdc * pdc));
  const T mu2n = (b + fd) / (T(2) * a);
  const T mun = d_sqrt(d_abs(mu2n));
  const T dadpsi = T(2) * (sn - pn) * sinpsi * cospsi;
  const T dbdpsi = T(2) * (rn * ln - pn * sn) * sinpsi * cospsi;
  const T pd = pn * dn;
  const T dfdpsi = T(1) / (T(2) * fd) *
                   (rl_ps * rl_ps * T(4) * sin2 * sinpsi * cospsi -
                    T(8) * (pd * pd) * sinpsi * cospsi);
  const T dmudpsi_n =
      T(1) / (T(2) * mun) *
      ((dbdpsi + dfdpsi) / (T(2) * a) -
       T(2) * dadpsi * (b + fd) / (T(2) * a * a));
  return d_sqrt(s) * dmudpsi_n;
}

// ops/fused.py::mu_and_grads_2d_lat: mu and its partials r, lat, psi, f
// at (r, lat, chi), with 1/r and the sine and cosine of chi that the rows
// of the 2D frames reuse (the 2D frames trace the phi = 0 meridian: never
// the MLT path)
template <typename T>
struct Mu2D {
  T mu, dmudr, dmudlat, dmu_dpsi, dmu_df, inv_r, sc, cc;
};

template <typename T, int MEDIUM>
__device__ __forceinline__ Mu2D<T> mu_grads_2d(T r, T lat, T chi, T f,
                                               const KParams<T>& p) {
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
  if constexpr (full_density(MEDIUM)) {
    T ne_phi;
    ne_and_grads_full<T, wide(MEDIUM)>(r, sl, cl, T(0), false, p, ne, ne_r,
                                       ne_lat, ne_phi);
  } else {
    ne_and_grads(r, sl, cl, p, ne, ne_r, ne_lat);
  }
  Mu2D<T> m;
  T dmu_dn, dmu_db;
  stix_quartic_grads<T, false, extended(MEDIUM)>(
      ne, bm, f, sinpsi, cospsi, p, m.mu, dmu_dn, dmu_db, m.dmu_df,
      m.dmu_dpsi);
  m.dmudr = dmu_dn * ne_r + dmu_db * bm_r;
  m.dmudlat = dmu_dn * ne_lat + dmu_db * bm_lat + m.dmu_dpsi * dpsi_dlat;
  if constexpr (ref_modes(MEDIUM)) {
    // the reference set (ops/gradients.py): dmu/dlat keeps the fused
    // chain's value; dmu/dpsi from the closed form over the fused chain's
    // density and |B| at psi = pi/2 + atan(2 tan lat) + chi
    // (dispersion.psi_lat), dmu/dr = 0. The 2D chain's density is the
    // phi = 0 meridian's, the medium's base parameters: what the JAX
    // package's closed form reads (medium.ne_total_m3 without phi)
    if (p.ref_grads) {
      const T psi = (T(kPi / 2.0) + d_atan(T(2) * d_tan(lat))) + chi;
      m.dmu_dpsi = ref_dmudpsi(ne, bm, f, psi);
      m.dmudr = T(0);
    }
  }
  m.inv_r = inv_r;
  m.sc = sc;
  m.cc = cc;
  return m;
}

// ops/rhs.py::rhs_2d_lat over the 2D chain
template <typename T, int MEDIUM>
__device__ __forceinline__ void rhs_2d_lat(const T u[4], T f,
                                           const KParams<T>& p, T out[4]) {
  const T r = u[0];
  const Mu2D<T> m = mu_grads_2d<T, MEDIUM>(r, u[1], u[2], f, p);
  const T inv_mu2 = T(1) / (m.mu * m.mu);
  const T inv_mu2_r = inv_mu2 * m.inv_r;
  out[0] = inv_mu2 * (m.mu * m.cc + m.dmu_dpsi * m.sc);
  out[1] = inv_mu2_r * (m.mu * m.sc - m.dmu_dpsi * m.cc);
  out[2] = inv_mu2_r * (m.dmudlat * m.cc - (r * m.dmudr + m.mu) * m.sc);
  out[3] = T(kREOverC) * (T(1) + (f * m.mu * inv_mu2) * m.dmu_df);
}

// ops/rhs.py::rhs_2d_colat: the 2D chain at lat = pi/2 - theta
// (ops/gradients.py::mu_grads_2d_colat, dmu/dtheta = -dmu/dlat); the signs
// of the r and theta rows flip against the latitude frame's
template <typename T, int MEDIUM>
__device__ __forceinline__ void rhs_2d_colat(const T u[4], T f,
                                             const KParams<T>& p, T out[4]) {
  const T r = u[0];
  const Mu2D<T> m =
      mu_grads_2d<T, MEDIUM>(r, T(kPi / 2.0) - u[1], u[2], f, p);
  const T dmudtheta = -m.dmudlat;
  const T inv_mu2 = T(1) / (m.mu * m.mu);
  const T inv_mu2_r = inv_mu2 * m.inv_r;
  out[0] = inv_mu2 * (m.mu * m.cc - m.dmu_dpsi * m.sc);
  out[1] = inv_mu2_r * (m.mu * m.sc + m.dmu_dpsi * m.cc);
  out[2] = inv_mu2_r * (dmudtheta * m.cc - (r * m.dmudr + m.mu) * m.sc);
  out[3] = T(kREOverC) * (T(1) + (f * m.mu * inv_mu2) * m.dmu_df);
}

// the colatitude's sine and cosine, 1/r and 1/sin(theta) of the Kimura rows
template <typename T>
struct KimTrig {
  T st, ct, inv_r, inv_st;
};

template <typename T>
__device__ __forceinline__ KimTrig<T> kim_trig(const T u[7]) {
  KimTrig<T> k;
  k.st = d_sin(u[1]);
  k.ct = d_cos(u[1]);
  k.inv_r = T(1) / u[0];
  k.inv_st = T(1) / k.st;
  return k;
}

// ops/rhs.py::rhs_3d below its gradient layer: the seven Haselgrove rows
// of the Kimura frame from mu and its seven partials
template <typename T>
__device__ __forceinline__ void kimura_rows(const T u[7], T f, T mu, T dmudr,
                                            T dmudtheta, T dmudphi, T dmudrr,
                                            T dmudrt, T dmudrp, T dmu_df,
                                            const KimTrig<T>& k, T out[7]) {
  const T r = u[0];
  const T rho_r = u[3], rho_t = u[4], rho_p = u[5];
  const T sintheta = k.st, costheta = k.ct;
  const T inv_mu2 = T(1) / (mu * mu);
  const T inv_mu = mu * inv_mu2;
  const T inv_r = k.inv_r;
  const T inv_st = k.inv_st;
  const T inv_mu2_r = inv_mu2 * inv_r;
  const T dr = inv_mu2 * (rho_r - mu * dmudrr);
  const T dtheta = inv_mu2_r * (rho_t - mu * dmudrt);
  const T dphi = inv_mu2_r * inv_st * (rho_p - mu * dmudrp);
  out[0] = dr;
  out[1] = dtheta;
  out[2] = dphi;
  out[3] = dmudr * inv_mu + rho_t * dtheta + rho_p * dphi * sintheta;
  out[4] = (dmudtheta * inv_mu - rho_t * dr + r * rho_p * dphi * costheta) *
           inv_r;
  out[5] = (dmudphi * inv_mu - rho_p * dr * sintheta -
            r * rho_p * dtheta * costheta) *
           (inv_r * inv_st);
  out[6] = T(kREOverC) * (T(1) + (f * inv_mu) * dmu_df);
}

// the 3D chain's dipole geometry and the psi cosines (cos form) at (r,
// lat, rho)
template <typename T>
struct Geo3D {
  T bm, bm_r, bm_lat, bhat_r, bhat_t, sinpsi, cospsi, dcos_dtheta,
      dcos_drho_r, dcos_drho_t, dcos_drho_p;
};

template <typename T>
__device__ __forceinline__ Geo3D<T> geo_3d(T r, T sl, T cl, T rho_r, T rho_t,
                                           T rho_p, const KParams<T>& p) {
  Geo3D<T> g;
  const Bmag<T> b = dipole_bm(r, sl, p);
  const T inv_q = T(1) / b.q;
  const T inv_q2 = inv_q * inv_q;
  const T inv_q3 = inv_q2 * inv_q;
  g.bm = b.bm;
  g.bm_r = T(-3) * b.bm * b.inv_r;
  g.bm_lat = T(3) * sl * cl * b.bm * inv_q2;
  const T bhat_r = T(-2) * sl * inv_q;
  const T bhat_t = -cl * inv_q;
  g.bhat_r = bhat_r;
  g.bhat_t = bhat_t;
  const T dbhat_r_dlat = T(-2) * cl * inv_q3;
  const T dbhat_t_dlat = T(4) * sl * inv_q3;

  const T inv_rmag = d_rsqrt(rho_r * rho_r + rho_t * rho_t + rho_p * rho_p);
  const T rhat_r = rho_r * inv_rmag;
  const T rhat_t = rho_t * inv_rmag;
  const T rhat_p = rho_p * inv_rmag;
  g.cospsi = jmin(jmax(bhat_r * rhat_r + bhat_t * rhat_t, T(-1)), T(1));
  const T cr_m = bhat_r * rhat_t - bhat_t * rhat_r;
  g.sinpsi = d_sqrt(rhat_p * rhat_p + cr_m * cr_m);
  const T dcos_dlat = rhat_r * dbhat_r_dlat + rhat_t * dbhat_t_dlat;
  g.dcos_dtheta = -dcos_dlat;
  g.dcos_drho_r = (bhat_r - g.cospsi * rhat_r) * inv_rmag;
  g.dcos_drho_t = (bhat_t - g.cospsi * rhat_t) * inv_rmag;
  g.dcos_drho_p = (T(0) - g.cospsi * rhat_p) * inv_rmag;
  return g;
}

// the 3D chain's last link: the partials and the Kimura rows from mu and
// its partials w.r.t. (ne, |B|, f, cos psi); over the MLT-resolved medium
// dmu/dphi = dmu_dn * d ne/dphi
template <typename T, int MEDIUM>
__device__ __forceinline__ void rhs_3d_rows(const T u[7], T f,
                                            const KParams<T>& p,
                                            const Geo3D<T>& g,
                                            const KimTrig<T>& k, T ne_r,
                                            T ne_lat, T ne_phi, T mu,
                                            T dmu_dn, T dmu_db, T dmu_df,
                                            T dmu_dc, T out[7]) {
  const T dmudr = dmu_dn * ne_r + dmu_db * g.bm_r;
  const T dmudtheta =
      -(dmu_dn * ne_lat + dmu_db * g.bm_lat) + dmu_dc * g.dcos_dtheta;
  // exactly 0 over an axisymmetric medium
  T dmudphi = T(0);
  if constexpr (full_density(MEDIUM)) {
    if (p.mlt_on) dmudphi = dmu_dn * ne_phi;
  }
  kimura_rows(u, f, mu, dmudr, dmudtheta, dmudphi, dmu_dc * g.dcos_drho_r,
              dmu_dc * g.dcos_drho_t, dmu_dc * g.dcos_drho_p, dmu_df, k, out);
}

// ops/gradients.py::_mu_grads_3d_reference below the fused chain's mu and
// its theta, phi and f partials (dmudphi: 0 over the axisymmetric medium,
// dmu_dn * d ne/dphi over the MLT-resolved one): dmu/dr = 0, and the rho
// partials from ops/analytic.py::kimura_dmudrho over the closed-form
// dmu/dpsi at psi = acos(cos psi), all over the fused chain's |B|, cos psi
// and field direction (kimura_dmudrho takes the unit vector; its
// cos(alpha_Bk) is scale-free) and over ne, the density without longitude
// (the fused chain's own but over the MLT-resolved medium: rhs_3d)
template <typename T>
__device__ __forceinline__ void rhs_3d_ref(const T u[7], T f,
                                           const Geo3D<T>& g, T ne, T ne_lat,
                                           T mu, T dmu_dn, T dmu_db, T dmu_df,
                                           T dmu_dc, T dmudphi, T out[7]) {
  const T rho[3] = {u[3], u[4], u[5]};
  const T bv[3] = {g.bhat_r, g.bhat_t, T(0)};
  const T bmag = d_sqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
  const T psi = d_acos(g.cospsi);
  const T dmudpsi = ref_dmudpsi(ne, g.bm, f, psi);
  T kim[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T cos_alpha = bv[k] * tsign(rho[k]) / bmag;
    kim[k] = dmudpsi * (rho[k] * d_cos(psi) - mu * cos_alpha) /
             (mu * mu * d_sin(psi));
  }
  const T dmudtheta =
      -(dmu_dn * ne_lat + dmu_db * g.bm_lat) + dmu_dc * g.dcos_dtheta;
  kimura_rows(u, f, mu, T(0), dmudtheta, dmudphi, kim[0], kim[1], kim[2],
              dmu_df, kim_trig(u), out);
}

// ops/rhs.py::rhs_3d over ops/fused.py::mu_and_grads_3d (cos form)
template <typename T, int MEDIUM>
__device__ __forceinline__ void rhs_3d(const T u[7], T f, const KParams<T>& p,
                                       T out[7]) {
  const T r = u[0];
  const T lat = T(kPi / 2.0) - u[1];
  const T sl = d_sin(lat), cl = d_cos(lat);
  const Geo3D<T> g = geo_3d(r, sl, cl, u[3], u[4], u[5], p);
  T ne, ne_r, ne_lat, ne_phi = T(0);
  if constexpr (full_density(MEDIUM))
    ne_and_grads_full<T, wide(MEDIUM)>(r, sl, cl, u[2], p.mlt_on, p, ne,
                                       ne_r, ne_lat, ne_phi);
  else
    ne_and_grads(r, sl, cl, p, ne, ne_r, ne_lat);
  T mu, dmu_dn, dmu_db, dmu_df, dmu_dc;
  stix_quartic_grads<T, true, extended(MEDIUM)>(ne, g.bm, f, g.sinpsi,
                                                g.cospsi, p, mu, dmu_dn,
                                                dmu_db, dmu_df, dmu_dc);
  if constexpr (MEDIUM == ALT) {
    if (p.ref_grads) {
      rhs_3d_ref(u, f, g, ne, ne_lat, mu, dmu_dn, dmu_db, dmu_df, dmu_dc,
                 T(0), out);
      return;
    }
  } else if constexpr (MEDIUM == ALTX || MEDIUM == ANY) {
    if (p.ref_grads) {
      // the closed form reads the density without longitude (the JAX
      // package's gradients.py:161-169 calls medium.ne_total_m3 without
      // phi): over the MLT-resolved medium the chain again at the base
      // parameters; dmu/dphi keeps the fused chain's value
      T ne_ref = ne, dmudphi = T(0);
      if (p.mlt_on) {
        T d_r, d_lat, d_phi;
        ne_and_grads_full<T, wide(MEDIUM)>(r, sl, cl, u[2], false, p, ne_ref,
                                           d_r, d_lat, d_phi);
        dmudphi = dmu_dn * ne_phi;
      }
      rhs_3d_ref(u, f, g, ne_ref, ne_lat, mu, dmu_dn, dmu_db, dmu_df, dmu_dc,
                 dmudphi, out);
      return;
    }
  }
  rhs_3d_rows<T, MEDIUM>(u, f, p, g, kim_trig(u), ne_r, ne_lat, ne_phi, mu,
                         dmu_dn, dmu_db, dmu_df, dmu_dc, out);
}

// the same over the full medium in the team body. Input: r, theta, phi
// and rho; pieces, each helper forming sin and cos of lat: the geometry,
// the psi cosines and the Stix terms of the field; the ionosphere and the
// MLT-resolved plasmapause at phi; the density's terms in L and the Kimura
// rows' trigonometry. Warp 0 then forms the density's tail, the quartic
// and the rows.
constexpr int kIn3D = 6;

template <typename T>
struct Slots3D {
  static constexpr int G = kIn3D + 1, S = G + n_slots<Geo3D<T>, T>(),
                       H = S + n_slots<StixField<T>, T>(),
                       B = H + n_slots<NeHead<T>, T>(),
                       K = B + n_slots<NeLTerms<T>, T>(),
                       end = K + n_slots<KimTrig<T>, T>();
};

template <typename T, int K>
__device__ __forceinline__ void pieces_3d(const T* x, T f,
                                          const KParams<T>& p,
                                          const Team<T>& tm, T* out) {
  using S = Slots3D<T>;
  T u[kIn3D];
#pragma unroll
  for (int k = 0; k < kIn3D; ++k) u[k] = x[k * 32 + tm.lane];
  const T r = u[0];
  const T lat = T(kPi / 2.0) - u[1];
  const T sl = d_sin(lat), cl = d_cos(lat);
  if (serves<K>(tm, 0)) {
    const Geo3D<T> g = geo_3d(r, sl, cl, u[3], u[4], u[5], p);
    put(out, tm.lane, S::G, g);
    put(out, tm.lane, S::S, stix_field(g.bm, f));
  }
  if (serves<K>(tm, 1))
    put(out, tm.lane, S::H, ne_head(r, u[2], p.mlt_on, p));
  if (serves<K>(tm, 2)) {
    put(out, tm.lane, S::B, ne_lterms(r, sl, cl, p));
    put(out, tm.lane, S::K, kim_trig(u));
  }
}

template <typename T, int K>
__device__ __forceinline__ void rhs_3d_team(const T u[7], T f,
                                            const KParams<T>& p, T out[7],
                                            const Team<T>& tm) {
  using S = Slots3D<T>;
  const T in[kIn3D] = {u[0], u[1], u[2], u[3], u[4], u[5]};
  team_post(tm, in);
  team_wait();
  if (!tm.live) return;
  const T* x = tm.xch;
  T ne, ne_r, ne_lat, ne_phi;
  ne_tail(get<NeHead<T>>(x, tm.lane, S::H), get<NeLTerms<T>>(x, tm.lane, S::B),
          p.mlt_on, p, ne, ne_r, ne_lat, ne_phi);
  const Geo3D<T> g = get<Geo3D<T>>(x, tm.lane, S::G);
  T mu, dmu_dn, dmu_db, dmu_df, dmu_dc;
  stix_protons<T, true>(ne, get<StixField<T>>(x, tm.lane, S::S), g.sinpsi,
                        g.cospsi, p, mu, dmu_dn, dmu_db, dmu_df, dmu_dc);
  rhs_3d_rows<T, FULL>(u, f, p, g, get<KimTrig<T>>(x, tm.lane, S::K), ne_r,
                       ne_lat, ne_phi, mu, dmu_dn, dmu_db, dmu_df, dmu_dc,
                       out);
}

// The geometry of a non-axial field at one point and its tangents, every
// one a scalar in a register (ops/fused.py::field_geometry): the field's
// components, the magnetic latitude and longitude of the tilted frame, and
// their d/dr (_r), d/dtheta (_t), d/dphi (_p); mlat and mlon do not depend
// on r.
template <typename T>
struct FieldGeom {
  T br, bt, bp, br_r, bt_r, bp_r, br_t, bt_t, bp_t, br_p, bt_p, bp_p;
  T mlat, mlon, mlat_t, mlon_t, mlat_p, mlon_p;
};

// models/dipole.py::_moment_components: the moment unit vector on the
// local spherical basis
template <typename T>
__device__ __forceinline__ void moment_components(T st, T ct, T sp, T cp,
                                                  const KParams<T>& p, T& m_r,
                                                  T& m_t, T& m_p) {
  m_r = p.mom[0] * st * cp + p.mom[1] * st * sp + p.mom[2] * ct;
  m_t = p.mom[0] * ct * cp + p.mom[1] * ct * sp - p.mom[2] * st;
  m_p = -p.mom[0] * sp + p.mom[1] * cp;
}

// models/dipole.py::magnetic_coords with its tangents: mlat = asin of the
// clipped sine -(m . rhat) (then sin and cos of it in the density chain,
// as the plain version does), mlon = atan2(y_m . rhat, x_m . rhat); a zero
// tangent where the clip is active
template <typename T>
__device__ __forceinline__ void magnetic_coords(T st, T ct, T sp, T cp, T m_r,
                                                T m_t, T m_p,
                                                const KParams<T>& p,
                                                FieldGeom<T>& g) {
  const T s = -m_r;
  const T sc = jmin(jmax(s, T(-1)), T(1));
  g.mlat = d_asin(sc);
  const T rx = st * cp, ry = st * sp, rz = ct;
  const T y = p.ym[0] * rx + p.ym[1] * ry + p.ym[2] * rz;
  const T x = p.xm[0] * rx + p.xm[1] * ry + p.xm[2] * rz;
  g.mlon = d_atan2(y, x);
  const bool inside = s > T(-1) && s < T(1);
  const T inv_c = T(1) / d_sqrt(T(1) - sc * sc);
  g.mlat_t = (inside ? -m_t : T(0)) * inv_c;
  g.mlat_p = (inside ? -(st * m_p) : T(0)) * inv_c;
  const T rx_t = ct * cp, ry_t = ct * sp;
  const T y_t = p.ym[0] * rx_t + p.ym[1] * ry_t - p.ym[2] * st;
  const T x_t = p.xm[0] * rx_t + p.xm[1] * ry_t - p.xm[2] * st;
  const T y_p = p.ym[1] * rx - p.ym[0] * ry;
  const T x_p = p.xm[1] * rx - p.xm[0] * ry;
  const T inv_h = T(1) / (x * x + y * y);
  g.mlon_t = (x * y_t - y * x_t) * inv_h;
  g.mlon_p = (x * y_p - y * x_p) * inv_h;
}

// models/dipole.py::tilted_field with its tangents, then magnetic_coords
// from the same moment components
template <typename T>
__device__ __forceinline__ void geometry_tilted(T r, T st, T ct, T sp, T cp,
                                                const KParams<T>& p,
                                                FieldGeom<T>& g) {
  T m_r, m_t, m_p;
  moment_components(st, ct, sp, cp, p, m_r, m_t, m_p);
  const T inv_r = T(1) / r;
  const T k = p.b0 * (inv_r * inv_r * inv_r);
  const T k2 = T(2) * k;
  g.br = k2 * m_r;
  g.bt = -k * m_t;
  g.bp = -k * m_p;
  const T m3 = T(-3) * inv_r;
  g.br_r = g.br * m3;
  g.bt_r = g.bt * m3;
  g.bp_r = g.bp * m3;
  g.br_t = k2 * m_t;
  g.bt_t = k * m_r;
  g.bp_t = T(0);
  g.br_p = k2 * (st * m_p);
  g.bt_p = -k * (ct * m_p);
  g.bp_p = k * (p.mom[0] * cp + p.mom[1] * sp);
  magnetic_coords(st, ct, sp, cp, m_r, m_t, m_p, p, g);
}

// models/dipole.py::igrf_field with its tangents (closed-form Schmidt
// P_nm, n <= 3, their first and second theta-derivatives; cubes as
// s * s * s), then magnetic_coords of the degree-1 part's tilted frame
template <typename T>
__device__ __forceinline__ void geometry_igrf(T r, T s, T c, T sp, T cp,
                                              const KParams<T>& p,
                                              FieldGeom<T>& g) {
  const T g10 = p.igrf[0], g11 = p.igrf[1], h11 = p.igrf[2],
          g20 = p.igrf[3], g21 = p.igrf[4], h21 = p.igrf[5],
          g22 = p.igrf[6], h22 = p.igrf[7], g30 = p.igrf[8],
          g31 = p.igrf[9], h31 = p.igrf[10], g32 = p.igrf[11],
          h32 = p.igrf[12], g33 = p.igrf[13], h33 = p.igrf[14];
  const T s2p = T(2) * sp * cp;
  const T c2p = cp * cp - sp * sp;
  const T s3p = s2p * cp + c2p * sp;
  const T c3p = c2p * cp - s2p * sp;

  const T p10 = c, d10 = -s;
  const T p11 = s, d11 = c;
  const T p20 = T(1.5) * c * c - T(0.5), d20 = T(-3) * s * c;
  const T p21 = T(kRt3) * s * c, d21 = T(kRt3) * (c * c - s * s);
  const T p22 = T(0.5 * kRt3) * s * s, d22 = T(kRt3) * s * c;
  const T c5 = T(5) * c * c - T(1);
  const T p30 = T(2.5) * c * c * c - T(1.5) * c, d30 = T(-1.5) * s * c5;
  const T p31 = T(0.25 * kRt6) * s * c5;
  const T d31 = T(0.25 * kRt6) * (c * c5 - T(10) * c * s * s);
  const T p32 = T(0.5 * kRt15) * s * s * c;
  const T d32 = T(0.5 * kRt15) * (T(2) * s * c * c - s * s * s);
  const T p33 = T(0.25 * kRt10) * s * s * s;
  const T d33 = T(0.75 * kRt10) * s * s * c;

  const T inv_r = T(1) / r;
  const T f1 = inv_r * inv_r * inv_r;
  const T f2 = f1 * inv_r;
  const T f3 = f2 * inv_r;

  const T a11 = g11 * cp + h11 * sp, q11 = g11 * sp - h11 * cp;
  const T a21 = g21 * cp + h21 * sp, q21 = g21 * sp - h21 * cp;
  const T a22 = g22 * c2p + h22 * s2p, q22 = T(2) * (g22 * s2p - h22 * c2p);
  const T a31 = g31 * cp + h31 * sp, q31 = g31 * sp - h31 * cp;
  const T a32 = g32 * c2p + h32 * s2p, q32 = T(2) * (g32 * s2p - h32 * c2p);
  const T a33 = g33 * c3p + h33 * s3p, q33 = T(3) * (g33 * s3p - h33 * c3p);
  const T t1 = g10 * p10 + a11 * p11;
  const T dt1 = g10 * d10 + a11 * d11;
  const T pt1 = q11 * p11;
  const T t2 = g20 * p20 + a21 * p21 + a22 * p22;
  const T dt2 = g20 * d20 + a21 * d21 + a22 * d22;
  const T pt2 = q21 * p21 + q22 * p22;
  const T t3 = g30 * p30 + a31 * p31 + a32 * p32 + a33 * p33;
  const T dt3 = g30 * d30 + a31 * d31 + a32 * d32 + a33 * d33;
  const T pt3 = q31 * p31 + q32 * p32 + q33 * p33;

  const T nt = T(1.0e-9);
  const T s_min = T(1.0e-12);
  const T inv_s = T(1) / jmax(s, s_min);
  const T sum_p = f1 * pt1 + f2 * pt2 + f3 * pt3;
  g.br = nt * (T(2) * f1 * t1 + T(3) * f2 * t2 + T(4) * f3 * t3);
  g.bt = -nt * (f1 * dt1 + f2 * dt2 + f3 * dt3);
  g.bp = nt * inv_s * sum_p;

  const T e10 = -c, e11 = -s;
  const T e20 = T(-3) * (c * c - s * s), e21 = T(-4.0 * kRt3) * s * c,
          e22 = d21;
  const T e30 = T(-1.5) * (c * c5 - T(10) * c * s * s);
  const T e31 =
      T(0.25 * kRt6) * (T(10) * s * s * s - s * c5 - T(30) * c * c * s);
  const T e32 = T(0.5 * kRt15) * (T(2) * c * c * c - T(7) * s * s * c);
  const T e33 = T(0.75 * kRt10) * (T(2) * s * c * c - s * s * s);
  const T ddt1 = g10 * e10 + a11 * e11;
  const T ddt2 = g20 * e20 + a21 * e21 + a22 * e22;
  const T ddt3 = g30 * e30 + a31 * e31 + a32 * e32 + a33 * e33;
  const T dpt1 = q11 * d11;
  const T dpt2 = q21 * d21 + q22 * d22;
  const T dpt3 = q31 * d31 + q32 * d32 + q33 * d33;
  const T ppt1 = a11 * p11;
  const T ppt2 = a21 * p21 + T(4) * a22 * p22;
  const T ppt3 = a31 * p31 + T(4) * a32 * p32 + T(9) * a33 * p33;

  const T nt_r = nt * inv_r;
  const T sum_dp = f1 * dpt1 + f2 * dpt2 + f3 * dpt3;
  g.br_r = -nt_r * (T(6) * f1 * t1 + T(12) * f2 * t2 + T(20) * f3 * t3);
  g.bt_r = nt_r * (T(3) * f1 * dt1 + T(4) * f2 * dt2 + T(5) * f3 * dt3);
  g.bp_r =
      -nt_r * inv_s * (T(3) * f1 * pt1 + T(4) * f2 * pt2 + T(5) * f3 * pt3);
  const T c_eff = s > s_min ? c : T(0);
  g.br_t = nt * (T(2) * f1 * dt1 + T(3) * f2 * dt2 + T(4) * f3 * dt3);
  g.bt_t = -nt * (f1 * ddt1 + f2 * ddt2 + f3 * ddt3);
  g.bp_t = nt * (inv_s * sum_dp - inv_s * inv_s * c_eff * sum_p);
  g.br_p = -nt * (T(2) * f1 * pt1 + T(3) * f2 * pt2 + T(4) * f3 * pt3);
  g.bt_p = nt * sum_dp;
  g.bp_p = nt * inv_s * (f1 * ppt1 + f2 * ppt2 + f3 * ppt3);

  T m_r, m_t, m_p;
  moment_components(s, c, sp, cp, p, m_r, m_t, m_p);
  magnetic_coords(s, c, sp, cp, m_r, m_t, m_p, p, g);
}

// ops/rhs.py::rhs_3d over ops/fused.py::mu_and_grads_3d_general: the
// field's geometry and tangents, |B| and the unit field with their
// partials, cos psi and the full three-component cross for sin psi, the
// full density chain at (r, mlat, mlon) with the chain rule through the
// magnetic coordinates, the Stix quartic in the cos(psi) form.
//
// NOT inlined into the stepper's stages: one body per instance that the
// three (bs3) or seven (dopri5) evaluations of an attempt call. Inlined,
// the general-field instances ran 1.4x (float bs3) to 2.0x (float dopri5)
// longer for the same arithmetic and took 4x as long to compile (PERF.md):
// with 4 warps a SM nothing hides the instruction fetches of a straight
// line of that length. The state and the derivative then pass through
// local memory (u, out), which costs less than the fetches did. The
// results do not change: no operation is reordered across the call.
// In one ray's chain (measured on an H100 with clock64 in an instrumented
// copy, the parts forced in sequence, cycles a call, tilted / IGRF): the
// geometry 813 / 1,298, the magnetic coordinates and the density 2,658 / 2,731,
// |B|, psi and the Stix quartic 1,517 / 1,548, the rows 668 / 667; the
// attempt's three calls ~17,000 / 18,700 of its 20,200 / 22,000 cycles. The
// float bs3 instances' tail layout splits it over a team
// (rhs_general_team below).
template <typename T, int MEDIUM, int FIELD>
__device__ __noinline__ void rhs_3d_general(const T u[7], T f,
                                            const KParams<T>& p, T out[7]) {
  const T r = u[0], theta = u[1], phi = u[2];
  const T rho_r = u[3], rho_t = u[4], rho_p = u[5];
  const T st = d_sin(theta), ct = d_cos(theta);
  const T sp = d_sin(phi), cp = d_cos(phi);
  FieldGeom<T> g;
  if constexpr (FIELD == TILTED)
    geometry_tilted(r, st, ct, sp, cp, p, g);
  else
    geometry_igrf(r, st, ct, sp, cp, p, g);

  const T bm = d_sqrt(g.br * g.br + g.bt * g.bt + g.bp * g.bp);
  const T inv_bm = T(1) / bm;
  const T bm_r = (g.br * g.br_r + g.bt * g.bt_r + g.bp * g.bp_r) * inv_bm;
  const T bm_t = (g.br * g.br_t + g.bt * g.bt_t + g.bp * g.bp_t) * inv_bm;
  const T bm_p = (g.br * g.br_p + g.bt * g.bt_p + g.bp * g.bp_p) * inv_bm;
  const T hr = g.br * inv_bm, ht = g.bt * inv_bm, hp = g.bp * inv_bm;

  const T inv_rmag = d_rsqrt(rho_r * rho_r + rho_t * rho_t + rho_p * rho_p);
  const T rr = rho_r * inv_rmag, rt = rho_t * inv_rmag, rp = rho_p * inv_rmag;
  const T cospsi = jmin(jmax(hr * rr + ht * rt + hp * rp, T(-1)), T(1));
  const T c1 = ht * rp - hp * rt;
  const T c2 = hp * rr - hr * rp;
  const T c3 = hr * rt - ht * rr;
  const T sinpsi = d_sqrt(c1 * c1 + c2 * c2 + c3 * c3);
  const T dcos_dr =
      ((g.br_r * rr + g.bt_r * rt + g.bp_r * rp) - cospsi * bm_r) * inv_bm;
  const T dcos_dt =
      ((g.br_t * rr + g.bt_t * rt + g.bp_t * rp) - cospsi * bm_t) * inv_bm;
  const T dcos_dp =
      ((g.br_p * rr + g.bt_p * rt + g.bp_p * rp) - cospsi * bm_p) * inv_bm;
  const T dcos_drho_r = (hr - cospsi * rr) * inv_rmag;
  const T dcos_drho_t = (ht - cospsi * rt) * inv_rmag;
  const T dcos_drho_p = (hp - cospsi * rp) * inv_rmag;

  T ne, ne_r, ne_lat, ne_mlon;
  ne_and_grads_full<T, wide(MEDIUM)>(r, d_sin(g.mlat), d_cos(g.mlat), g.mlon,
                                     p.mlt_on, p, ne, ne_r, ne_lat, ne_mlon);
  T dne_dt = ne_lat * g.mlat_t, dne_dp = ne_lat * g.mlat_p;
  if (p.mlt_on) {
    dne_dt = dne_dt + ne_mlon * g.mlon_t;
    dne_dp = dne_dp + ne_mlon * g.mlon_p;
  }
  T mu, dmu_dn, dmu_db, dmu_df, dmu_dc;
  stix_quartic_grads<T, true, extended(MEDIUM)>(
      ne, bm, f, sinpsi, cospsi, p, mu, dmu_dn, dmu_db, dmu_df, dmu_dc);
  kimura_rows(u, f, mu, dmu_dn * ne_r + dmu_db * bm_r + dmu_dc * dcos_dr,
              dmu_dn * dne_dt + dmu_db * bm_t + dmu_dc * dcos_dt,
              dmu_dn * dne_dp + dmu_db * bm_p + dmu_dc * dcos_dp,
              dmu_dc * dcos_drho_r, dmu_dc * dcos_drho_t,
              dmu_dc * dcos_drho_p, dmu_df, kim_trig(u), out);
}

// The same in the team body (general_team: the float bs3 instances over
// FULL, those of ensemble10k_tilted and ensemble10k_igrf, in their tail
// layout), split as rhs_3d_team splits rhs_3d. The chain's branches are independent: the field's
// geometry does not depend on the density, and the density depends on the
// magnetic coordinates alone, which come from the moment's components and
// not from the field's tangents. Input: r, theta, phi and rho. Pieces:
// helper 1 the field's geometry and fifteen tangents (geometry_tilted,
// geometry_igrf), |B| with its partials, the unit field, cos psi and sin psi
// with their tangents, and the Stix terms of the field; helper 2 the
// magnetic coordinates with their tangents and the density's head at mlon
// (ne_head); helper 3 the magnetic latitude again, for the density's terms
// in L (ne_lterms), and the Kimura rows' trigonometry (the same operations
// give the same bits, and cost no third barrier). Warp 0 then forms the
// density's tail, the chain rule through (mlat, mlon), the quartic and the
// rows. Every expression is rhs_3d_general's, with its operands in its
// order, so the two bodies agree bit for bit.
template <typename T>
struct FieldPsi {
  T bm_r, bm_t, bm_p, sinpsi, cospsi, dcos_dr, dcos_dt, dcos_dp, dcos_drho_r,
      dcos_drho_t, dcos_drho_p;
};

template <typename T>
struct MagTangents {
  T mlat_t, mlat_p, mlon_t, mlon_p;
};

template <typename T>
struct SlotsGen {
  static constexpr int F = kIn3D + 1, S = F + n_slots<FieldPsi<T>, T>(),
                       H = S + n_slots<StixField<T>, T>(),
                       M = H + n_slots<NeHead<T>, T>(),
                       B = M + n_slots<MagTangents<T>, T>(),
                       K = B + n_slots<NeLTerms<T>, T>(),
                       end = K + n_slots<KimTrig<T>, T>();
};

// helper 1: the field and the psi cosines at u (and |B| for the Stix terms)
template <typename T, int FIELD>
__device__ __forceinline__ FieldPsi<T> field_psi(const T u[kIn3D],
                                                 const KParams<T>& p, T& bm) {
  const T r = u[0], theta = u[1], phi = u[2];
  const T rho_r = u[3], rho_t = u[4], rho_p = u[5];
  const T st = d_sin(theta), ct = d_cos(theta);
  const T sp = d_sin(phi), cp = d_cos(phi);
  FieldGeom<T> g;
  if constexpr (FIELD == TILTED)
    geometry_tilted(r, st, ct, sp, cp, p, g);
  else
    geometry_igrf(r, st, ct, sp, cp, p, g);

  FieldPsi<T> o;
  bm = d_sqrt(g.br * g.br + g.bt * g.bt + g.bp * g.bp);
  const T inv_bm = T(1) / bm;
  o.bm_r = (g.br * g.br_r + g.bt * g.bt_r + g.bp * g.bp_r) * inv_bm;
  o.bm_t = (g.br * g.br_t + g.bt * g.bt_t + g.bp * g.bp_t) * inv_bm;
  o.bm_p = (g.br * g.br_p + g.bt * g.bt_p + g.bp * g.bp_p) * inv_bm;
  const T hr = g.br * inv_bm, ht = g.bt * inv_bm, hp = g.bp * inv_bm;

  const T inv_rmag = d_rsqrt(rho_r * rho_r + rho_t * rho_t + rho_p * rho_p);
  const T rr = rho_r * inv_rmag, rt = rho_t * inv_rmag, rp = rho_p * inv_rmag;
  o.cospsi = jmin(jmax(hr * rr + ht * rt + hp * rp, T(-1)), T(1));
  const T c1 = ht * rp - hp * rt;
  const T c2 = hp * rr - hr * rp;
  const T c3 = hr * rt - ht * rr;
  o.sinpsi = d_sqrt(c1 * c1 + c2 * c2 + c3 * c3);
  o.dcos_dr =
      ((g.br_r * rr + g.bt_r * rt + g.bp_r * rp) - o.cospsi * o.bm_r) * inv_bm;
  o.dcos_dt =
      ((g.br_t * rr + g.bt_t * rt + g.bp_t * rp) - o.cospsi * o.bm_t) * inv_bm;
  o.dcos_dp =
      ((g.br_p * rr + g.bt_p * rt + g.bp_p * rp) - o.cospsi * o.bm_p) * inv_bm;
  o.dcos_drho_r = (hr - o.cospsi * rr) * inv_rmag;
  o.dcos_drho_t = (ht - o.cospsi * rt) * inv_rmag;
  o.dcos_drho_p = (hp - o.cospsi * rp) * inv_rmag;
  return o;
}

// helpers 2 and 3: the magnetic coordinates at u (mlat, mlon and their
// tangents; the field's members are not formed)
template <typename T>
__device__ __forceinline__ FieldGeom<T> mag_coords(const T u[kIn3D],
                                                   const KParams<T>& p) {
  const T st = d_sin(u[1]), ct = d_cos(u[1]);
  const T sp = d_sin(u[2]), cp = d_cos(u[2]);
  T m_r, m_t, m_p;
  moment_components(st, ct, sp, cp, p, m_r, m_t, m_p);
  FieldGeom<T> g;
  magnetic_coords(st, ct, sp, cp, m_r, m_t, m_p, p, g);
  return g;
}

template <typename T, int K, int FIELD>
__device__ __forceinline__ void pieces_general(const T* x, T f,
                                               const KParams<T>& p,
                                               const Team<T>& tm, T* out) {
  using S = SlotsGen<T>;
  T u[kIn3D];
#pragma unroll
  for (int k = 0; k < kIn3D; ++k) u[k] = x[k * 32 + tm.lane];
  if (serves<K>(tm, 0)) {
    T bm;
    put(out, tm.lane, S::F, field_psi<T, FIELD>(u, p, bm));
    put(out, tm.lane, S::S, stix_field(bm, f));
  }
  if (serves<K>(tm, 1)) {
    const FieldGeom<T> g = mag_coords(u, p);
    put(out, tm.lane, S::M,
        MagTangents<T>{g.mlat_t, g.mlat_p, g.mlon_t, g.mlon_p});
    put(out, tm.lane, S::H, ne_head(u[0], g.mlon, p.mlt_on, p));
  }
  if (serves<K>(tm, 2)) {
    const T mlat = mag_coords(u, p).mlat;
    put(out, tm.lane, S::B, ne_lterms(u[0], d_sin(mlat), d_cos(mlat), p));
    put(out, tm.lane, S::K, kim_trig(u));
  }
}

template <typename T, int K>
__device__ __forceinline__ void rhs_general_team(const T u[7], T f,
                                                 const KParams<T>& p,
                                                 T out[7],
                                                 const Team<T>& tm) {
  using S = SlotsGen<T>;
  const T in[kIn3D] = {u[0], u[1], u[2], u[3], u[4], u[5]};
  team_post(tm, in);
  team_wait();
  if (!tm.live) return;
  const T* x = tm.xch;
  T ne, ne_r, ne_lat, ne_mlon;
  ne_tail(get<NeHead<T>>(x, tm.lane, S::H), get<NeLTerms<T>>(x, tm.lane, S::B),
          p.mlt_on, p, ne, ne_r, ne_lat, ne_mlon);
  const MagTangents<T> m = get<MagTangents<T>>(x, tm.lane, S::M);
  T dne_dt = ne_lat * m.mlat_t, dne_dp = ne_lat * m.mlat_p;
  if (p.mlt_on) {
    dne_dt = dne_dt + ne_mlon * m.mlon_t;
    dne_dp = dne_dp + ne_mlon * m.mlon_p;
  }
  const FieldPsi<T> g = get<FieldPsi<T>>(x, tm.lane, S::F);
  T mu, dmu_dn, dmu_db, dmu_df, dmu_dc;
  stix_protons<T, true>(ne, get<StixField<T>>(x, tm.lane, S::S), g.sinpsi,
                        g.cospsi, p, mu, dmu_dn, dmu_db, dmu_df, dmu_dc);
  kimura_rows(u, f, mu, dmu_dn * ne_r + dmu_db * g.bm_r + dmu_dc * g.dcos_dr,
              dmu_dn * dne_dt + dmu_db * g.bm_t + dmu_dc * g.dcos_dt,
              dmu_dn * dne_dp + dmu_db * g.bm_p + dmu_dc * g.dcos_dp,
              dmu_dc * g.dcos_drho_r, dmu_dc * g.dcos_drho_t,
              dmu_dc * g.dcos_drho_p, dmu_df, get<KimTrig<T>>(x, tm.lane, S::K),
              out);
}

// a helper warp of the team body: serves warp 0's right-hand sides until
// warp 0 posts the exit (a live flag of -1 in every lane)
template <typename T, int K, int FIELD>
__device__ __forceinline__ void team_helper(T f, const KParams<T>& p,
                                            const Team<T>& tm) {
  for (;;) {
    __syncthreads();  // warp 0 has posted the input
    const T live = tm.xch[kIn3D * 32 + tm.lane];
    if (live < T(0)) return;  // the same in every lane
    if (live > T(0)) {
      if constexpr (FIELD == DIPOLE)
        pieces_3d<T, K>(tm.xch, f, p, tm, tm.xch);
      else
        pieces_general<T, K, FIELD>(tm.xch, f, p, tm, tm.xch);
    }
    __syncthreads();  // the pieces are in
  }
}

// ---- the autodiff gradient set (MEDIUM = AD) -----------------------------
//
// ops/gradients.py grad_mode="autodiff": mu and its partials, the exact
// derivatives of the traced mu = sqrt(|mu^2|), in forward mode. The value
// chain of ops/dispersion.py (mu_2d_lat, mu_2d_colat, mu_3d) over
// models/medium.py, plasmasphere.py, ionosphere.py and dipole.py is
// written here once, templated on its scalar, with the same branches and
// the same operations in the same order as those torch functions, and
// runs on dual numbers: Dual<T, W> carries a value and W tangents, one per
// seeded input. Each tangent rule is torch's forward-mode formula for the
// op (PyTorch's derivatives.yaml; ops/dual.py, the plain version, applies
// the same rules to (N, B) tangent tensors), so that the kernel rounds as
// the plain version does on the card, tangent row by tangent row:
//   a * b: b.t * a.v + a.t * b.v; a / b: (a.t - b.t * res) / b.v;
//   c / x: x.reciprocal() * c (torch's __rtruediv__), whose tangent is
//   ((-x.t) * (rr * rr)) * c; x / c for a Python scalar c: a product with
//   1 / c formed in T (recip; KParams' inv_*_t); sqrt: t / (2 res); exp:
//   t * res; log: t / x; sin: t * cos x; cos: t * (-sin x); asin: t *
//   rsqrt(-x * x + 1); atan2: (-y * x.t + x * y.t) / (y^2 + x^2); abs: t *
//   sign x (sign 0 = 0); clamp: the tangent where lo <= x <= hi, else 0;
//   maximum(a, b): b.t + w (a.t - b.t), w = 0.5 at a tie, else 1 or 0;
//   where: the selected operand's tangent; x**2: t * (2 x).
// A Python float or the dipole's B_phi (torch.zeros_like) is a constant:
// the operators taking a T leave its tangent out, as torch does for an
// operand with no tangent. Every tangent row is computed alone from the
// values and its own row, so W = N (one pass) and N passes of W = 1 give
// the same bits. kAdWidth2D and kAdWidth3D choose one pass on one thread
// (the value chain formed once; PERF.md section 6), and the group body N
// passes of W = 1 on N lanes at once (ad_mu_grads_group). The medium's
// features are run-time flags of KParams (as in FULL and EXT), the ion
// species and the local ceiling too (as in EXT), legacy_freq_state in 2D
// (as in ALTX). The right-hand side is a __noinline__ call, one body per
// (T, frame, field) that the steppers' stages call, so that the dual chain
// is compiled once per instance family (the group body's too,
// rhs_ad_group: PERF.md section 6).

constexpr int kAdWidth2D = 4;  // tangents a pass in the 2D frames (N = 4)
constexpr int kAdWidth3D = 7;  // and in the 3D frame (N = 7)

template <typename T, int W>
struct Dual {
  T v;
  T t[W];
};

#define AD_LOOP _Pragma("unroll") for (int k = 0; k < W; ++k)

template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator+(const Dual<T, W>& a,
                                                const Dual<T, W>& b) {
  Dual<T, W> r;
  r.v = a.v + b.v;
  AD_LOOP r.t[k] = a.t[k] + b.t[k];
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator+(const Dual<T, W>& a, T c) {
  Dual<T, W> r = a;
  r.v = a.v + c;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator+(T c, const Dual<T, W>& a) {
  Dual<T, W> r = a;
  r.v = c + a.v;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator-(const Dual<T, W>& a,
                                                const Dual<T, W>& b) {
  Dual<T, W> r;
  r.v = a.v - b.v;
  AD_LOOP r.t[k] = a.t[k] - b.t[k];
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator-(const Dual<T, W>& a, T c) {
  Dual<T, W> r = a;
  r.v = a.v - c;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator-(T c, const Dual<T, W>& a) {
  Dual<T, W> r;
  r.v = c - a.v;
  AD_LOOP r.t[k] = -a.t[k];
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator-(const Dual<T, W>& a) {
  Dual<T, W> r;
  r.v = -a.v;
  AD_LOOP r.t[k] = -a.t[k];
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator*(const Dual<T, W>& a,
                                                const Dual<T, W>& b) {
  Dual<T, W> r;
  r.v = a.v * b.v;
  AD_LOOP r.t[k] = b.t[k] * a.v + a.t[k] * b.v;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator*(const Dual<T, W>& a, T c) {
  Dual<T, W> r;
  r.v = a.v * c;
  AD_LOOP r.t[k] = a.t[k] * c;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator*(T c, const Dual<T, W>& a) {
  Dual<T, W> r;
  r.v = c * a.v;
  AD_LOOP r.t[k] = a.t[k] * c;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> operator/(const Dual<T, W>& a,
                                                const Dual<T, W>& b) {
  Dual<T, W> r;
  r.v = a.v / b.v;
  AD_LOOP r.t[k] = (a.t[k] - b.t[k] * r.v) / b.v;
  return r;
}
// c / x for a Python scalar c: x.reciprocal() * c
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> rdiv(T c, const Dual<T, W>& x) {
  const T rr = T(1) / x.v;
  const T rr2 = rr * rr;
  Dual<T, W> r;
  r.v = rr * c;
  AD_LOOP r.t[k] = (-x.t[k] * rr2) * c;
  return r;
}
// x ** 2
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> sq(const Dual<T, W>& x) {
  const T two_x = T(2) * x.v;
  Dual<T, W> r;
  r.v = x.v * x.v;
  AD_LOOP r.t[k] = x.t[k] * two_x;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_sin(const Dual<T, W>& x) {
  const T c = d_cos(x.v);
  Dual<T, W> r;
  r.v = d_sin(x.v);
  AD_LOOP r.t[k] = x.t[k] * c;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_cos(const Dual<T, W>& x) {
  const T ms = -d_sin(x.v);
  Dual<T, W> r;
  r.v = d_cos(x.v);
  AD_LOOP r.t[k] = x.t[k] * ms;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_exp(const Dual<T, W>& x) {
  Dual<T, W> r;
  r.v = d_exp(x.v);
  AD_LOOP r.t[k] = x.t[k] * r.v;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_log(const Dual<T, W>& x) {
  Dual<T, W> r;
  r.v = d_log(x.v);
  AD_LOOP r.t[k] = x.t[k] / x.v;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_sqrt(const Dual<T, W>& x) {
  Dual<T, W> r;
  r.v = d_sqrt(x.v);
  const T two_r = T(2) * r.v;
  AD_LOOP r.t[k] = x.t[k] / two_r;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_asin(const Dual<T, W>& x) {
  const T g = d_rsqrt(-x.v * x.v + T(1));
  Dual<T, W> r;
  r.v = d_asin(x.v);
  AD_LOOP r.t[k] = x.t[k] * g;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_atan2(const Dual<T, W>& y,
                                              const Dual<T, W>& x) {
  const T my = -y.v;
  const T den = y.v * y.v + x.v * x.v;
  Dual<T, W> r;
  r.v = d_atan2(y.v, x.v);
  AD_LOOP r.t[k] = (my * x.t[k] + x.v * y.t[k]) / den;
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_abs(const Dual<T, W>& x) {
  const T sg = tsign(x.v);
  Dual<T, W> r;
  r.v = d_abs(x.v);
  AD_LOOP r.t[k] = x.t[k] * sg;
  return r;
}
// torch.clamp(x, lo, hi): NaN propagates; the tangent passes on [lo, hi]
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_clamp(const Dual<T, W>& x, T lo,
                                              T hi) {
  const bool in = x.v >= lo && x.v <= hi;
  Dual<T, W> r;
  r.v = jmin(jmax(x.v, lo), hi);
  AD_LOOP r.t[k] = in ? x.t[k] : T(0);
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_clamp_min(const Dual<T, W>& x,
                                                  T lo) {
  const bool in = x.v >= lo;
  Dual<T, W> r;
  r.v = jmax(x.v, lo);
  AD_LOOP r.t[k] = in ? x.t[k] : T(0);
  return r;
}
// torch.maximum, its tangent weighted 0.5 at a tie
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_max(const Dual<T, W>& a,
                                            const Dual<T, W>& b) {
  const T w = a.v == b.v ? T(0.5) : (a.v > b.v ? T(1) : T(0));
  Dual<T, W> r;
  r.v = jmax(a.v, b.v);
  AD_LOOP r.t[k] = b.t[k] + w * (a.t[k] - b.t[k]);
  return r;
}
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> d_select(bool c, const Dual<T, W>& a,
                                               const Dual<T, W>& b) {
  return c ? a : b;
}

// the value of a parameter that is a constant (T) or a Dual (the
// MLT-resolved medium's effective parameters)
template <typename T>
__device__ __forceinline__ T val(T x) {
  return x;
}
template <typename T, int W>
__device__ __forceinline__ T val(const Dual<T, W>& x) {
  return x.v;
}

// plasmasphere.sigmoid: 1 / (1 + exp(-x))
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> ad_sigmoid(const Dual<T, W>& x) {
  return rdiv(T(1), T(1) + d_exp(-x));
}

// plasmasphere.ne_plasma_cm3 (CA1992, hard or smoothed plasmapause, the
// trough refill): P is T at the env's parameters or Dual at the
// MLT-resolved medium's; ln_nl is log(ne_lppi) (math.log of the env's
// float, or the tensor's log)
template <typename T, int W, typename P>
__device__ __forceinline__ Dual<T, W> ad_ca1992(const Dual<T, W>& L,
                                                const P& lppi, const P& lppo,
                                                const P& ne_lppi,
                                                const P& trough,
                                                const P& ln_nl,
                                                const KParams<T>& p) {
  using D = Dual<T, W>;
  const D log_ne1 = (T(-0.3145) * L + T(3.9043)) +
                    p.ps_season * d_exp((T(2) - L) * recip(T(1.5)));
  const D ne1 = d_exp(T(kLN10) * log_ne1);
  const D ne2 =
      ne_lppi * d_exp((T(kLN10) * (lppi - L)) * recip(T(0.1)));
  const D Ls = d_clamp_min(L, T(1.0e-6));
  D ne3 = trough * d_exp(T(-4.5) * d_log(Ls)) +
          (T(1) - d_exp((T(2) - L) * recip(T(10))));
  if (p.refill_on) {  // log-space refill toward branch 1
    if (p.refill_q_on) {  // plasmasphere.refill_weight per L
      const D e = d_exp(p.ps_refill_q * (p.ln_lref - d_log(Ls)));
      const D w = T(1) - d_exp(e * p.ln_keep);
      ne3 = d_exp((T(1) - w) * d_log(ne3) + w * (T(kLN10) * log_ne1));
    } else {
      ne3 = d_exp(p.one_m_refill * d_log(ne3) +
                  p.ps_refill * (T(kLN10) * log_ne1));
    }
  }
  const D hard = d_select(L.v <= val(lppi), ne1,
                          d_select(L.v <= val(lppo), ne2, ne3));
  if (!p.smooth_on) return hard;
  const D w1 = ad_sigmoid((lppi - L) * p.inv_smooth_t);
  const D w2 = ad_sigmoid((lppo - L) * p.inv_smooth_t);
  const D ln1 = T(kLN10) * log_ne1;
  const D ln2 = ln_nl + (T(kLN10) * (lppi - L)) * recip(T(0.1));
  const D ln3 = d_log(ne3);
  return d_exp(w1 * ln1 + (T(1) - w1) * (w2 * ln2 + (T(1) - w2) * ln3));
}

// plasmasphere.ne_gcpm_cm3 at (L, sin lat, cos lat)
template <typename T, int W, typename P>
__device__ __forceinline__ Dual<T, W> ad_gcpm(const Dual<T, W>& L,
                                              const Dual<T, W>& sl,
                                              const Dual<T, W>& cl,
                                              const P& lppo, const P& trough,
                                              const KParams<T>& p) {
  using D = Dual<T, W>;
  const D q2 = T(1) + T(3) * (sl * sl);
  const D ln_m = T(0.5) * d_log(q2) - T(6) * d_log(cl);
  const D ln_ps =
      (p.ln_gcpm_ne0 - (L - T(2)) * p.inv_lscale_t) + p.gcpm_bpow * ln_m;
  const D Ls = d_clamp_min(L, T(1.0e-6));
  const D ln_tr = d_log(trough * d_exp(T(-4.5) * d_log(Ls)) +
                        (T(1) - d_exp((T(2) - L) * recip(T(10)))));
  const D w = ad_sigmoid((lppo - L) * p.inv_knee_t);
  return d_exp(w * ln_ps + (T(1) - w) * ln_tr);
}

// medium.ne_total_m3 at (r, sin lat, cos lat) and, with `mlt` (the 3D
// frame over the MLT-resolved medium), the longitude phi. A shape of no
// harmonic is c0 with a tangent of zeros (the coefficients past c0 are
// zero-padded), where the plain version has a constant: the same values,
// every tangent it feeds unchanged. WIDE (AD_ANY): the harmonics past
// kMaxHarm from their buffer, in a rolled loop
template <typename T, int W, bool WIDE = false>
__device__ __forceinline__ Dual<T, W> ad_ne_total(const Dual<T, W>& r,
                                                  const Dual<T, W>& sl,
                                                  const Dual<T, W>& cl,
                                                  const Dual<T, W>& phi,
                                                  bool mlt,
                                                  const KParams<T>& p) {
  using D = Dual<T, W>;
  const D dr0 = r - p.iono_r0;
  D ne_i = p.iono_n0 * d_exp(p.neg_decay * dr0);
  if (p.iono_mix_on)  // the day/night blend of two fits
    ne_i = p.iono_mix * ne_i +
           p.one_m_mix * (p.iono_n0_b * d_exp(p.neg_decay_b * dr0));
  const D L = r / (cl * cl);  // dipole.l_shell
  D ne_p;
  if (mlt) {
    // medium._mlt_shape: the Fourier shape by angle recursion (its phi
    // slope is not needed here) and the day-night trough
    const D ang = p.ps_mlt_a0 + phi;
    const D s1a = d_sin(ang), c1a = d_cos(ang);
    D sk = s1a, ck = c1a;
    D shape = (p.mlt_c[0] + p.mlt_c[1] * ck) + p.mlt_c[2] * sk;
#pragma unroll
    for (int h = 2; h <= kMaxHarm; ++h) {
      if (h > p.n_harm) break;
      const D sn = sk * c1a + ck * s1a;
      const D cn = ck * c1a - sk * s1a;
      sk = sn;
      ck = cn;
      shape = (shape + p.mlt_c[2 * h - 1] * ck) + p.mlt_c[2 * h] * sk;
    }
    if constexpr (WIDE) {
      for (int h = kMaxHarm + 1; h <= p.n_harm; ++h) {
        const D sn = sk * c1a + ck * s1a;
        const D cn = ck * c1a - sk * s1a;
        sk = sn;
        ck = cn;
        const T* c = wide_params(p).mlt_ext + 2 * (h - kMaxHarm - 1);
        shape = (shape + c[0] * ck) + c[1] * sk;
      }
    }
    const D trough = p.ps_trough + p.ps_mlt_tamp * (c1a - p.cos_a0);
    if (p.gcpm_on) {  // medium.mlt_gcpm_params
      ne_p = ad_gcpm<T, W, D>(L, sl, cl, p.lppo * shape, trough, p);
    } else {  // medium.mlt_ps_params
      const D lppi_e = p.lppi * shape;
      const D e_i = d_exp((T(2) - lppi_e) * recip(T(1.5)));
      const D g1i = (T(-0.3145) * lppi_e + T(3.9043)) + p.ps_season * e_i;
      const D ne_lppi_e = d_exp(T(kLN10) * g1i);
      const D lppo_e = lppi_e + T(0.1) * (g1i - p.ps_mlt_c3);
      const D ln_nl = p.smooth_on ? d_log(ne_lppi_e) : ne_lppi_e;
      ne_p = ad_ca1992<T, W, D>(L, lppi_e, lppo_e, ne_lppi_e, trough, ln_nl,
                                p);
    }
  } else if (p.gcpm_on) {
    ne_p = ad_gcpm<T, W, T>(L, sl, cl, p.lppo, p.ps_trough, p);
  } else {
    ne_p = ad_ca1992<T, W, T>(L, p.lppi, p.lppo, p.ne_lppi, p.ps_trough,
                              p.ln_ne_lppi, p);
  }
  if (p.duct_on) {  // plasmasphere.duct_factor
    const D x = (L - p.duct_l0) * p.inv_duct_w_t;
    ne_p = ne_p * (T(1) + p.duct_amp * d_exp((T(-0.5) * x) * x));
  }
  // plasmasphere.diffusive_equilibrium_factor, weighted by de_weight
  const D G =
      T(kDeRbase) * (T(1) - rdiv(T(kDeRbase), r * T(kRE)));
  const D de = d_sqrt(d_exp((-G) * recip(T(kDeS))));
  ne_p = ne_p * (p.de_w * de + p.one_m_de_w);
  return (ne_i + p.ps_w * ne_p) * T(1.0e6);
}

// dispersion.stix_rlp over the p.n_ion species, mu2_signed_trig and
// mu_from_mu2
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> ad_mu_stix(
    const Dual<T, W>& ne, const Dual<T, W>& bm, const Dual<T, W>& f,
    const Dual<T, W>& sinpsi, const Dual<T, W>& cospsi,
    const KParams<T>& p) {
  using D = Dual<T, W>;
  const D n_cm3 = ne * T(1.0e-6);
  const D f2 = f * f;
  const D xe = (T(kFPE2_E) * n_cm3) / f2;
  const D ye = (T(kFCE_E) * bm) / f;
  D R = T(1) - xe / (T(1) - ye);
  D L = T(1) - xe / (T(1) + ye);
  D P = T(1) - xe;
#pragma unroll
  for (int k = 0; k < kMaxIon; ++k) {
    if (k >= p.n_ion) break;
    const D xi = (p.ion_fpe2[k] * n_cm3) / f2;
    const D yi = (p.ion_fce[k] * bm) / f;
    R = R - xi / (T(1) + yi);
    L = L - xi / (T(1) - yi);
    P = P - xi;
  }
  const D s = d_max(d_max(d_abs(R), d_abs(L)), d_abs(P));
  const D rn = R / s, ln = L / s, pn = P / s;
  const D dn = T(0.5) * (rn - ln);
  const D sn = T(0.5) * (rn + ln);
  const D sin2 = sinpsi * sinpsi;
  const D cos2 = cospsi * cospsi;
  const D a = sn * sin2 + pn * cos2;
  const D rl = rn * ln;
  const D ps = pn * sn;
  const D b = rl * sin2 + ps * (T(1) + cos2);
  const D c = (pn * rn) * ln;
  const D rl_ps = rl - ps;
  const D fd = d_sqrt(((rl_ps * rl_ps) * sin2) * sin2 +
                      T(4) * sq((pn * dn) * cospsi));
  const D direct = (b + p.root * fd) / (T(2) * a);
  const D product = (T(2) * c) / (b - p.root * fd);
  const D mu2n = d_select(p.root * b.v >= T(0), direct, product);
  return d_sqrt(d_abs(s * mu2n));
}

// dispersion.mu_2d_lat (psi_trig_lat, ne_total_m3, b_mag_lat; the square
// root of 1 + 3 sin^2 lat serves both)
template <typename T, int W>
__device__ __forceinline__ Dual<T, W> ad_mu_2d(const Dual<T, W>& r,
                                               const Dual<T, W>& lat,
                                               const Dual<T, W>& chi,
                                               const Dual<T, W>& f,
                                               const KParams<T>& p) {
  using D = Dual<T, W>;
  const D sl = d_sin(lat), cl = d_cos(lat);
  const D q = d_sqrt(T(1) + (T(3) * sl) * sl);
  const D sindip = (T(2) * sl) / q;
  const D cosdip = cl / q;
  const D sc = d_sin(chi), cc = d_cos(chi);
  const D sinpsi = cosdip * cc - sindip * sc;
  const D cospsi = -(sindip * cc + cosdip * sc);
  const D ne = ad_ne_total(r, sl, cl, chi, false, p);
  const D bm = (p.b0 * q) / ((r * r) * r);
  return ad_mu_stix(ne, bm, f, sinpsi, cospsi, p);
}

// dispersion._psi_trig_bmag_3d and the rest of mu_3d from the field
// (br, bt, bp; bp a constant 0 for the centered dipole) and the density
template <typename T, int W, typename BP>
__device__ __forceinline__ Dual<T, W> ad_mu_3d_tail(
    const Dual<T, W>& br, const Dual<T, W>& bt, const BP& bp,
    const Dual<T, W>& rr, const Dual<T, W>& rt, const Dual<T, W>& rp,
    const Dual<T, W>& ne, const Dual<T, W>& f, const KParams<T>& p) {
  using D = Dual<T, W>;
  const D bmag = d_sqrt((br * br + bt * bt) + bp * bp);
  const D rmag = d_sqrt((rr * rr + rt * rt) + rp * rp);
  const D inv_brm = rdiv(T(1), bmag * rmag);
  const D cospsi =
      d_clamp(((br * rr + bt * rt) + bp * rp) * inv_brm, T(-1), T(1));
  const D c_r = bt * rp - bp * rt;
  const D c_t = bp * rr - br * rp;
  const D c_p = br * rt - bt * rr;
  const D sinpsi = d_sqrt((c_r * c_r + c_t * c_t) + c_p * c_p) * inv_brm;
  return ad_mu_stix(ne, bmag, f, sinpsi, cospsi, p);
}

// dipole._moment_components and magnetic_coords (mlat, mlon of the tilted
// frame) from the sines and cosines of theta and phi
template <typename T, int W>
__device__ __forceinline__ void ad_moment(const Dual<T, W>& st,
                                          const Dual<T, W>& ct,
                                          const Dual<T, W>& sp,
                                          const Dual<T, W>& cp,
                                          const KParams<T>& p,
                                          Dual<T, W>& m_r, Dual<T, W>& m_t,
                                          Dual<T, W>& m_p) {
  m_r = ((p.mom[0] * st) * cp + (p.mom[1] * st) * sp) + p.mom[2] * ct;
  m_t = ((p.mom[0] * ct) * cp + (p.mom[1] * ct) * sp) - p.mom[2] * st;
  m_p = (-p.mom[0]) * sp + p.mom[1] * cp;
}

template <typename T, int W>
__device__ __forceinline__ void ad_magnetic_coords(
    const Dual<T, W>& st, const Dual<T, W>& ct, const Dual<T, W>& sp,
    const Dual<T, W>& cp, const Dual<T, W>& m_r, const KParams<T>& p,
    Dual<T, W>& mlat, Dual<T, W>& mlon) {
  using D = Dual<T, W>;
  mlat = d_asin(d_clamp(-m_r, T(-1), T(1)));
  const D rx = st * cp, ry = st * sp;
  const D y = (p.ym[0] * rx + p.ym[1] * ry) + p.ym[2] * ct;
  const D x = (p.xm[0] * rx + p.xm[1] * ry) + p.xm[2] * ct;
  mlon = d_atan2(y, x);
}

// dipole.igrf_field's value (closed-form Schmidt P_nm, n <= 3)
template <typename T, int W>
__device__ __forceinline__ void ad_igrf(const Dual<T, W>& r,
                                        const Dual<T, W>& s,
                                        const Dual<T, W>& c,
                                        const Dual<T, W>& sp,
                                        const Dual<T, W>& cp,
                                        const KParams<T>& p, Dual<T, W>& br,
                                        Dual<T, W>& bt, Dual<T, W>& bp) {
  using D = Dual<T, W>;
  const T g10 = p.igrf[0], g11 = p.igrf[1], h11 = p.igrf[2],
          g20 = p.igrf[3], g21 = p.igrf[4], h21 = p.igrf[5],
          g22 = p.igrf[6], h22 = p.igrf[7], g30 = p.igrf[8],
          g31 = p.igrf[9], h31 = p.igrf[10], g32 = p.igrf[11],
          h32 = p.igrf[12], g33 = p.igrf[13], h33 = p.igrf[14];
  const D s2p = (T(2) * sp) * cp;
  const D c2p = cp * cp - sp * sp;
  const D s3p = s2p * cp + c2p * sp;
  const D c3p = c2p * cp - s2p * sp;
  const D d10 = -s;
  const D p20 = (T(1.5) * c) * c - T(0.5), d20 = (T(-3) * s) * c;
  const D p21 = (T(kRt3) * s) * c, d21 = T(kRt3) * (c * c - s * s);
  const D p22 = (T(0.5 * kRt3) * s) * s, d22 = (T(kRt3) * s) * c;
  const D c5 = (T(5) * c) * c - T(1);
  const D p30 = ((T(2.5) * c) * c) * c - T(1.5) * c;
  const D d30 = (T(-1.5) * s) * c5;
  const D p31 = (T(0.25 * kRt6) * s) * c5;
  const D d31 = T(0.25 * kRt6) * (c * c5 - ((T(10) * c) * s) * s);
  const D p32 = ((T(0.5 * kRt15) * s) * s) * c;
  const D d32 = T(0.5 * kRt15) * (((T(2) * s) * c) * c - (s * s) * s);
  const D p33 = ((T(0.25 * kRt10) * s) * s) * s;
  const D d33 = ((T(0.75 * kRt10) * s) * s) * c;
  const D inv_r = rdiv(T(1), r);
  const D f1 = (inv_r * inv_r) * inv_r;
  const D f2 = f1 * inv_r;
  const D f3 = f2 * inv_r;
  const D a11 = g11 * cp + h11 * sp, q11 = g11 * sp - h11 * cp;
  const D a21 = g21 * cp + h21 * sp, q21 = g21 * sp - h21 * cp;
  const D a22 = g22 * c2p + h22 * s2p;
  const D q22 = T(2) * (g22 * s2p - h22 * c2p);
  const D a31 = g31 * cp + h31 * sp, q31 = g31 * sp - h31 * cp;
  const D a32 = g32 * c2p + h32 * s2p;
  const D q32 = T(2) * (g32 * s2p - h32 * c2p);
  const D a33 = g33 * c3p + h33 * s3p;
  const D q33 = T(3) * (g33 * s3p - h33 * c3p);
  const D t1 = g10 * c + a11 * s;
  const D dt1 = g10 * d10 + a11 * c;
  const D pt1 = q11 * s;
  const D t2 = (g20 * p20 + a21 * p21) + a22 * p22;
  const D dt2 = (g20 * d20 + a21 * d21) + a22 * d22;
  const D pt2 = q21 * p21 + q22 * p22;
  const D t3 = ((g30 * p30 + a31 * p31) + a32 * p32) + a33 * p33;
  const D dt3 = ((g30 * d30 + a31 * d31) + a32 * d32) + a33 * d33;
  const D pt3 = (q31 * p31 + q32 * p32) + q33 * p33;
  const T nt = T(1.0e-9);
  const D inv_s = rdiv(T(1), d_clamp_min(s, T(1.0e-12)));
  const D sum_p = (f1 * pt1 + f2 * pt2) + f3 * pt3;
  br = nt * (((T(2) * f1) * t1 + (T(3) * f2) * t2) + (T(4) * f3) * t3);
  bt = (-nt) * ((f1 * dt1 + f2 * dt2) + f3 * dt3);
  bp = (nt * inv_s) * sum_p;
}

// dispersion.mu_3d over the field FIELD (WIDE: ad_ne_total's)
template <typename T, int W, int FIELD, bool WIDE>
__device__ __forceinline__ Dual<T, W> ad_mu_3d(const Dual<T, W> (&x)[7],
                                               const KParams<T>& p) {
  using D = Dual<T, W>;
  const D &r = x[0], &theta = x[1], &phi = x[2], &f = x[6];
  if constexpr (FIELD == DIPOLE) {
    // dipole.b_vec_colat; medium.mlat_3d is the same pi/2 - theta, and
    // mlon_3d is phi
    const D lat = T(kPi / 2.0) - theta;
    const D inv_r3 = rdiv(T(1), (r * r) * r);
    const D sl = d_sin(lat), cl = d_cos(lat);
    const D br = (p.neg2b0 * inv_r3) * sl;
    const D bt = (p.negb0 * inv_r3) * cl;
    const D ne = ad_ne_total<T, W, WIDE>(r, sl, cl, phi, p.mlt_on, p);
    return ad_mu_3d_tail<T, W, T>(br, bt, T(0), x[3], x[4], x[5], ne, f, p);
  } else {
    const D st = d_sin(theta), ct = d_cos(theta);
    const D sp = d_sin(phi), cp = d_cos(phi);
    D m_r, m_t, m_p, br, bt, bp;
    ad_moment(st, ct, sp, cp, p, m_r, m_t, m_p);
    if constexpr (FIELD == TILTED) {  // dipole.tilted_field
      const D inv_r = rdiv(T(1), r);
      const D k = p.b0 * ((inv_r * inv_r) * inv_r);
      const D k2 = T(2) * k;
      br = k2 * m_r;
      bt = (-k) * m_t;
      bp = (-k) * m_p;
    } else {
      ad_igrf(r, st, ct, sp, cp, p, br, bt, bp);
    }
    D mlat, mlon;
    ad_magnetic_coords(st, ct, sp, cp, m_r, p, mlat, mlon);
    const D ne = ad_ne_total<T, W, WIDE>(r, d_sin(mlat), d_cos(mlat), mlon,
                                         p.mlt_on, p);
    return ad_mu_3d_tail<T, W, D>(br, bt, bp, x[3], x[4], x[5], ne, f, p);
  }
}

// the frame's mu at dual inputs d
template <typename T, int W, int FRAME, int FIELD, bool WIDE, int N>
__device__ __forceinline__ Dual<T, W> ad_mu(const Dual<T, W> (&d)[N],
                                            const KParams<T>& p) {
  if constexpr (FRAME == KIM3D) {
    return ad_mu_3d<T, W, FIELD, WIDE>(d, p);
  } else if constexpr (FRAME == COLAT2D) {
    // dispersion.mu_2d_colat: lat = pi/2 - theta, formed in T
    return ad_mu_2d(d[0], T(kPi / 2.0) - d[1], d[2], d[3], p);
  } else {
    return ad_mu_2d(d[0], d[1], d[2], d[3], p);
  }
}

// mu and its N partials at the inputs x: passes of W tangents each, input
// i seeded with the unit tangent of its own index
template <typename T, int FRAME, int FIELD, int N, bool WIDE>
__device__ __forceinline__ T ad_mu_grads(const T (&x)[N],
                                         const KParams<T>& p, T (&g)[N]) {
  constexpr int W = N == 7 ? kAdWidth3D : kAdWidth2D;
  using D = Dual<T, W>;
  T mu = T(0);
#pragma unroll
  for (int q = 0; q < N; q += W) {
    D d[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      d[i].v = x[i];
#pragma unroll
      for (int k = 0; k < W; ++k) d[i].t[k] = i == q + k ? T(1) : T(0);
    }
    const D m = ad_mu<T, W, FRAME, FIELD, WIDE>(d, p);
    mu = m.v;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (q + k < N) g[q + k] = m.t[k];
  }
  return mu;
}

// ... the same on a group of G >= N lanes (the group body): lane j of the
// group seeds input j alone (W = 1; a lane past N seeds none), so that it
// forms the value chain and the one tangent row that the pass above forms
// as its row j, by the same operations in the same order; the N rows then
// reach every lane of the group by shuffles within it (the group's lanes
// hold the same values, so they reach each shuffle together; a double
// goes as two 32-bit halves, both from the same lane)
template <typename T, int FRAME, int FIELD, int N, int G>
__device__ __forceinline__ T ad_mu_grads_group(const T (&x)[N],
                                               const KParams<T>& p,
                                               T (&g)[N]) {
  static_assert(G >= N && 32 % G == 0, "a group: N lanes or more of a warp");
  using D = Dual<T, 1>;
  const unsigned lane = threadIdx.x & 31u;
  const int j = int(lane & unsigned(G - 1));
  const unsigned mask = ((1u << G) - 1u) << (lane & ~unsigned(G - 1));
  D d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i].v = x[i];
    d[i].t[0] = i == j ? T(1) : T(0);
  }
  const D m = ad_mu<T, 1, FRAME, FIELD, false>(d, p);
#pragma unroll
  for (int k = 0; k < N; ++k) g[k] = __shfl_sync(mask, m.t[0], k, G);
  return m.v;
}

// the partials of the one-thread body (G = 0) or of a group of G lanes
template <typename T, int FRAME, int FIELD, int N, bool WIDE, int G>
__device__ __forceinline__ T ad_partials(const T (&x)[N],
                                         const KParams<T>& p, T (&g)[N]) {
  if constexpr (G > 0)
    return ad_mu_grads_group<T, FRAME, FIELD, N, G>(x, p, g);
  else
    return ad_mu_grads<T, FRAME, FIELD, N, WIDE>(x, p, g);
}

// ops/rhs.py's right-hand sides over the autodiff set (gradients.py): the
// 2D rows of rhs_2d_lat and rhs_2d_colat (legacy_freq_state: the frequency
// read as f + T), or rhs_3d's Kimura rows; WIDE: ad_ne_total's; G: the
// lanes of a group in the group body, 0 in the one-thread body
template <typename T, int FRAME, int FIELD, bool WIDE, int G = 0>
__device__ __forceinline__ void rhs_ad_rows(const T* u, T f,
                                            const KParams<T>& p, T* out) {
  if constexpr (FRAME == KIM3D) {
    const T x[7] = {u[0], u[1], u[2], u[3], u[4], u[5], f};
    T g[7];
    const T mu = ad_partials<T, FRAME, FIELD, 7, WIDE, G>(x, p, g);
    kimura_rows(u, f, mu, g[0], g[1], g[2], g[3], g[4], g[5], g[6],
                kim_trig(u), out);
  } else {
    const T r = u[0], chi = u[2];
    const T fr = p.legacy_freq ? f + u[3] : f;
    const T x[4] = {r, u[1], chi, fr};
    T g[4];
    const T mu = ad_partials<T, FRAME, FIELD, 4, WIDE, G>(x, p, g);
    const T sc = d_sin(chi), cc = d_cos(chi);
    const T inv_mu2 = T(1) / (mu * mu);
    const T inv_mu2_r = inv_mu2 * (T(1) / r);
    // g: dmu/dr, dmu/dlat (colat: dmu/dtheta), dmu/dpsi, dmu/df
    if constexpr (FRAME == COLAT2D) {
      out[0] = inv_mu2 * (mu * cc - g[2] * sc);
      out[1] = inv_mu2_r * (mu * sc + g[2] * cc);
    } else {
      out[0] = inv_mu2 * (mu * cc + g[2] * sc);
      out[1] = inv_mu2_r * (mu * sc - g[2] * cc);
    }
    out[2] = inv_mu2_r * (g[1] * cc - (r * g[0] + mu) * sc);
    out[3] = T(kREOverC) * (T(1) + ((fr * mu) * inv_mu2) * g[3]);
  }
}

// the AD instances' right-hand side, and AD_ANY's
template <typename T, int FRAME, int FIELD>
__device__ __noinline__ void rhs_ad(const T* u, T f, const KParams<T>& p,
                                    T* out) {
  rhs_ad_rows<T, FRAME, FIELD, false>(u, f, p, out);
}

template <typename T, int FRAME, int FIELD>
__device__ __noinline__ void rhs_ad_any(const T* u, T f, const KParams<T>& p,
                                        T* out) {
  rhs_ad_rows<T, FRAME, FIELD, true>(u, f, p, out);
}

// the group body's right-hand side (group_instance), G lanes a ray
template <typename T, int FRAME, int FIELD, int G>
__device__ __noinline__ void rhs_ad_group(const T* u, T f,
                                          const KParams<T>& p, T* out) {
  rhs_ad_rows<T, FRAME, FIELD, false, G>(u, f, p, out);
}

#undef AD_LOOP

// the frame's right-hand side; K > 0: the team body's (tm), K < 0: the
// group body's (-K lanes a ray), else the one-thread body's
template <typename T, int FRAME, int MEDIUM, int FIELD, int K>
__device__ __forceinline__ void rhs(const T* u, T f, const KParams<T>& p,
                                    T* out, Team<T>& tm) {
  if constexpr (MEDIUM == AD) {
    if constexpr (K < 0) {
      rhs_ad_group<T, FRAME, FIELD, -K>(u, f, p, out);
    } else {
      static_assert(K == 0, "the AD instances take no team body");
      rhs_ad<T, FRAME, FIELD>(u, f, p, out);
    }
  } else if constexpr (MEDIUM == AD_ANY) {
    static_assert(K == 0, "the AD_ANY instances take the one-thread body");
    rhs_ad_any<T, FRAME, FIELD>(u, f, p, out);
  } else if constexpr (FIELD != DIPOLE) {
    if constexpr (K > 0) {
      static_assert(MEDIUM == FULL, "the general-field team body serves FULL");
      rhs_general_team<T, K>(u, f, p, out, tm);
    } else {
      rhs_3d_general<T, MEDIUM, FIELD>(u, f, p, out);
    }
  } else if constexpr (FRAME == KIM3D) {
    if constexpr (K > 0) {
      static_assert(MEDIUM == FULL, "the 3D team body serves FULL");
      rhs_3d_team<T, K>(u, f, p, out, tm);
    } else {
      rhs_3d<T, MEDIUM>(u, f, p, out);
    }
  } else {
    static_assert(K == 0, "the team body serves the 3D frame");
    // legacy_freq_state (ops/rhs.py): the frequency read as f + T
    T fr = f;
    if constexpr (ref_modes(MEDIUM)) {
      if (p.legacy_freq) fr = f + u[3];
    }
    if constexpr (FRAME == COLAT2D)
      rhs_2d_colat<T, MEDIUM>(u, fr, p, out);
    else
      rhs_2d_lat<T, MEDIUM>(u, fr, p, out);
  }
}

// integrate/solve.py::_arc_rate: ds/dtau from the FSAL carry k1
template <typename T, int N>
__device__ __forceinline__ T arc_rate(const T u[N], const T k1[N]) {
  const T r = u[0];
  T s2 = k1[0] * k1[0] + (r * k1[1]) * (r * k1[1]);
  if constexpr (N >= 7) {
    const T vp = r * d_sin(u[1]) * k1[2];
    s2 = s2 + vp * vp;
  }
  return d_sqrt(s2);
}

// integrate/solve.py::_local_arc_ceiling: r/4.5 tightened near each shell
// to w + |r - L cos^2(lat)| (the knee first, in the JAX order), lat from
// the frame's lat_sign/lat_offset map (events.lat_of), times frac. The
// 1/4.5 is a product of Python floats there, formed in double here. WIDE
// (the wide media): the shells past kMaxShells from their buffer
template <typename T, bool WIDE = false>
__device__ __forceinline__ T local_arc_ceiling(const T* u,
                                               const KParams<T>& p) {
  const T r = u[0];
  T g = r * T(1.0 / 4.5);
  const T c = d_cos(p.lat_sign * u[1] + p.lat_offset);
  const T c2 = c * c;
#pragma unroll
  for (int k = 0; k < kMaxShells; ++k) {
    if (k >= p.n_shells) break;
    g = jmin(g, p.shell_w[k] + d_abs(r - p.shell_l[k] * c2));
  }
  if constexpr (WIDE) {
    for (int k = kMaxShells; k < p.n_shells; ++k) {
      const T* sh = wide_params(p).shell_ext + 2 * (k - kMaxShells);
      g = jmin(g, sh[1] + d_abs(r - sh[0] * c2));
    }
  }
  return p.ds_local_frac * g;
}

// _step_one's step ceiling of the state (u, k1): dt_max, tightened by the
// arc ceiling ds / (ds/dtau) where ds is ds_max or, in the instances of
// the extended media, the local ceiling (clamped by ds_max where that is on too)
template <typename T, int N, int MEDIUM>
__device__ __forceinline__ T step_ceiling(const T u[N], const T k1[N],
                                          const KParams<T>& p) {
  bool local = false;
  if constexpr (extended(MEDIUM)) local = p.ds_local_on;
  if (!local && !p.ds_on) return p.dt_max;
  T ds = p.ds_max;
  if constexpr (extended(MEDIUM)) {
    if (local) {
      ds = local_arc_ceiling<T, wide(MEDIUM)>(u, p);
      if (p.ds_on) ds = jmin(ds, p.ds_max);
    }
  }
  const T arc_cap =
      jmax(ds / jmax(arc_rate<T, N>(u, k1), T(1.0e-30)), p.dt_min);
  return jmin(p.dt_max, arc_cap);
}

// the mean over the N components: a Python-integer divisor, hence a
// product with its reciprocal on the card (exact for N = 4)
template <typename T, int N>
__device__ __forceinline__ T err_norm(const T ev[N], const T u[N],
                                      const T u_new[N], const KParams<T>& p) {
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T scale = p.atol + p.rtol * jmax(d_abs(u[j]), d_abs(u_new[j]));
    const T x = ev[j] / scale;
    acc = j == 0 ? x * x : acc + x * x;
  }
  return d_sqrt(acc * recip(T(N)));
}

// integrate/steppers.py::bs3_step (Bogacki-Shampine 3(2), FSAL). The
// instances of stage_loop run the three right-hand sides through one
// inlined copy, a loop over the stages: the stage's input and its k slot
// by constant indices (selects over named registers; an index known only
// at run time would put them in local memory), every expression as in the
// unrolled form, so the two agree bit for bit
template <typename T, int FRAME, int MEDIUM, int FIELD, int K,
          int N = FrameDim<FRAME>::N>
__device__ __forceinline__ T bs3_step(const T u[N], const T k1[N], T h, T f,
                                      const KParams<T>& p, T u_new[N],
                                      T k_end[N], T incr[N], Team<T>& tm) {
  T y[N], k2[N], k3[N], ev[N];
  if constexpr (stage_loop(sizeof(T) == 8 ? 1 : 0, BS3, FRAME, MEDIUM,
                           FIELD)) {
#pragma unroll 1
    for (int s = 0; s < 3; ++s) {
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < N; ++j) y[j] = u[j] + (T(0.5) * h) * k1[j];
      } else if (s == 1) {
#pragma unroll
        for (int j = 0; j < N; ++j) y[j] = u[j] + (T(0.75) * h) * k2[j];
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          incr[j] = h * (T(2.0 / 9.0) * k1[j] + T(1.0 / 3.0) * k2[j] +
                         T(4.0 / 9.0) * k3[j]);
          u_new[j] = u[j] + incr[j];
          y[j] = u_new[j];
        }
      }
      T k[N];
      rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k, tm);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (s == 0)
          k2[j] = k[j];
        else if (s == 1)
          k3[j] = k[j];
        else
          k_end[j] = k[j];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = u[j] + (T(0.5) * h) * k1[j];
    rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k2, tm);
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = u[j] + (T(0.75) * h) * k2[j];
    rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k3, tm);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      incr[j] = h * (T(2.0 / 9.0) * k1[j] + T(1.0 / 3.0) * k2[j] +
                     T(4.0 / 9.0) * k3[j]);
      u_new[j] = u[j] + incr[j];
    }
    rhs<T, FRAME, MEDIUM, FIELD, K>(u_new, f, p, k_end, tm);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    ev[j] = h * (T(2.0 / 9.0 - 7.0 / 24.0) * k1[j] +
                 T(1.0 / 3.0 - 0.25) * k2[j] +
                 T(4.0 / 9.0 - 1.0 / 3.0) * k3[j] - T(0.125) * k_end[j]);
  return err_norm<T, N>(ev, u, u_new, p);
}

// integrate/steppers.py::dopri5_step (Dormand-Prince 5(4), FSAL); the
// zero tableau entries stay in the sums, as they do in the JAX package
template <typename T, int FRAME, int MEDIUM, int FIELD, int K,
          int N = FrameDim<FRAME>::N>
__device__ __forceinline__ T dopri5_step(const T u[N], const T k1[N], T h,
                                         T f, const KParams<T>& p,
                                         T u_new[N], T k_end[N], T incr[N],
                                         Team<T>& tm) {
  T y[N], k2[N], k3[N], k4[N], k5[N], k6[N], ev[N];
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = u[j] + h * (T(0.2) * k1[j]);
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k2, tm);
#pragma unroll
  for (int j = 0; j < N; ++j)
    y[j] = u[j] + h * (T(3.0 / 40.0) * k1[j] + T(9.0 / 40.0) * k2[j]);
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k3, tm);
#pragma unroll
  for (int j = 0; j < N; ++j)
    y[j] = u[j] + h * (T(44.0 / 45.0) * k1[j] + T(-56.0 / 15.0) * k2[j] +
                       T(32.0 / 9.0) * k3[j]);
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k4, tm);
#pragma unroll
  for (int j = 0; j < N; ++j)
    y[j] = u[j] + h * (T(19372.0 / 6561.0) * k1[j] +
                       T(-25360.0 / 2187.0) * k2[j] +
                       T(64448.0 / 6561.0) * k3[j] +
                       T(-212.0 / 729.0) * k4[j]);
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k5, tm);
#pragma unroll
  for (int j = 0; j < N; ++j)
    y[j] = u[j] + h * (T(9017.0 / 3168.0) * k1[j] +
                       T(-355.0 / 33.0) * k2[j] +
                       T(46732.0 / 5247.0) * k3[j] +
                       T(49.0 / 176.0) * k4[j] +
                       T(-5103.0 / 18656.0) * k5[j]);
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k6, tm);
  // the 7th stage is evaluated at u + h * (b5 . k) == u_new (FSAL)
#pragma unroll
  for (int j = 0; j < N; ++j) {
    incr[j] = h * (T(35.0 / 384.0) * k1[j] + T(0.0) * k2[j] +
                   T(500.0 / 1113.0) * k3[j] + T(125.0 / 192.0) * k4[j] +
                   T(-2187.0 / 6784.0) * k5[j] + T(11.0 / 84.0) * k6[j]);
    u_new[j] = u[j] + incr[j];
  }
  rhs<T, FRAME, MEDIUM, FIELD, K>(u_new, f, p, k_end, tm);
#pragma unroll
  for (int j = 0; j < N; ++j)
    ev[j] = h * (T(35.0 / 384.0 - 5179.0 / 57600.0) * k1[j] +
                 T(0.0 - 0.0) * k2[j] +
                 T(500.0 / 1113.0 - 7571.0 / 16695.0) * k3[j] +
                 T(125.0 / 192.0 - 393.0 / 640.0) * k4[j] +
                 T(-2187.0 / 6784.0 - -92097.0 / 339200.0) * k5[j] +
                 T(11.0 / 84.0 - 187.0 / 2100.0) * k6[j] +
                 T(0.0 - 1.0 / 40.0) * k_end[j]);
  return err_norm<T, N>(ev, u, u_new, p);
}

// integrate/steppers.py::rk4_step (classic RK4, FSAL: k_end = rhs(u_new)
// is the next step's k1); h / 6 is a reciprocal product, as the plain
// version's quotient by a Python scalar is on the card
template <typename T, int FRAME, int MEDIUM, int FIELD, int K,
          int N = FrameDim<FRAME>::N>
__device__ __forceinline__ void rk4_step(const T u[N], const T k1[N], T h,
                                         T f, const KParams<T>& p,
                                         T u_new[N], T k_end[N], T incr[N],
                                         Team<T>& tm) {
  T y[N], k2[N], k3[N], k4[N];
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = u[j] + (T(0.5) * h) * k1[j];
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k2, tm);
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = u[j] + (T(0.5) * h) * k2[j];
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k3, tm);
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = u[j] + h * k3[j];
  rhs<T, FRAME, MEDIUM, FIELD, K>(y, f, p, k4, tm);
  const T h6 = h * recip(T(6));
#pragma unroll
  for (int j = 0; j < N; ++j) {
    incr[j] = h6 * (k1[j] + T(2) * k2[j] + T(2) * k3[j] + k4[j]);
    u_new[j] = u[j] + incr[j];
  }
  rhs<T, FRAME, MEDIUM, FIELD, K>(u_new, f, p, k_end, tm);
}

// integrate/events.py::classify_step, with its priority order
template <typename T, int N>
__device__ __forceinline__ int classify_step(const T u0[N], const T u1[N],
                                             T t1, const KParams<T>& p) {
  const bool surface = u1[0] <= p.r_floor;
  const T lat0 = p.lat_sign * u0[1] + p.lat_offset;
  const T lat1 = p.lat_sign * u1[1] + p.lat_offset;
  const bool equator = p.equator_on && (jsign(lat1) != jsign(lat0));
  const bool escaped = u1[0] >= p.r_ceil;
  const bool group = u1[N - 1] >= p.group_time_max;
  const bool phase = t1 >= p.t_max;
  bool invalid = false;
#pragma unroll
  for (int j = 0; j < N; ++j) invalid = invalid || !isfinite(u1[j]);
  const bool retro = p.retro_on && (u1[N - 1] < T(0));
  int st = phase ? MAX_PHASE_TIME : ACTIVE;
  if (retro) st = EVANESCENT;
  if (group) st = MAX_GROUP_TIME;
  if (escaped) st = ESCAPED;
  if (equator) st = HIT_EQUATOR;
  if (surface) st = HIT_EARTH;
  if (invalid) st = INVALID;
  return st;
}

// the rays that refine_events refines: HIT_EARTH, and HIT_EQUATOR where
// the equator stop is on (with it off the plain version leaves such a ray
// of a resumed carry as it is)
template <typename T>
__device__ __forceinline__ bool refines(int status, const KParams<T>& p) {
  return status == HIT_EARTH || (status == HIT_EQUATOR && p.equator_on);
}

// integrate/events.py::hermite_interp's weights at tau over a step of dt
// (h10 and h11 times dt), in the plain version's operation order
template <typename T>
struct Hermite {
  T h00, h10dt, h01, h11dt;
};

template <typename T>
__device__ __forceinline__ Hermite<T> hermite(T tau, T dt) {
  const T t2 = tau * tau;
  const T t3 = t2 * tau;
  return {(T(2) * t3 - T(3) * t2) + T(1), ((t3 - T(2) * t2) + tau) * dt,
          T(-2) * t3 + T(3) * t2, (t3 - t2) * dt};
}

template <typename T>
__device__ __forceinline__ T hermite_at(const Hermite<T>& h, T u0, T du0,
                                        T u1, T du1) {
  return ((h.h00 * u0 + h.h10dt * du0) + h.h01 * u1) + h.h11dt * du1;
}

// integrate/solve.py::refine_events for one ray that refines: 32
// bisections (events.refine_crossing) of the cubic Hermite interpolant of
// the terminating step (u_prev, k0 = rhs(u_prev)) -> (u, k1) for the zero
// of r - r_floor (HIT_EARTH) or of the latitude (HIT_EQUATOR, events.
// lat_of), then u at the crossing and t = t - (1 - tau) dt_prev. The value
// functions read one component, and the interpolant is componentwise, so
// the bisection forms only that component's, selected by constant indices
// (an index known only at run time would put the carry's arrays in local
// memory); torch.sign's sign(NaN) = 0
template <typename T, int N>
__device__ __forceinline__ void refine_event(int status, const T u_prev[N],
                                             const T k0[N], const T k1[N],
                                             T dt_prev, const KParams<T>& p,
                                             T u[N], T& t) {
  const bool eq = status == HIT_EQUATOR;
  const T x0 = eq ? u_prev[1] : u_prev[0], dx0 = eq ? k0[1] : k0[0];
  const T x1 = eq ? u[1] : u[0], dx1 = eq ? k1[1] : k1[0];
  const auto value = [&](T x) {
    return eq ? p.lat_sign * x + p.lat_offset : x - p.r_floor;
  };
  const T sign0 = tsign(value(x0));
  T lo = T(0), hi = T(1);
#pragma unroll 1
  for (int it = 0; it < 32; ++it) {
    const T mid = T(0.5) * (lo + hi);
    const T vm = value(hermite_at(hermite(mid, dt_prev), x0, dx0, x1, dx1));
    if (tsign(vm) == sign0)
      lo = mid;
    else
      hi = mid;
  }
  const T tau = T(0.5) * (lo + hi);
  const Hermite<T> h = hermite(tau, dt_prev);
#pragma unroll
  for (int j = 0; j < N; ++j)
    u[j] = hermite_at(h, u_prev[j], k0[j], u[j], k1[j]);
  t = t - (T(1) - tau) * dt_prev;
}

// K = 0: the one-thread body (a block of kThreads rays, one thread each);
// K > 0: the team body (a block of K warps serving 32 rays, lane l of every
// warp serving ray l); K < 0: the group body (a block of kThreads lanes,
// -K lanes a ray)
template <typename T, int STEPPER, int FRAME, int MEDIUM, int FIELD, int K>
__global__ void __launch_bounds__(K > 0 ? 32 * K : kThreads,
                                  K > 0 ? kTeamBlocks : 1)
    step_chunk_kernel(T* __restrict__ u_g, T* __restrict__ k1_g,
                      T* __restrict__ u_prev_g, T* __restrict__ u_lo_g,
                      T* __restrict__ t_g, T* __restrict__ dt_g,
                      T* __restrict__ errold_g, T* __restrict__ dt_prev_g,
                      int* __restrict__ status_g, int* __restrict__ n_acc_g,
                      int* __restrict__ n_rej_g, int* __restrict__ rejected_g,
                      int* __restrict__ n_tiny_g, int* __restrict__ caution_g,
                      const T* __restrict__ f_g, long long B, int n_steps,
                      bool finish, bool fresh, bool sparse,
                      typename ParamsOf<T, wide(MEDIUM)>::type p) {
  constexpr int N = FrameDim<FRAME>::N;
  constexpr int DT = sizeof(T) == 8 ? 1 : 0;
  Team<T> tm{nullptr, 0, 0, true};
  long long i;
  bool real = true;
  if constexpr (K < 0) {
    i = (blockIdx.x * (long long)kThreads + threadIdx.x) / -K;
    if (i >= B) return;
  } else if constexpr (K == 0) {
    i = blockIdx.x * (long long)kThreads + threadIdx.x;
    if constexpr (chain_instance(DT, STEPPER, FRAME, MEDIUM, FIELD)) {
      // the tail layout: ray i on lane 0 of warp i of the launch, the
      // other lanes leave
      if (sparse) {
        if ((threadIdx.x & 31) != 0) return;
        i = blockIdx.x * (long long)(kThreads / 32) + (threadIdx.x >> 5);
      }
    }
    if (i >= B) return;
  } else {
    // the same for the whole block
    if (n_steps <= 0 && !finish && !fresh) return;
    // the exchange: dynamic shared memory, sized at the launch
    extern __shared__ __align__(16) unsigned char team_xch[];
    tm = Team<T>{reinterpret_cast<T*>(team_xch), int(threadIdx.x >> 5),
                 int(threadIdx.x & 31), true};
    // a lane with no ray (B not a multiple of 32) rides along on ray B - 1,
    // never live and never written
    i = blockIdx.x * 32LL + tm.lane;
    real = i < B;
    if (!real) i = B - 1;
    if (tm.warp > 0) {
      team_helper<T, K, FIELD>(f_g[i], p, tm);
      return;
    }
  }
  int status = status_g[i];
  // a ray that is not ACTIVE stays as it is (_step_one is a no-op there),
  // unless the launch computes its first right-hand side (fresh) or refines
  // its event (finish): in the one-thread body its thread leaves (in the
  // group body its group, whose lanes read the same carry); in the team
  // body its lane of warp 0 rides along with its writes masked until the
  // warp's last ray stops, and the helpers skip it
  const bool touched = fresh || (finish && refines(status, p));
  if constexpr (K <= 0) {
    if (!touched && (status != ACTIVE || n_steps <= 0)) return;
  } else {
    if (!real) status = -1;
  }
  const bool write_back = K <= 0 || status == ACTIVE || (real && touched);

  T u[N], k1[N], u_prev[N], u_lo[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    u[j] = u_g[j * B + i];
    k1[j] = k1_g[j * B + i];
    u_prev[j] = u_prev_g[j * B + i];
    u_lo[j] = u_lo_g[j * B + i];
  }
  T t = t_g[i], dt = dt_g[i], errold = errold_g[i], dt_prev = dt_prev_g[i];
  int n_acc = n_acc_g[i], n_rej = n_rej_g[i], rejected = rejected_g[i];
  int n_tiny = n_tiny_g[i], caution = caution_g[i];
  const T f = f_g[i];

  // The right-hand sides outside the attempts -- fresh's k1 = rhs(u)
  // (init_carry's, every ray) before them, finish's k0 = rhs(u_prev) after
  // them -- share one inlined evaluation: pass 0 (fresh), pass 1 the
  // attempts, pass 2 (finish). A copy of the right-hand side inlined at
  // each place slowed the attempts of some instances by up to 10% (PERF.md)
  bool ev = false;  // finish: the ray refines
#pragma unroll 1
  for (int pass = fresh ? 0 : 1; pass < 3; ++pass) {
    if (pass == 1) {
      for (int s = 0; s < n_steps && (K > 0 || status == ACTIVE); ++s) {
        if constexpr (K > 0) {
          // warp 0 leaves together, once none of its rays is ACTIVE
          if (!__any_sync(0xffffffffu, status == ACTIVE)) break;
          tm.live = status == ACTIVE;
        }
        if constexpr (STEPPER == RK4) {
          // adaptive=False: the carry's dt within the phase-path budget, no
          // ceiling; every step is accepted, with no stall flag; dt, errold
          // and n_tiny stay, caution counts down
          const T dt_eff = jmin(dt, jmax(p.t_max - t, p.dt_min));
          T u_new[N], k_end[N], incr[N];
          rk4_step<T, FRAME, MEDIUM, FIELD, K>(u, k1, dt_eff, f, p, u_new,
                                               k_end, incr, tm);
          if constexpr (K > 0) {
            if (status != ACTIVE) continue;  // a stopped ray's writes, masked
          }
          const T t1 = t + dt_eff;
          status = classify_step<T, N>(u, u_new, t1, p);
          if (status == HIT_EARTH || status == HIT_EQUATOR) {
#pragma unroll
            for (int j = 0; j < N; ++j) u_prev[j] = u[j];
            dt_prev = dt_eff;
          }
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const T d = incr[j] + u_lo[j];
            const T uc = u[j] + d;
            u_lo[j] = d - (uc - u[j]);
            u[j] = uc;
            k1[j] = k_end[j];
          }
          t = t1;
          n_acc += 1;
          rejected = 0;
          caution = min(max(caution - 1, 0), 60);
        } else {
          // the step ceiling, then no overshoot of the phase-path budget
          const T dt_cap = step_ceiling<T, N, MEDIUM>(u, k1, p);
          T dt_eff = jmin(dt, dt_cap);
          dt_eff = jmin(dt_eff, jmax(p.t_max - t, p.dt_min));

          T u_new[N], k_end[N], incr[N];
          T err_raw;
          if constexpr (STEPPER == BS3)
            err_raw = bs3_step<T, FRAME, MEDIUM, FIELD, K>(
                u, k1, dt_eff, f, p, u_new, k_end, incr, tm);
          else
            err_raw = dopri5_step<T, FRAME, MEDIUM, FIELD, K>(
                u, k1, dt_eff, f, p, u_new, k_end, incr, tm);
          if constexpr (K > 0) {
            if (status != ACTIVE) continue;  // a stopped ray's writes, masked
          }
          const bool accept = err_raw <= p.accept_tol;

          const T t1 = t + dt_eff;
          int status1 = classify_step<T, N>(u, u_new, t1, p);
          if (status1 == ACTIVE && dt_eff <= p.dt_min2) status1 = DT_UNDERFLOW;
          const bool terminal = status1 == HIT_EARTH || status1 == HIT_EQUATOR;

          // PI controller; a non-finite error estimate is a hard rejection
          const T err =
              isfinite(err_raw) ? jmax(err_raw, T(1.0e-10)) : T(1.0e10);
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
          const T dt_next = jmin(
              jmax(dt_eff * (accept ? fac_acc : fac_rej), p.dt_min), dt_cap);
          const bool underflow = !accept && dt_eff <= p.dt_min_uf;

          int status_new =
              accept ? status1 : (underflow ? DT_UNDERFLOW : ACTIVE);
          // device-side wedge retirement (SolverConfig.stall_dt_factor)
          const bool tiny = p.tiny_on && dt_eff < p.tiny_thr;
          const int n_tiny_new = accept ? (tiny ? n_tiny + 1 : 0) : n_tiny;
          if (accept && double(n_tiny_new) >= p.stall_count &&
              status_new == ACTIVE)
            status_new = DT_UNDERFLOW;

          if (accept) {
            if (terminal) {  // snapshot the terminating step for refine_events
#pragma unroll
              for (int j = 0; j < N; ++j) u_prev[j] = u[j];
              dt_prev = dt_eff;
            }
            // compensated state update (fast two-sum)
#pragma unroll
            for (int j = 0; j < N; ++j) {
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
      }
      // finish: refine_events after the loop, for every ray that ends on
      // an event, whichever launch retired it. k0 is the instance's own
      // right-hand side at u_prev (the FSAL k1 of the terminating step's
      // start is not bitwise rhs(u_prev) after the two-sum update). Here,
      // once the warp has converged, it costs about one attempt per warp
      // and adds no live registers to the loop; in the team body warp 0
      // posts u_prev to the helpers as for any stage, for the lanes that
      // refine
      if (!finish) break;
      ev = refines(status, p);
      bool any = ev;
      if constexpr (K > 0) any = __any_sync(0xffffffffu, ev);
      if (!any) break;
      continue;
    }
    T x[N], out[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = pass == 0 ? u[j] : u_prev[j];
    if constexpr (K > 0) tm.live = pass == 0 ? real : ev;
    rhs<T, FRAME, MEDIUM, FIELD, K>(x, f, p, out, tm);
    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) k1[j] = out[j];
    } else if (ev) {
      refine_event<T, N>(status, u_prev, out, k1, dt_prev, p, u, t);
    }
  }

  if constexpr (K > 0) {
    tm.xch[kIn3D * 32 + tm.lane] = T(-1);
    __syncthreads();  // the helpers leave
  }
  if (!write_back) return;
  if constexpr (K < 0) {
    // the group's lanes hold the same carry: its first lane writes it
    if ((threadIdx.x & unsigned(-K - 1)) != 0) return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
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

// one launch of the body K (0: the one-thread body) of an instance
template <typename T, int STEPPER, int FRAME, int MEDIUM, int FIELD, int K>
void launch_body(void** ptrs, long long B, int n_steps, int flags,
                 bool sparse, const StepParams& h, cudaStream_t stream) {
  const int rays = K > 0   ? 32
                   : K < 0 ? kThreads / -K
                           : (sparse ? kThreads / 32 : kThreads);
  const long long blocks = (B + rays - 1) / rays;
  const size_t xch =
      K > 0 ? 32 * (FIELD == DIPOLE ? Slots3D<T>::end : SlotsGen<T>::end) *
                  sizeof(T)
            : 0;
  step_chunk_kernel<T, STEPPER, FRAME, MEDIUM, FIELD, K>
      <<<(unsigned)blocks, K > 0 ? 32 * K : kThreads, xch, stream>>>(
          (T*)ptrs[0], (T*)ptrs[1], (T*)ptrs[2], (T*)ptrs[3], (T*)ptrs[4],
          (T*)ptrs[5], (T*)ptrs[6], (T*)ptrs[7], (int*)ptrs[8],
          (int*)ptrs[9], (int*)ptrs[10], (int*)ptrs[11], (int*)ptrs[12],
          (int*)ptrs[13], (const T*)ptrs[14], B, n_steps, (flags & 1) != 0,
          (flags & 2) != 0, sparse,
          params_of<T, wide(MEDIUM)>(h, STEPPER));
}

template <typename T, int STEPPER, int FRAME, int MEDIUM, int FIELD>
void launch(void** ptrs, long long B, int n_steps, int flags,
            const StepParams& h, cudaStream_t stream) {
  constexpr int DT = sizeof(T) == 8 ? 1 : 0;
  constexpr int K = team_warps(DT, STEPPER, FRAME, MEDIUM, FIELD);
  // flag bit 2: the tail layout (its instances only): one ray a warp, or
  // over the non-axial fields the team body, whose instances run the
  // launches outside it on the one-thread body
  const bool sparse =
      (flags & 4) != 0 && tail_layout(DT, STEPPER, FRAME, MEDIUM, FIELD);
  if constexpr (general_team(DT, STEPPER, FRAME, MEDIUM, FIELD)) {
    if (!sparse) {
      launch_body<T, STEPPER, FRAME, MEDIUM, FIELD, 0>(ptrs, B, n_steps,
                                                       flags, false, h,
                                                       stream);
      return;
    }
  }
  // flag bit 3: the group body (its instances only)
  if constexpr (group_instance(DT, STEPPER, FRAME, MEDIUM, FIELD)) {
    if ((flags & 8) != 0) {
      launch_body<T, STEPPER, FRAME, MEDIUM, FIELD, -group_lanes(FRAME)>(
          ptrs, B, n_steps, flags, false, h, stream);
      return;
    }
  }
  launch_body<T, STEPPER, FRAME, MEDIUM, FIELD, K>(ptrs, B, n_steps, flags,
                                                   sparse, h, stream);
}

template <typename T, int FRAME, int MEDIUM, int FIELD>
void launch_stepper(int stepper, void** ptrs, long long B, int n_steps,
                    int flags, const StepParams& h, cudaStream_t stream) {
  if (stepper == BS3)
    launch<T, BS3, FRAME, MEDIUM, FIELD>(ptrs, B, n_steps, flags, h, stream);
  else if (stepper == DOPRI5)
    launch<T, DOPRI5, FRAME, MEDIUM, FIELD>(ptrs, B, n_steps, flags, h,
                                            stream);
  else
    launch<T, RK4, FRAME, MEDIUM, FIELD>(ptrs, B, n_steps, flags, h, stream);
}

template <int FRAME, int MEDIUM, int FIELD>
void launch_dtype(int dtype, int stepper, void** ptrs, long long B,
                  int n_steps, int flags, const StepParams& h,
                  cudaStream_t stream) {
  if (dtype == 0)
    launch_stepper<float, FRAME, MEDIUM, FIELD>(stepper, ptrs, B, n_steps,
                                                flags, h, stream);
  else
    launch_stepper<double, FRAME, MEDIUM, FIELD>(stepper, ptrs, B, n_steps,
                                                 flags, h, stream);
}

}  // namespace

// One host entry per (frame, medium, field) combination. A build in parts
// (ops/step_chunk.py::build) compiles this source once per part with
// -DSC_PARTS=17 -DSC_PART=k, each part defining the entries of one frame,
// one non-axial field, (part 5) the ALT medium in the three frames, the
// ALTX medium in the 2D frames (part 6) and the 3D frame (part 7), the AD
// medium in the 2D frames (part 8), the 3D frame over the dipole and the
// tilted dipole (part 9) and over IGRF (part 10), the ANY medium in the 2D
// frames (part 11), the 3D frame (part 12) and over the non-axial fields
// (part 13), or the AD_ANY medium as AD (parts 14-16) (and so
// instantiating only their kernels), and links the parts into one
// library; without the macros one object holds them all.
#ifndef SC_PARTS
#define SC_PARTS 1
#define SC_PART 0
#endif
#define SC_OWNS(PART) (SC_PARTS == 1 || SC_PART == (PART))
#define SC_ENTRY(NAME)                                                   \
  void NAME(int dtype, int stepper, void** ptrs, long long B, int n_steps, \
            int flags, const StepParams& h, cudaStream_t s)
#define SC_DEFINE(NAME, FRAME, MEDIUM, FIELD)                           \
  SC_ENTRY(NAME) {                                                      \
    launch_dtype<FRAME, MEDIUM, FIELD>(dtype, stepper, ptrs, B, n_steps, \
                                       flags, h, s);                    \
  }

SC_ENTRY(launch_lat_axi);
SC_ENTRY(launch_lat_full);
SC_ENTRY(launch_lat_ext);
SC_ENTRY(launch_3d_axi);
SC_ENTRY(launch_3d_full);
SC_ENTRY(launch_3d_ext);
SC_ENTRY(launch_colat_axi);
SC_ENTRY(launch_colat_full);
SC_ENTRY(launch_colat_ext);
SC_ENTRY(launch_tilted_full);
SC_ENTRY(launch_tilted_ext);
SC_ENTRY(launch_igrf_full);
SC_ENTRY(launch_igrf_ext);
SC_ENTRY(launch_lat_alt);
SC_ENTRY(launch_3d_alt);
SC_ENTRY(launch_colat_alt);
SC_ENTRY(launch_lat_altx);
SC_ENTRY(launch_3d_altx);
SC_ENTRY(launch_colat_altx);
SC_ENTRY(launch_lat_ad);
SC_ENTRY(launch_colat_ad);
SC_ENTRY(launch_3d_ad);
SC_ENTRY(launch_tilted_ad);
SC_ENTRY(launch_igrf_ad);
SC_ENTRY(launch_lat_any);
SC_ENTRY(launch_3d_any);
SC_ENTRY(launch_colat_any);
SC_ENTRY(launch_tilted_any);
SC_ENTRY(launch_igrf_any);
SC_ENTRY(launch_lat_ad_any);
SC_ENTRY(launch_3d_ad_any);
SC_ENTRY(launch_colat_ad_any);
SC_ENTRY(launch_tilted_ad_any);
SC_ENTRY(launch_igrf_ad_any);

#if SC_OWNS(0)
SC_DEFINE(launch_lat_axi, LAT2D, AXI, DIPOLE)
SC_DEFINE(launch_lat_full, LAT2D, FULL, DIPOLE)
SC_DEFINE(launch_lat_ext, LAT2D, EXT, DIPOLE)
#endif
#if SC_OWNS(1)
SC_DEFINE(launch_3d_axi, KIM3D, AXI, DIPOLE)
SC_DEFINE(launch_3d_full, KIM3D, FULL, DIPOLE)
SC_DEFINE(launch_3d_ext, KIM3D, EXT, DIPOLE)
#endif
#if SC_OWNS(2)
SC_DEFINE(launch_colat_axi, COLAT2D, AXI, DIPOLE)
SC_DEFINE(launch_colat_full, COLAT2D, FULL, DIPOLE)
SC_DEFINE(launch_colat_ext, COLAT2D, EXT, DIPOLE)
#endif
#if SC_OWNS(3)
SC_DEFINE(launch_tilted_full, KIM3D, FULL, TILTED)
SC_DEFINE(launch_tilted_ext, KIM3D, EXT, TILTED)
#endif
#if SC_OWNS(4)
SC_DEFINE(launch_igrf_full, KIM3D, FULL, IGRF)
SC_DEFINE(launch_igrf_ext, KIM3D, EXT, IGRF)
#endif
#if SC_OWNS(5)
SC_DEFINE(launch_lat_alt, LAT2D, ALT, DIPOLE)
SC_DEFINE(launch_3d_alt, KIM3D, ALT, DIPOLE)
SC_DEFINE(launch_colat_alt, COLAT2D, ALT, DIPOLE)
#endif
#if SC_OWNS(6)
SC_DEFINE(launch_lat_altx, LAT2D, ALTX, DIPOLE)
SC_DEFINE(launch_colat_altx, COLAT2D, ALTX, DIPOLE)
#endif
#if SC_OWNS(7)
SC_DEFINE(launch_3d_altx, KIM3D, ALTX, DIPOLE)
#endif
#if SC_OWNS(8)
SC_DEFINE(launch_lat_ad, LAT2D, AD, DIPOLE)
SC_DEFINE(launch_colat_ad, COLAT2D, AD, DIPOLE)
#endif
#if SC_OWNS(9)
SC_DEFINE(launch_3d_ad, KIM3D, AD, DIPOLE)
SC_DEFINE(launch_tilted_ad, KIM3D, AD, TILTED)
#endif
#if SC_OWNS(10)
SC_DEFINE(launch_igrf_ad, KIM3D, AD, IGRF)
#endif
#if SC_OWNS(11)
SC_DEFINE(launch_lat_any, LAT2D, ANY, DIPOLE)
SC_DEFINE(launch_colat_any, COLAT2D, ANY, DIPOLE)
#endif
#if SC_OWNS(12)
SC_DEFINE(launch_3d_any, KIM3D, ANY, DIPOLE)
#endif
#if SC_OWNS(13)
SC_DEFINE(launch_tilted_any, KIM3D, ANY, TILTED)
SC_DEFINE(launch_igrf_any, KIM3D, ANY, IGRF)
#endif
#if SC_OWNS(14)
SC_DEFINE(launch_lat_ad_any, LAT2D, AD_ANY, DIPOLE)
SC_DEFINE(launch_colat_ad_any, COLAT2D, AD_ANY, DIPOLE)
#endif
#if SC_OWNS(15)
SC_DEFINE(launch_3d_ad_any, KIM3D, AD_ANY, DIPOLE)
SC_DEFINE(launch_tilted_ad_any, KIM3D, AD_ANY, TILTED)
#endif
#if SC_OWNS(16)
SC_DEFINE(launch_igrf_ad_any, KIM3D, AD_ANY, IGRF)
#endif

#if SC_OWNS(0)
// ptrs: u, k1, u_prev, u_lo (n, B); t, dt, errold, dt_prev (B,) of T;
// status, n_accept, n_reject, rejected, n_tiny, caution (B,) int32; f (B,).
// dtype 0 = float, 1 = double; stepper 0 = bs3, 1 = dopri5, 2 = rk4 (fixed
// step); frame 0 = the 2D latitude frame (n = 4), 1 = the 3D frame (n =
// 7), 2 = the 2D colatitude frame (n = 4); medium 0 = the axisymmetric
// medium, 1 = the full density chain, 2 = the full chain with the ion
// species and the local arc ceiling, 3 = the axisymmetric medium under the
// reference scripts' modes (h->ref_grads, h->legacy_freq: the ALT
// instances), 4 = the extended chain (2) under those modes (the ALTX
// instances), 5 = the autodiff set over any medium (the AD instances,
// which read h->legacy_freq in 2D, never h->ref_grads), 6 =
// ANY, the ALTX instances (EXT's over the non-axial fields) with any
// weight, harmonic count and shell count, 7 = AD_ANY, the AD instances with
// any harmonic and shell count (the media 0-5 take the weights 0 and 1
// alone, AD any weight, and at most kMaxHarm harmonics and kMaxShells
// shells; h->mlt_ext and h->shell_ext hold the rest); field 0 = the
// centered dipole, 1 = the tilted dipole, 2 = the IGRF truncation (the
// last two only in the 3D frame over FULL, EXT, AD, ANY and AD_ANY, and
// without the reference scripts' modes). flags: bit 0
// (finish), after the loop, refine the rays that end on HIT_EARTH /
// HIT_EQUATOR in place (integrate/solve.py::refine_events); bit 1 (fresh),
// before it, k1 = rhs(u) for every ray (init_carry's right-hand side);
// bit 2, the tail layout, one ray a warp (ignored by the instances that
// step_chunk_tail_layout does not name); bit 3, the group body (ignored by
// the instances that step_chunk_group_lanes does not name). Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int step_chunk_launch(int dtype, int stepper, int frame,
                                 int medium, int field, void** ptrs,
                                 long long B, int n_steps, int flags,
                                 const StepParams* h, void* stream) {
  // [frame, or the non-axial field in rows 3 and 4][medium]
  using Entry = void (*)(int, int, void**, long long, int, int,
                         const StepParams&, cudaStream_t);
  static const Entry kEntry[5][8] = {
      {launch_lat_axi, launch_lat_full, launch_lat_ext, launch_lat_alt,
       launch_lat_altx, launch_lat_ad, launch_lat_any, launch_lat_ad_any},
      {launch_3d_axi, launch_3d_full, launch_3d_ext, launch_3d_alt,
       launch_3d_altx, launch_3d_ad, launch_3d_any, launch_3d_ad_any},
      {launch_colat_axi, launch_colat_full, launch_colat_ext,
       launch_colat_alt, launch_colat_altx, launch_colat_ad,
       launch_colat_any, launch_colat_ad_any},
      {nullptr, launch_tilted_full, launch_tilted_ext, nullptr, nullptr,
       launch_tilted_ad, launch_tilted_any, launch_tilted_ad_any},
      {nullptr, launch_igrf_full, launch_igrf_ext, nullptr, nullptr,
       launch_igrf_ad, launch_igrf_any, launch_igrf_ad_any},
  };
  const bool fractional = (h->ps_weight != 0.0 && h->ps_weight != 1.0) ||
                          (h->de_weight != 0.0 && h->de_weight != 1.0);
  if (B <= 0) return 0;
  if ((dtype != 0 && dtype != 1) ||
      (stepper != BS3 && stepper != DOPRI5 && stepper != RK4) ||
      (frame != LAT2D && frame != KIM3D && frame != COLAT2D) ||
      medium < AXI || medium > AD_ANY ||
      (field != DIPOLE && field != TILTED && field != IGRF) ||
      (field != DIPOLE &&
       (frame != KIM3D || medium == AXI || medium == ALT || medium == ALTX)) ||
      (h->ref_grads != 0.0 && (!ref_modes(medium) || field != DIPOLE)) ||
      (h->legacy_freq != 0.0 && !ref_modes(medium) && !autodiff(medium)) ||
      (h->legacy_freq != 0.0 && frame == KIM3D) ||
      h->n_harm < 0.0 || h->n_shells < 0.0 ||
      (h->n_harm > kMaxHarm && (!wide(medium) || h->mlt_ext == nullptr)) ||
      (h->n_shells > kMaxShells &&
       (!wide(medium) || h->shell_ext == nullptr)) ||
      h->n_ion < 1.0 || h->n_ion > kMaxIon ||
      (!extended(medium) && (h->n_ion != 1.0 || h->n_shells != 0.0)) ||
      (fractional && !wide(medium) && !autodiff(medium)))
    return (int)cudaErrorInvalidValue;
  const int row = field == TILTED ? 3 : (field == IGRF ? 4 : frame);
  kEntry[row][medium](dtype, stepper, ptrs, B, n_steps, flags & 15, *h,
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The warps of a team of the instance that step_chunk_launch runs for
// these codes: 0 for the one-thread body.
extern "C" int step_chunk_team_warps(int dtype, int stepper, int frame,
                                     int medium, int field) {
  return team_warps(dtype, stepper, frame, medium, field);
}

// 1 where the instance that step_chunk_launch runs for these codes takes
// the tail layout (flag bit 2), else 0.
extern "C" int step_chunk_tail_layout(int dtype, int stepper, int frame,
                                      int medium, int field) {
  return tail_layout(dtype, stepper, frame, medium, field);
}

// The lanes a ray of the group body of the instance of these codes (flag
// bit 3), or 0 where it has none.
extern "C" int step_chunk_group_lanes(int dtype, int stepper, int frame,
                                      int medium, int field) {
  return group_instance(dtype, stepper, frame, medium, field)
             ? group_lanes(frame)
             : 0;
}
#endif

