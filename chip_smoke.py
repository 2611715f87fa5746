#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (raytrace_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it runs; any failed check exits non-zero:
  1. the card (nvidia-smi name and power limit), CUDA version, and the
     builds of the step kernel (csrc/step_chunk.cu) and of the 2D
     Fokker-Planck CN/CG kernel (csrc/cn_pcg_2d.cu) from the checkout, all
     their nvcc processes started together;
  2. the kernel against its plain PyTorch version on the same carries:
     every 10th ray of the ensemble10k launch, float64 (1 and 128 steps)
     and float32 (1 step, all 10,240 rays), bs3 and dopri5; a launch with
     finish and fresh (a trace's end and first right-hand side inside the
     launch) bit for bit with init_carry's right-hand side, the plain
     version and refine_events, float32 and float64, also at the equator
     stop (phases 5, 8 and 11 add the same for the 3D, team-body and
     general-field instances); then both timed at 10,240 rays x 512 steps
     (float32, bs3), the kernel also with the two flags; the main path's
     redesigned instance (the stage loop and the tail layout) bit for bit
     with its plain version at B = 1, 31, 33, 41, 256, the tail layout's
     threshold and one past it, each launch's layout printed, and the
     SASS census of the redesigned instances' attempt loops
     (sass_census);
  3. the canonical RayTrace_lat ray in float64 through the kernel;
  4. the ensemble10k slice through raytrace_tpu_torch.run.run on the
     card, float32, checked against the float32 physics record of the JAX
     package (benchmarks/perf_r03b.json, auto_bs3_1x, measured on a TPU),
     every round's launch with finish and nothing refined or started on
     the host, and one run under torch.profiler for the small kernels
     left (phase 6 likewise); its merged tail replayed in the tail layout
     and the dense one, bit for bit, and against the plain version over
     its first attempts, then (latency_floor.measure_cell) the launch, the
     tail dense, its longest ray alone and one ray a warp timed with
     clocks.sm, in cycles an attempt beside the attempt loop's SASS size;
     then in float64, checked against the JAX package's float64 result
     on a CPU, and float32 against float64;
  5. the 3D kernel (7-state frame, rhs_3d, the ds_max arc ceiling)
     against its plain version on the ensemble10k_3d launch as phase 2
     holds the 2D one, its first round's launch bit for bit, one
     ensemble10k_production launch (2D with ds_max) bit for bit, and the
     kernel instances timed at 10,240 rays x 512 steps beside their plain
     versions and their bounds;
  6. the ensemble10k_3d slice through run.run: float32 against the TPU
     record (benchmarks/perf_r04_3d.json, headline), float64 against the
     JAX package's float64 result on a CPU, float32 against float64;
  7. the ensemble10k_production slice (2D, ds_max) in float32 against
     the TPU record (benchmarks/perf_r03h.json, arc2e6_ph8e6);
  8. the full-medium kernel instances against their plain versions, bit
     for bit: the ensemble10k_plume launch (3D, MLT-resolved CA1992) in
     float32 and float64, the same fan over the MLT-resolved GCPM, the
     2D knee fan through two media that hold every other gate, and the
     plume fan through those and four more media (TEAM_MEDIA: every gate
     of the team body's density pieces); then each new path timed beside
     its plain version and its bound;
  9. the ensemble10k_plume slice through run.run: float32 against the TPU
     record (benchmarks/perf_r04_plume.json), float64 against the JAX
     package's float64 result on a CPU, float32 against float64;
 10. the mr_fan_3d slice through run.run: float32 against the JAX
     package's float32 census on a CPU (the TPU record, BENCH_r05.json ->
     mr_fan_3d, printed beside it), float64 against the JAX package's;
 11. the general-field kernel instances (tilted dipole, IGRF) against
     their plain versions, bit for bit: the ensemble10k_tilted and
     ensemble10k_igrf launches in float32 and float64, a tilted field over
     an axisymmetric density, IGRF over the MLT-resolved GCPM, and tilt = 0
     through the general instance against the dipole instance; then every
     new instance timed in turns with the dipole plume instance;
 12. the ensemble10k_tilted slice and
 13. the ensemble10k_igrf slice through run.run: float32 against the TPU
     record (benchmarks/perf_r05_tilted_fused.json), float64 against the
     JAX package's float64 result on a CPU, float32 against float64;
 14. the instances of the last variants against their plain versions, bit
     for bit: the local arc ceiling (the ensemble10k_local launch), the
     colatitude frame (the ensemble10k launch in it), the multi-ion medium
     (the emic_heband launch at root -1 and the ensemble10k fan over He+
     and O+) and fixed-step rk4 (the ensemble10k launch at dt0 = dt_max),
     float32 over all rays and float64 over every 10th ray (CUT_N steps),
     and each variant through a full-medium and a general-field instance;
     then every instance a path of phases 15-18 launches, and rk4 over the
     3D full chain, timed beside its plain version and its bound;
 15. the ensemble10k_local slice: float32 against the TPU record
     (benchmarks/perf_r03k.json -> local), float64 against the JAX
     package's float64 census on a CPU;
 16. raymain (the colatitude frame's single ray) and the ensemble10k fan
     in the colatitude frame, each against the JAX package on a CPU; its
     redesigned instance in both layouts as phases 2 and 4 hold the
     latitude frame's, and the whole fan in the dense layout with finish
     and fresh off and on, bit for bit;
 17. emic_heband (He+ and O+, the EMIC root) against the JAX package on a
     CPU, float64 ray by ray;
 18. the ensemble10k fan with fixed-step rk4 at dt0 = dt_max: float64
     against the JAX package's census on a CPU, float32 reported;
 19. the stop branches ESCAPED (a finite r_ceil) and EVANESCENT
     (stop_retrograde) through two team instances (the 3D full chain) and
     a one-thread instance, bit for bit with the plain version;
 20. the instances of the reference scripts' modes (ALT: the closed-form
     dmu/dpsi, dmu/dr = 0 and in 3D the Kimura rho partials; the 2D
     frequency read as f + T), 3 frames x bs3, dopri5, rk4 x float32,
     float64, bit for bit with their plain version (bs3 over the whole
     launch x SIDE_N attempts, dopri5 and rk4 over every 10th ray x
     CUT_N), each
     timed beside its bound and its plain version;
 21. ensemble10k and
 22. ensemble10k_3d with grad_mode="reference" through run.run, float32
     and float64, against the JAX package's censuses on a CPU within its
     own spread;
 23. the golden rays of tests/test_goldens.py in float64, reference +
     legacy: RayMain's ray at t = 40 and RayTrace_lat's at the full budget
     against the golden states, and RayMain's wedge;
 24. mr_fan_3d float64 with continue_until_done: the final MAX_STEPS
     count against the JAX package's run() on a CPU;
 25. the trajectory channel: trace(save_every=32, save_fn) through the
     kernel (one launch per block on a resident carry) against the plain
     version, bit for bit in every snapshot, the diagnostics and the final
     carry (ensemble10k every 10th ray, 2D one-thread; the plume fan, 3D
     team body); ensemble10k float32 at full width with save_every=32 and
     the diagnostics through run.run: the (625, 10240, 4) trajectory, its
     wall beside the final-state run's, its launches, host buffer and
     bytes fetched; the rays with a non-finite diagnostic against the
     reference's census (TRAJ_NONFINITE); its final states against phase
     4's; the
     rounds-assembled trajectory against use_rounds=False (pinned bs3)
     bit for bit; one block's launch (10,240 rays x 32 attempts) timed;
 26. the instances of the modes over the full and extended media (ALTX:
     the extended chain under ref_grads and legacy_freq), 3 frames x bs3,
     dopri5, rk4 x float32, float64, bit for bit with their plain version
     over every 10th ray x CUT_N (the reference set over the MLT plume
     in 3D, reference + legacy over GCPM with the duct and the day/night
     ionosphere in the 2D frames; then the local arc ceiling, He+ and O+
     under legacy, the MLT GCPM plume); every instance timed at 10,240
     rays x 512 beside its bound (the float32 ones of phase 27's paths
     first);
 27. ensemble10k_plume and ensemble10k_local with grad_mode="reference"
     and emic_heband with legacy_freq_state through run.run's rounds path,
     float32 and float64, every launch on an ALTX instance, against the
     JAX package's censuses on a CPU within its own one-ulp spread;
 28. the landing sensitivity (sensitivity.py, the variational system as
     torch ops, one attempt a CUDA graph): graph against eager bit for bit
     and each one's cost per attempt, the canonical RayTrace_lat ray's
     d(lat_land)/d(lat_0) against the JAX package's on a CPU, and
     run(sensitivity_rays=4) on ensemble10k at a budget of 512 attempts;
 29. the wave-particle chain (growth, diffusion, fokker_planck, radial),
     each stage's wall on the card after a warm-up beside the port's own
     on the CPU: (a) examples/lightning_to_lifetimes.py as it runs (the
     fan through trace's trajectory channel, float64 dopri5, then the
     gain, the band, the bounce averages and the lifetimes) against the
     JAX package's numbers on a CPU, and one block's launch bit for bit
     and timed; (b) path_gain along phase 25's whole trajectory, every
     10th ray against the CPU; (c) the diffusion map of
     examples/diffusion_map.py in float64 against the CPU (with the peak
     memory) and in float32 'mc' against float64; (d)
     examples/two_belt_structure.py as it runs against the JAX package's
     numbers, the refilling's CN steps and the inverse iteration eagerly
     and as CUDA graphs, bit for bit, with their ms per step;
 30. the 2D pitch-angle x momentum Fokker-Planck solver
     (fokker_planck_2d.py): (a) the CN/CG kernel (csrc/cn_pcg_2d.cu, one
     launch an evolution on a thread-block cluster) against its plain
     version through GraphLoop on examples/chorus_acceleration.py's
     operator and seed, the first 180 CN steps in float64 and float32 (the
     snapshot and each step's CG count), at the layout the wrapper picks
     and at a second cluster size, each timed per CN step beside the
     plain version's CUDA graph and (4 steps) its eager loop, with the
     graph against the eager loop bit for bit, and beside the latency
     floor of the layout's synchronisation skeleton; (b) examples/chorus_acceleration.py and
     examples/belt_competition.py as they run, through the kernel (the
     tensors from the port's bounce_averaged on the card, 1,440 CN steps
     with 8 snapshots), against the JAX package's float64 numbers on a
     CPU (FP2D_PINS), float32 reported beside them; gamma_oblique at
     harmonics -3..3 on the card against the CPU;
 31. two processes on the one card (chip_smoke.py --rank-worker, a gloo
     group on a free localhost port, the parent's build loaded, never
     rebuilt) trace the halves of ensemble10k in float32 through
     parallel/distributed.trace_ensemble_multihost, in the preset's round
     schedule and in one full-budget round, against one process on the
     same path: the slices cover the grid, both ranks print the same
     GLOBAL (combine_stat_rows of their LOCAL rows); in one round every
     summed key equals one process's exactly and the means to 1e-12; the
     medians lie between the ranks'; each rank's and one process's wall;
 32. the rounds tracer's knobs: ensemble10k float32 at pipeline 2 and 3
     bit for bit with pipeline 1, the walls of each in turns; float64
     with tail_stepper="dopri5" and with order_switch_dt=0.12 against
     the JAX package's censuses under the same knob (KNOB_PINS), MAX_STEPS
     beside the default run's; float32 with tail_stepper="dopri5" (its
     merged tail on dopri5) reported;
 33. the plots' data (viz: the refractive surface at n_psi = 6,284, the
     environment maps at n = 400, the density profile) on the card in
     float64 against the CPU to 1e-12; without matplotlib --plots raises
     its named ImportError, with it the five plots render;
 34. the autodiff gradient set (grad_mode="autodiff", the AD instances:
     the value chain on dual numbers): (a) the 30 AD instances (the lat,
     colat, 3D dipole, tilted and IGRF rows x bs3, dopri5, rk4 x float32,
     float64) bit for bit with their plain version (ops/dual.py's rules)
     over a cut of their launch, and the run-time flags of the same
     instances (legacy_freq_state, He+ and O+ at the EMIC root, the local
     ceiling); each instance timed at 10,240 rays x 512 attempts beside its
     bound and the plain version's cut; the four with a group body (bs3:
     the 2D latitude frame in float32 and float64, the tilted dipole in
     float32, the 3D dipole in float64; a group of lanes a ray, a tangent
     row a lane) in each body (one-thread, group), bit
     for bit with the plain version on a cut of the launch and on each
     captured merged tail of (b) (its first attempts with finish and
     fresh; the whole tail, the bodies with one another), each body's ms
     and cycles an attempt beside its latency floor; (b) ensemble10k and
     ensemble10k_3d through run.run in float32 and float64, the float64
     censuses against the JAX package's autodiff censuses on a CPU outside
     its own one-ulp spread (AD_PINS), float32 against float64 and
     against the float32 census on a CPU (AD_F32), the fused set's
     float32 run beside it; emic_heband, ensemble10k_tilted,
     ensemble10k_local and raymain once in float32 against AD_F32; the
     merged tails of ensemble10k, ensemble10k_local and ensemble10k_tilted
     in float32 and of ensemble10k and ensemble10k_3d in float64 took the
     group body (and every launch within the wrapper's threshold), and
     each of those runs again with every launch on the one-thread body
     gives its results bit for bit; (c)
     the CLI with grad_mode="autodiff" in a config file against run.run,
     bit for bit.
35.  The media and step ceilings the kernel once refused: (a) the ANY
     instances in 2D and in 3D (the plume, the tilted dipole) at
     ps_weight = de_weight = 0.5, with six local-ceiling shells, under the
     reference set at ps_weight = 0.5 and over the plume at 12 MLT
     harmonics, AD_ANY at 12 harmonics and with six shells, and AD at 0
     harmonics, each launch bit for bit with its plain version and timed
     beside its bound; (b) ensemble10k_plume at 12 harmonics
     through run.run, ensemble10k at ps_weight = 0.5 and every 4th ray of
     it at de_weight = 0.5 through make_rounds_tracer, float32 and float64
     (float64 against the JAX package's censuses on a CPU, ANY_PINS), and
     in float32 the plume and the tilted fan at both weights 0.5, the local
     fan with six shells, ensemble10k under the reference set at ps_weight
     = 0.5, the plume under the autodiff set at 12 and 0 harmonics and
     the local fan under it with six shells.
Each run through run.run checks the body its launches took (the team
body's launch count, ops/step_chunk.py) and replays its last launch, the
merged tail where the run has one (kernel_ab.replay_tail), for the
kernels' record.
The plain version costs ~20 ms an attempt whatever the rays (its time is
set by its ~2,000 small launches per attempt), so the attempts it runs set
the script's wall. The main path's first launch (phase 2) runs at its own
10,240 rays x 2,048 attempts; every other instance's launch at its whole
width runs SIDE_N attempts, a cut over every 10th ray CUT_N; each plain
time is printed, and recorded in the kernels' JSON record (plain_rays,
plain_steps), with the rays and attempts it ran. The line before the
last is the kernels' JSON record, the last line {"ok": true, "device":
{...}}. Without a CUDA device it exits 1 and prints no result. It imports
nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

# attempts of a check against the plain version outside the main path's
# first launch: over an instance's whole launch, and over every 10th ray
SIDE_N = 64
CUT_N = 16

# the TPU float32 record of ensemble10k (benchmarks/perf_r03b.json ->
# auto_bs3_1x): physics, not speed
REC_HIT_EARTH = 8820
REC_STEPS = 21_507_423
REC_MEDIAN_L = 1.25795
# The float32 hit set depends on the platform's rounding: rays wedged at
# resonance cones retire as DT_UNDERFLOW or land depending on last-ulp
# differences (DT_UNDERFLOW 470 in the TPU record, 524 for the JAX package
# on a CPU, 554 for the port on an H100), and that moves the median of the
# hit set by a few 1e-3 (the JAX package on a CPU lands 2.5e-3 from its
# own TPU record). The float32 median is therefore held at 5e-3; the
# device-neutral check is the float64 run below.
REC_MEDIAN_L_RTOL = 5e-3
# The JAX package's float64 result for ensemble10k on a CPU (same preset,
# traced in 10 batches of 1,024 rays; per-ray results do not depend on the
# batch except where a straggler's stall check falls, which moves a few
# rays between DT_UNDERFLOW and MAX_STEPS and ~0.3% of the steps)
F64_HIT_EARTH = 9112
F64_MAX_PHASE_TIME = 930
F64_STEPS = 23_760_744
F64_MEDIAN_L = 1.275001527237478
# The JAX package's own float32-vs-float64 agreement on the same 10,240
# rays (CPU): 95.35% of statuses match, median relative landing-L error
# 2.18e-4 over the matched hits -- the rtol 1e-5 noise floor of float32
# (BASELINE.md records 2.4e-4 for its ceiling variants). The BASELINE.json
# target of 1e-4 holds at the 3D production setting
# (tests/test_rounds.py:692-739), not for this workload, in either package.
F32_F64_STATUS_MATCH = 0.95
F32_F64_MEDIAN_DL = 2.5e-4

# the TPU float32 record of ensemble10k_3d (benchmarks/perf_r04_3d.json ->
# headline). The JAX package's float32 run on a CPU (batches of 1,024
# rays, tests/test_torch_slice3d.py run as a script) falls inside every
# band: HIT_EARTH 9504 (1.7% low), 2,708,189 attempted steps (0.8% low),
# median landing L 3.198 (the record keeps two decimals)
REC3_HIT_EARTH = 9672
REC3_HIT_RTOL = 0.02
REC3_STEPS = 2_730_450
REC3_MEDIAN_L = 3.19
REC3_MEDIAN_L_ATOL = 0.01
# The JAX package's float64 result for ensemble10k_3d on a CPU (10 batches
# of 1,024 rays): HIT_EARTH 9984, DT_UNDERFLOW 255, MAX_STEPS 1. HIT_EARTH
# and MAX_PHASE_TIME do not depend on the batch; a straggler's stall check
# may move a ray between DT_UNDERFLOW and MAX_STEPS
F64_3D_HIT_EARTH = 9984
F64_3D_MAX_PHASE_TIME = 0
F64_3D_STEPS = 2_777_199
F64_3D_MEDIAN_L = 3.164676627998943
# The JAX package's own float32-vs-float64 agreement on ensemble10k_3d
# (CPU): 95.30% of statuses match (480 float32 rays retire as DT_UNDERFLOW
# that land in float64), median relative landing-L error 1.55e-6 over the
# 9,504 matched hits. The port is held to that match less 0.5 points, and
# to the BASELINE target of 1e-4 in landing L
F32_F64_3D_STATUS_MATCH = 0.9530 - 0.005
F32_F64_3D_MEDIAN_DL = 1e-4

# the TPU float32 record of ensemble10k_production (benchmarks/
# perf_r03h.json -> arc2e6_ph8e6). The JAX package's float32 run on a CPU:
# HIT_EARTH 8737 (0.7% low), 5,448,856 attempted steps (3.5% low), median
# landing L 1.252012 (2.9e-3 low, the platform spread of phase 4)
RECP_HIT_EARTH = 8800
RECP_STEPS = 5_648_643
RECP_MEDIAN_L = 1.255669

# the TPU float32 record of ensemble10k_plume (benchmarks/perf_r04_plume.json
# -> ensemble10k_plume). The JAX package's float32 run on a CPU (batches of
# 1,024 rays, tests/test_torch_slice3d.py run as a script) falls inside
# both bands: HIT_EARTH 9569 (1.0% low), 3,021,913 attempted steps (0.9%
# low), DT_UNDERFLOW 667 against the record's 574
RECM_HIT_EARTH = 9663
RECM_HIT_RTOL = 0.02
RECM_STEPS = 3_048_162
# The JAX package's float64 result for ensemble10k_plume on a CPU (10
# batches of 1,024 rays): HIT_EARTH 9976, MAX_PHASE_TIME 5, DT_UNDERFLOW
# 248, MAX_STEPS 11
F64_M_HIT_EARTH = 9976
F64_M_MAX_PHASE_TIME = 5
F64_M_STEPS = 3_246_820
F64_M_MEDIAN_L = 3.128847829367587
# The JAX package's own float32-vs-float64 agreement on the plume fan
# (CPU): 95.91% of statuses match, median relative landing-L error 1.17e-6;
# the port is held to that match less 0.5 points and to 1e-4 in landing L
# (the pin of tests/test_rounds.py::test_plume_fan_f32_landing_accuracy_vs_f64)
F32_F64_M_STATUS_MATCH = 0.9591 - 0.005
F32_F64_M_MEDIAN_DL = 1e-4

# the TPU float32 record of mr_fan_3d (BENCH_r05.json -> mr_fan_3d):
# HIT_EARTH 1152, DT_UNDERFLOW 882, MAX_STEPS 14. Its DT_UNDERFLOW rays are
# wedge retirements, whose count depends on the platform's rounding. The
# JAX package's float32 run on a CPU (one batch of 2,048 rays) lands
# HIT_EARTH 1124 (DT_UNDERFLOW 910, MAX_STEPS 14), 2.4% below the record,
# and 5,373,076 attempted steps, 0.7% below. HIT_EARTH is held within 2% of
# that CPU census, which the port's code did not produce; the distance to
# the TPU record is printed beside it (the band the JAX census needs there,
# 3%, is not a gate of the port: PERF.md). Steps within 5% of the record
RECR_HIT_EARTH = 1152
RECR_STEPS = 5_413_302
CPU_F32_R_HIT_EARTH = 1124
CPU_F32_R_HIT_RTOL = 0.02
# The JAX package's float64 result for mr_fan_3d on a CPU (one batch of
# 2,048 rays, and the same in two batches of 1,024): HIT_EARTH 1273,
# DT_UNDERFLOW 83, MAX_STEPS 692, 31,972,417 attempted steps. Three rays of
# one launch (lat 1.1286 rad, chi -0.3, f 886.49 Hz) in three MLT sectors
# meet a wedge within ~20 attempts of the ground, and whether each lands
# there or retires as DT_UNDERFLOW turns on last-ulp rounding: on an H100
# ray 1346 lands where the JAX package's retires, and rays 1410 and 1474
# retire where its land, each the same when traced alone (PERF.md). Over
# the other 2,045 rays HIT_EARTH and DT_UNDERFLOW equal the JAX package's
# exactly, the named rays are checked alone on the card, MAX_STEPS exactly,
# steps within 1%
F64_R_WEDGE_RAYS = (1346, 1410, 1474)
F64_R_HIT_EARTH_REST = 1271
F64_R_DT_UNDERFLOW_REST = 82
F64_R_MAX_STEPS = 692
F64_R_STEPS = 31_972_417

# the TPU float32 records of ensemble10k_tilted and ensemble10k_igrf
# (benchmarks/perf_r05_tilted_fused.json; physics, not speed): tilted
# HIT_EARTH 9566 / MAX_PHASE_TIME 4 / DT_UNDERFLOW 669 / 1 other, 3,045,896
# attempted steps; IGRF 9704 / 3 / 532 / 1, 2,976,026. The JAX package's
# float32 census on a CPU (tests/test_torch_slice3d.py run as a script
# with --batch 10240: one batch, as the port traces it; in batches of 1,024
# the stragglers' stall checks fall elsewhere and the float64 steps come
# to 3,207,767 and 3,530,674) falls inside both bands: tilted HIT_EARTH
# 9507 (0.6% low), 2,966,665 steps (2.6% low), DT_UNDERFLOW 728; IGRF 9668
# (0.4% low), 2,883,675 (3.1% low), DT_UNDERFLOW 567. Its float64 census:
# tilted HIT_EARTH 9968 / MAX_PHASE_TIME 5 / DT_UNDERFLOW 263 / MAX_STEPS
# 4; IGRF 9975 / 5 / 255 / 5. Its own float32-vs-float64 agreement: tilted
# 95.46% of statuses, median relative landing-L error 1.12e-6; IGRF 96.95%,
# 7.65e-7; the port is held to that match less 0.5 points and to 1e-4.
# One float64 ray of the tilted fan (6287: lat 0.8833 rad, phi -3 pi/4,
# chi -0.5, f 8 kHz) meets a wedge ~950 attempts in, at r ~ 9 RE on its
# way out: the JAX package retires it there as DT_UNDERFLOW (768 + 182
# attempts), on an H100 it passes and escapes to MAX_PHASE_TIME (15,371 +
# 180), the same when traced alone (PERF.md). HIT_EARTH and MAX_PHASE_TIME
# are held exactly over the other 10,239 rays and the named ray is checked
# alone on the card
FIELD_PINS = {
    "ensemble10k_tilted": dict(
        rec_hit=9566, rec_steps=3_045_896, cpu_f32_hit=9507,
        cpu_f32_steps=2_966_665, f64_hit=9968, f64_mpt=5,
        f64_steps=3_018_020, f64_median_l=2.7990589009559614,
        jax_match=0.9546, f64_wedge_rays=(6287,)),
    "ensemble10k_igrf": dict(
        rec_hit=9704, rec_steps=2_976_026, cpu_f32_hit=9668,
        cpu_f32_steps=2_883_675, f64_hit=9975, f64_mpt=5,
        f64_steps=3_000_242, f64_median_l=2.328949656899414,
        jax_match=0.9695, f64_wedge_rays=()),
}
FIELD_HIT_RTOL = 0.02
FIELD_F32_F64_MEDIAN_DL = 1e-4

# the 2D media of phase 8: GCPM and the smoothed plasmapause are separate
# code paths of the full chain, so two media hold every gate
FULL_2D = {
    "gcpm+iono_mlt+duct": dict(ps_model="gcpm", iono_mlt=True, duct_amp=0.5,
                               duct_l0=3.0, duct_w=0.1),
    "smooth+refill_q+iono_mlt+duct": dict(
        ps_smooth=0.05, ps_refill=0.5, ps_refill_q=4.0, iono_mlt=True,
        duct_amp=0.5, duct_l0=3.0, duct_w=0.1),
}

# the 3D media of phase 8 through the team body's density pieces (ne_head,
# ne_lterms, ne_tail; the plume's medium is held apart): FULL_2D's two,
# without and with the MLT-resolved plasmapause; a constant refill with the
# DE factor; no plasmasphere, so that every branch of the pieces runs
TEAM_MEDIA = {
    **FULL_2D,
    **{f"{label}+ps_mlt": dict(kw, ps_mlt=True)
       for label, kw in FULL_2D.items()},
    "refill+de+ps_mlt": dict(ps_refill=0.5, de_correction=True, ps_mlt=True),
    "no plasmasphere+iono_mlt": dict(plasmasphere=False, iono_mlt=True),
}

# The pins of phases 15-18: the JAX package on a CPU, traced by
# tests/test_torch_slice3d.py run as a script in one batch of 10,240 rays
# (--batch 10240; --set frame='"2d_colat"' for the colatitude fan,
# --set adaptive=False --set dt0=0.15695630336514316 for rk4), and
# raytrace_tpu.run.run for the two small presets.
# ensemble10k_local: the TPU float32 record (benchmarks/perf_r03k.json ->
# local) HIT_EARTH 8799, 5,650,351 attempted steps, median landing L
# 1.255669; the JAX package's float32 census falls inside its bands
# (HIT_EARTH 8737, 0.7% low; 5,443,492 steps, 3.7% low; median L 1.252012,
# 2.9e-3 low). Its float64 census: HIT_EARTH 9111 / MAX_PHASE_TIME 937 /
# DT_UNDERFLOW 72 / MAX_STEPS 120, 7,636,198 attempted steps, median
# landing L 1.275356814402513; its own float32-vs-float64 agreement 95.02%
# of statuses, median landing-L error 2.39e-4 (printed, not gated: the
# preset's pins are the record and the float64 census). The median landing
# L is held at 1e-8, not 1e-9: under the local ceiling a ray's landing
# carries the last-ulp differences of the math libraries further than at
# the phase ceiling (the JAX package and the port's plain version, both on
# a CPU, land 48 rays of this fan a median 3.6e-9 apart, against 2.6e-10
# for ensemble10k), and the H100's median sits 2.6e-9 from the JAX
# package's (PERF.md)
LOCAL_PINS = dict(rec_hit=8799, rec_steps=5_650_351, rec_median_l=1.255669,
                  f64_hit=9111, f64_mpt=937, f64_steps=7_636_198,
                  f64_median_l=1.275356814402513, f64_median_l_rtol=1e-8)
# ensemble10k in the colatitude frame (its chi fans the other way about
# the field, so the rays run otherwise than in the latitude frame: 47.6M
# attempted steps, most rays to MAX_PHASE_TIME). float64: HIT_EARTH 4934 /
# MAX_PHASE_TIME 5270 / DT_UNDERFLOW 31 / MAX_STEPS 5, 47,639,025 attempted
# steps (in batches of 1,024: the same statuses, 47,644,132), median
# landing L 1.012830557894701. float32: 4516 / 5251 / 471 / 2, 47,277,151;
# its own float32-vs-float64 agreement 95.56% of statuses, median landing-L
# error 3.58e-6. The port is held to that match less 0.5 points and to
# 1e-4 in landing L
COLAT_PINS = dict(f64_hit=4934, f64_mpt=5270, f64_steps=47_639_025,
                  f64_median_l=1.012830557894701, jax_match=0.9556)
# raymain: float64 HIT_EARTH after 2732 accepted and 4 rejected steps,
# final (r, theta, chi, T) and phase path t below; float32 HIT_EARTH (2743
# accepted, 2 rejected)
RAYMAIN_F64 = dict(n_accept=2732, n_reject=4,
                   u=(0.9999999999999961, 1.496337217990451,
                      2.9934728053095148, 0.4850911279766074),
                   t=421.4872177438297)
# emic_heband: all 48 rays MAX_PHASE_TIME at t = 200 after 1279 accepted
# steps and no rejection, in float64 and float32 alike; the float64 final
# states summed over the 48 rays, component by component, and their
# magnitudes summed likewise
EMIC_F64 = dict(n_accept=1279, t=200.0,
                u_sum=(105.0442457846833, 6.600652812512754,
                       -8.261519594988023, 217.9280353554698),
                u_abs_sum=(105.0442457846833, 14.379146312737305,
                           20.2625869257972, 217.9280353554698))
# ensemble10k with fixed-step rk4 at dt0 = dt_max (1e6 m, the ceiling the
# adaptive run rides at a median 0.985 dt_max): float64 HIT_EARTH 9165 /
# MAX_PHASE_TIME 1075, 20,448,302 steps (no rejections), median landing L
# 1.2806808463207082; float32 9136 / 1077 / INVALID 27, 20,425,402 steps
# (reported, not gated). With no error control some rays lose their
# trajectory at this step (chi runs to hundreds of radians, r to ~1,400
# RE), and last-ulp differences then decide where they end: the port's
# plain version on a CPU (run.run, device="cpu") ends rays 4047 and 4303
# (lat 0.7 and 0.7167, chi 0.3, 8 kHz) at MAX_PHASE_TIME where the JAX
# package lands them and lands ray 8621 (lat 1.0, chi 0.1667, 5.53 kHz)
# where it runs out, and 27 of the 9,163 rays both land differ in landing
# L by more than 1e-9 (18 by more than 1e-6); on an H100 three rays flip
# as well, not the same three (HIT_EARTH 9164, MAX_PHASE_TIME 1076). So
# every ray must end HIT_EARTH or MAX_PHASE_TIME, HIT_EARTH within 3 rays
# of the JAX package's, and the median landing L, a rank that those rays
# move by a rank (~1.2e-4), within 2e-4
RK4_F64 = dict(hit=9165, flips=3, steps=20_448_302,
               median_l=1.2806808463207082, median_l_rtol=2e-4)
RK4 = dict(adaptive=False, dt0=1.0e6 / 6.3712e6)  # dt_max: 1e6 m over RE
COLAT = dict(frame="2d_colat")
# the 10,240-ray fan of phase 14's multi-ion instance: ensemble10k over He+
# and O+ (the fractions of emic_heband)
MULTI_ION = dict(eta_he=0.1, eta_o=0.02)

# The reference scripts' modes (phases 20-24): grad_mode="reference" (the
# closed-form dmu/dpsi, dmu/dr = 0, the Kimura rho partials in 3D) and, in
# the 2D frames, legacy_freq_state (the frequency read as f + T); both take
# the kernel's ALT instances
REF = dict(grad_mode="reference")
AD = dict(grad_mode="autodiff")
REF_LEGACY = dict(grad_mode="reference", legacy_freq_state=True)
RK4_3D = dict(adaptive=False, dt0=1.0e-3)
# The pins of phases 21-22: the JAX package on a CPU, tests/
# test_torch_slice3d.py run as a script with --batch 10240 --set
# grad_mode='"reference"' (one batch, as the port traces it), and as a
# second witness the port's own plain version on a CPU (the same script
# with --port: its run() on the CPU). The reference set wedges most rays,
# so one float64 census is one draw of a chaotic process; the band each
# float64 pin is held to is the JAX package's own spread under a one-ulp
# perturbation, its run with every launch latitude one ulp up (--nudge):
# it keeps HIT_EARTH and moves rays between MAX_PHASE_TIME, DT_UNDERFLOW
# and MAX_STEPS, the gross flow through each status (the rays it moved
# into or out of it) being ensemble10k 27 / 21 / 34 and ensemble10k_3d 2 /
# 47 / 47. The port's CPU census (mu and the angle partials from the fused
# chain where JAX takes autodiff) lies within that band of JAX's, with a
# flow of the same size (ensemble10k 20 / 17 / 25, ensemble10k_3d 2 / 48
# / 46): swapping the two equal derivatives moves the census as a one-ulp
# nudge does. So float64 holds HIT_EARTH exactly and each other status
# count within that flow of both censuses, the steps within 1% as every
# float64 phase holds them, the median landing L within 1e-9. float32
# is held to both censuses in float32 alike: HIT_EARTH within 2% (or 2
# rays) and the steps within 5%, as the earlier float32 phases hold them
# (the float32 census is platform-dependent), and each other status count
# within the JAX package's own float32 one-ulp nudge's flow (ensemble10k
# 18 / 28 / 10, ensemble10k_3d 28 / 63 / 35; the port's float32 CPU census
# sits 2 / 6 / 4 and 6 / 1 / 7 rays from JAX's); the float32-vs-float64
# agreement to the JAX package's own less 0.5 points.
REF_PINS = {
    "ensemble10k": dict(
        f64=dict(hit=259, mpt=2864, dtu=7013, ms=104, steps=53_992_922,
                 median_l=1.1511114711023525),
        port_f64=dict(hit=259, mpt=2858, dtu=7016, ms=107,
                      steps=53_950_098, median_l=1.1511114711021202),
        f64_band=dict(hit=0, mpt=27, dtu=21, ms=34),
        f32=dict(hit=258, mpt=2811, dtu=7164, ms=7, steps=47_439_447),
        port_f32=dict(hit=258, mpt=2813, dtu=7158, ms=11,
                      steps=47_543_031),
        f32_band=dict(mpt=18, dtu=28, ms=10),
        jax_match=0.984765625, jax_dl=1.41e-7),
    "ensemble10k_3d": dict(
        f64=dict(hit=245, mpt=253, dtu=9569, ms=173, steps=17_267_666,
                 median_l=2.1897905137663636),
        port_f64=dict(hit=245, mpt=253, dtu=9571, ms=171,
                      steps=17_302_267, median_l=2.189790513763458),
        f64_band=dict(hit=0, mpt=2, dtu=47, ms=47),
        f32=dict(hit=245, mpt=246, dtu=9711, ms=38, steps=13_875_068),
        port_f32=dict(hit=245, mpt=252, dtu=9712, ms=31,
                      steps=13_733_671),
        f32_band=dict(mpt=28, dtu=63, ms=35),
        jax_match=0.98408203125, jax_dl=4.49e-7),
}
# Phase 23: the golden rays of tests/test_goldens.py (the reference + legacy
# mode, rtol 1e-9 / atol 1e-14, dopri5 from the canonical launch), pinned
# there from the JAX package on a CPU and the C++ oracle, which agree to
# ~1e-8: RayMain's ray (colatitude frame, f = 5 kHz, ionosphere only) at
# t_max = 40 RE, RayTrace_lat's ray (f = 1 kHz) at the full phase budget,
# both MAX_PHASE_TIME, held at rtol 1e-6 in (r, angle, chi) and 1e-4 in
# the frequency-drifted T (as the goldens hold them); and RayMain's ray on
# to the full budget, which wedges: DT_UNDERFLOW at t = 40.362 +- 0.05
GOLD_RAYMAIN_T40 = np.array([1.68357074, 1.79234569, 0.49686928,
                             0.39099545])
GOLD_LAT_BUDGET = np.array([2.22037210, 0.10556103, -0.20884739, 0.36037])
GOLD_WEDGE_T = 40.362
# Phase 24: mr_fan_3d float64 with continue_until_done (four more budgets
# of 40,960 attempts, dopri5, for the MAX_STEPS rays), the JAX package's
# run() on a CPU (tests/test_torch_slice3d.py mr_fan_3d float64 --run --set
# continue_until_done=True): over the 2,045 rays besides the wedge rays of
# phase 10, HIT_EARTH 1274 / MAX_PHASE_TIME 10 / DT_UNDERFLOW 82 /
# MAX_STEPS 679 (the wedge rays end DT_UNDERFLOW, HIT_EARTH, HIT_EARTH
# there, as in the run without continuations), 143,576,968 attempted steps
# in all. The four counts are held exactly, as phase 10 holds the run
# without continuations, the steps within 1%, and the wedge rays each
# traced alone (with continuations) keep their status in the fan
MR_CONT = dict(hit_rest=1274, mpt_rest=10, dtu_rest=82, ms_rest=679,
               steps=143_576_968)

# Phases 26-27: the reference scripts' modes over the full and extended
# media, the kernel's ALTX instances. The 2D medium of phase 26: GCPM with
# the duct and the day/night ionosphere (FULL_2D's first)
GCPM_2D = FULL_2D["gcpm+iono_mlt+duct"]
# The pins of phase 27: the JAX package on a CPU, tests/
# test_torch_slice3d.py run as a script with --batch 10240 (one batch, as
# the port traces it; 48 rays for emic_heband) and --set
# grad_mode='"reference"' or, for emic_heband, --legacy
# (legacy_freq_state=True through its rounds tracer, the path run() takes;
# legacy_freq_state is not a RunConfig field). Both modes make rays
# chaotic (the reference set's wedges; legacy's drifting frequency), so a
# float64 census is one draw: each status count is held within the JAX
# package's own one-ulp-nudge flow (--nudge: every launch latitude one ulp
# up; the rays it moved into or out of each status), as phases 21-22 hold
# theirs, and the attempted steps within twice the nudge's own change (at
# least 1%), the median landing L within 1e-9. The port's own plain
# version on a CPU (the same script with --port: its run()) is the second
# witness, printed beside (its float64 censuses lie within those flows of
# JAX's). float32 is platform-dependent, and over the MLT plume the two
# packages' float32 censuses part: JAX's float32 lands 352 rays where its
# float64 lands 384, the port's float32 on a CPU 384 (and on the card), so
# float32 is held to the port's own float32 census on a CPU: HIT_EARTH
# within 2% (or 2 rays), each other status within the JAX package's own
# float32 one-ulp nudge's flow, the steps within 5%; JAX's float32 census
# printed beside. emic_heband's float32 run is held to every ray stopped
# with a finite state (the JAX package's float32 and float64 censuses
# there share 21% of their statuses).
ALTX_PINS = {
    "ensemble10k_plume": dict(
        over=dict(grad_mode="reference"),
        f64=dict(hit=384, mpt=303, dtu=9383, ms=170, steps=18_088_267,
                 median_l=2.28610987545372),
        f64_band=dict(hit=0, mpt=8, dtu=61, ms=53), steps_band=0.034,
        port_f64=dict(hit=384, mpt=295, dtu=9389, ms=172, steps=18_302_291),
        f32=dict(hit=352, mpt=268, dtu=9572, ms=48, steps=12_285_183),
        port_f32=dict(hit=384, mpt=293, dtu=9511, ms=52, steps=14_328_426),
        f32_band=dict(mpt=33, dtu=86, ms=53),
        jax_match=0.977734375, jax_dl=2.59e-7),
    "ensemble10k_local": dict(
        over=dict(grad_mode="reference"),
        f64=dict(hit=259, mpt=2866, dtu=7014, ms=101, steps=40_332_787,
                 median_l=1.151107909964016),
        f64_band=dict(hit=0, mpt=23, dtu=14, ms=25), steps_band=0.01,
        port_f64=dict(hit=259, mpt=2864, dtu=7019, ms=98, steps=40_290_602),
        f32=dict(hit=258, mpt=2813, dtu=7159, ms=10, steps=33_983_734),
        port_f32=dict(hit=258, mpt=2816, dtu=7158, ms=8, steps=33_945_911),
        f32_band=dict(mpt=19, dtu=27, ms=10),
        jax_match=0.9853515625, jax_dl=1.22e-7),
    "emic_heband": dict(
        over=dict(legacy_freq_state=True),
        f64=dict(hit=0, mpt=10, dtu=38, ms=0, steps=36_934, median_l=0.0),
        f64_band=dict(hit=0, mpt=10, dtu=10, ms=0), steps_band=0.144,
        f32=dict(hit=0, mpt=39, dtu=0, ms=9, steps=128_470),
        jax_match=0.20833333333333334, jax_dl=None),
}
# Phase 28: the canonical RayTrace_lat ray's landing sensitivity (the
# JAX package's landing_sensitivity on a CPU, float64, SolverConfig(rtol=
# 1e-9, atol=1e-13), StopSpec(r_floor=1, t_max=5e9 m / RE)): HIT_EARTH
# after 4664 accepted and 123 rejected attempts, d(lat_land)/d(lat_0) =
# -7226.344438315766 (its docstring: -7226.4, rtol-converged to 6 digits)
SENS_CANON = dict(amp=7226.344438315766, jac11=-7226.344438315766,
                  n_accept=4664, n_reject=123,
                  u_land=np.array([0.9999999999999855, 0.048412204694655604,
                                   -3.058616452082853, 3.1251997444711974]))

# the 3D float32 bs3 kernel at 10,240 rays x 512 attempts of the
# ensemble10k_3d launch when it held only the axisymmetric medium (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md)
AXI_3D_MS = 3.203

# phase 25: ensemble10k's rays with a non-finite diagnostic in some
# snapshot row (the reference's unguarded 1/mu and 1/F): in any column,
# in mu, in dmu/dpsi. The JAX package's run() on a CPU (save_every=32,
# save_diagnostics=True) gives the same 377 rays in float32 and in
# float64, 374 of them in mu and 377 in dmu/dpsi (ROADMAP C). The card's
# float32 run has the same 377 and 377 and 373 in mu: one ray's mu
# column stays finite on the card (a float32 census, held as the others
# are to the platforms' band: here one ray)
TRAJ_NONFINITE = (377, 374, 377)

# peaks of one H100 SXM (NVIDIA's data sheet): 67 TFLOP/s float32 and
# 34 TFLOP/s float64 outside the tensor cores, 3.35 TB/s of HBM
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12


# Phase 29: the wave-particle chain of examples/lightning_to_lifetimes.py
# (LIGHTNING: its fan and chain) and examples/two_belt_structure.py
# (TWO_BELT), in float64
LIGHTNING = dict(lats=np.linspace(0.76, 0.92, 5),
                 freqs=np.array([3000.0, 4000.0, 5000.0, 6000.0]),
                 rtol=1e-6, atol=1e-10, dt0=1e-4, t_max_m=5.0e9,
                 max_steps=20000, save_every=25, seed_pt=5.0,
                 hot=dict(eta=1e-3, t_par_ev=25e3, anisotropy=1.0),
                 e_three=np.array([1000.0, 2500.0, 5000.0]),
                 e_scan=np.geomspace(500.0, 10000.0, 12), nc=96,
                 ba=dict(n_lat=32, n_grid=256, n_bisect=24))
TWO_BELT = dict(e_mev=1.0, spec=dict(bw_t=300e-12, f_m=700.0, df=500.0,
                                     f_lc=100.0, f_uc=4000.0),
                l_probe=np.linspace(1.6, 6.4, 33), nc=96, d0_ll=3.0e-8,
                n_l=240, dt=1.0e4, n_steps=6000, save_every=1000,
                ba=dict(n_lat=32, n_grid=192, n_bisect=24))
# the bounce-averaged map of examples/diffusion_map.py (L = 4, its
# hiss-like band 0.05-0.5 fce), at the root search's defaults
DIFFUSION_MAP = dict(n_e=44, n_a=44, n_lat=48, n_grid=512, n_bisect=30,
                     every=4)
# the two-belt profiles are pinned at every TWO_BELT_EVERY-th radial cell
TWO_BELT_EVERY = 24
# The JAX package's float64 numbers of both chains on a CPU at the
# examples' sizes (tests/test_torch_tiers_chain.py run as a script: the
# fan through its trace, the lightning chain through its numpy oracle, the
# two-belt tau(L) through bounce_averaged_jax, as the examples run them).
# Held: the in-shell ray set exactly; l_star, f_m, df and bw_t to 1e-8; the
# lifetimes to 1e-6; tau(L) to 1e-8; the profiles and snapshots to 1e-9
LIGHTNING_PINS = dict(
    in_shell=[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 19],
    crossed=20,
    l_star=1.6020484172868321,
    f_m=5226.480203780766,
    df=1073.0954010186933,
    bw_t=2.8712027031683655e-11,
    has_wave=[True, True, True, True, True, True, True, True, True, True, True,
              True],
    tau_e=[461853870760.8806, 318681458597.4112, 236131058864.65118,
           164529469992.63092, 127200476007.05708, 87900333815.8546,
           63410619604.01742, 37350072110.97287, 25116152175.85993,
           11094211548.381496, 5288713183.673192, 3464112060.706094],
    tau_weak=[785595.9620202449, 1609037.8745105704, 3393648.9275951544,
              7123119.351512599, 15444950.639549099, 34566719.99992487,
              80226373.50666685, 192562514.23837504, 448868962.02013975,
              1266769111.4152021, 3681713802.530818, 9570657080.798185])
TWO_BELT_PINS = dict(
    tau=[27136721215.9639, 10922571878.721968, 5353516466.322139,
         2838760764.6677513, 1519211711.3065667, 819004399.7006423,
         456562115.8608585, 228608889.7135412, 121699431.12150565,
         75308831.50485988, 34042537.47747134, 17782931.054336634,
         9180760.499155791, 7256823.187847399, 2742844.211638216,
         2458939.744917727, 18726.672227678388, 10664.93868624359, math.inf,
         math.inf, math.inf, math.inf, math.inf, math.inf, math.inf, math.inf,
         math.inf, math.inf, math.inf, math.inf, math.inf, math.inf, math.inf],
    s0=2.547520925564822e-10,
    f_bnd=[2.6240512017489897e-11, 7.589102327232214e-10,
           1.7629202632966808e-09, 4.368193466067883e-09,
           1.5728295399041263e-08, 2.314265437720084e-06, 0.3514215426973469,
           0.7115652946329835, 0.8768811397862746, 0.9582274060986331],
    f_src_unit=[236669126.94952586, 909293077.5984045, 89621940.27133894,
                8296860.814120336, 579631.7540485557, 139.11266480471718,
                0.0070828112521684194, 0.003149855740176643,
                0.0013445214509634547, 0.00045617826923742484],
    f_free=[0.13409929926720743, 1.3643413012831713, 1.0906051228276383,
            1.0272212305373518, 1.009687867314987, 1.0038784668627132,
            1.0016741533258682, 1.0007445266118185, 1.0003178024909805,
            1.0001078261638707],
    f_eq=[0.06029195536014796, 0.23164431502422755, 0.022831378586015923,
          0.0021136470222405004, 0.00014767813055145286,
          2.3497046801801946e-06, 0.3514215426991512, 0.7115652946337859,
          0.8768811397866171, 0.9582274060987493],
    snaps=[[0.06029195536014796, 0.2316443150242027, 0.006652157903351413,
            6.755259062596917e-08, 1.3349291647243408e-08,
            2.3125992903751664e-06, 0.35121093354129757, 0.7113300821119891,
            0.8767528443493221, 0.9581806385404056],
           [0.06029195536014796, 0.23164431482583378, 0.010118138781606627,
            1.2473173749480367e-05, 7.096152763221733e-08,
            2.3142715927787772e-06, 0.3514214762985359, 0.7115652204774658,
            0.8768810993385372, 0.9582273913542095],
           [0.06029195536014796, 0.2316442950763094, 0.012178690951290247,
            8.227724703509728e-05, 1.339107732319892e-06,
            2.314498648356944e-06, 0.35142154267642656, 0.7115652946096156,
            0.8768811397735301, 0.9582274060939859],
           [0.06029195536014796, 0.23164402394533326, 0.013642121438482101,
            0.00021569648201307315, 6.241277802120558e-06,
            2.3155271978465323e-06, 0.3514215426974002, 0.7115652946330046,
            0.8768811397862836, 0.9582274060986333],
           [0.06029195536014796, 0.23164265093197275, 0.014772432430825879,
            0.00038479191001258877, 1.5154184129271721e-05,
            2.3175425457718866e-06, 0.3514215426975038, 0.711565294633052,
            0.8768811397863043, 0.9582274060986404],
           [0.06029195536014796, 0.23163869426560516, 0.01568752010385569,
            0.00056345328946331, 2.6564424922488534e-05, 2.320219568247506e-06,
            0.351421542697638, 0.7115652946331127, 0.8768811397863312,
            0.9582274060986502]])

# The JAX package's float64 numbers of both examples on a CPU at their
# sizes (tests/test_torch_fokker_planck_2d.py run as a script: the tensors
# through its jitted bounce_averaged_jax, the evolutions through its
# evolve_cn_2d, as the examples run them), 12 digits: chorus_acceleration's
# run (its chorus-only run is belt_competition's too) and
# belt_competition's combined run -- the 1 and 3 MeV PSD gains at 80 deg,
# content_2d at the end, the trapped > 1 MeV content of every snapshot,
# the last snapshot's 3 MeV pitch-angle profile and the 80 deg rows (every
# snapshot's of the chorus run, the last one's of the combined run)
FP2D_PINS = dict(
    chorus=dict(
        gain=[1.560799514696e+00, 5.561873494850e+05],
        content=5.632265233820e-02,
        trapped=[2.026730252879e-02, 3.076735976329e-02, 3.548061197058e-02,
                 3.770371544644e-02, 3.878848161028e-02, 3.932253572126e-02,
                 3.957899234028e-02, 3.969054196341e-02],
        prof3=[1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.447915045440e-09,
               1.447915045440e-09, 1.447915045440e-09, 1.749546628138e-03,
               1.655195510148e-03, 1.557268275993e-03, 1.461924176488e-03,
               1.368696506998e-03, 1.279819486053e-03, 1.196143299741e-03,
               1.119090331084e-03, 1.048629525357e-03, 9.854480291652e-04,
               9.296286602643e-04, 8.812253505628e-04, 8.398925544210e-04,
               8.053120314028e-04, 7.776942262341e-04, 7.560585868396e-04,
               7.368788060203e-04, 7.196594299006e-04, 7.060338858288e-04],
        rows80=[[8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 2.550916014819e-03, 5.066732588788e-03,
                 8.392992105052e-03, 1.234593474162e-02,
                 1.657804734330e-02, 2.067140767667e-02,
                 2.421242412783e-02, 2.684871103680e-02,
                 2.833976107059e-02, 2.858906109157e-02,
                 2.765942148313e-02, 2.576452963247e-02,
                 2.321413276689e-02, 2.034962285223e-02,
                 1.747216989110e-02, 1.479546179635e-02,
                 1.243638464218e-02, 1.044005088204e-02,
                 8.793166909601e-03, 7.435751339709e-03,
                 6.311481367657e-03, 5.361042224967e-03,
                 4.540391465139e-03, 3.808908136863e-03,
                 3.125423668544e-03, 2.477645249732e-03,
                 1.875012159179e-03, 1.331245146649e-03,
                 8.721386364492e-04, 5.137687037054e-04,
                 2.606818832351e-04, 1.037318797061e-04,
                 2.237526007172e-05, -8.311409976324e-06,
                 -1.264498797043e-05, -7.646168559659e-06,
                 -2.486993142890e-06, 5.409286592617e-08,
                 5.579674451405e-07, 3.044808043287e-07,
                 4.868845148694e-08, -4.626370333599e-08],
                [8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 7.018681620785e-04, 1.482416751732e-03,
                 2.554070271313e-03, 3.877248051177e-03,
                 5.363059426999e-03, 6.890520995940e-03,
                 8.329166255793e-03, 9.560412561416e-03,
                 1.049386165897e-02, 1.106636640316e-02,
                 1.124770701246e-02, 1.105396373644e-02,
                 1.054771762108e-02, 9.824385301066e-03,
                 8.987924538825e-03, 8.128073572184e-03,
                 7.307901730546e-03, 6.565073732183e-03,
                 5.912787679290e-03, 5.341919406516e-03,
                 4.839876720589e-03, 4.388087005598e-03,
                 3.970806546063e-03, 3.570622381504e-03,
                 3.165167121943e-03, 2.743814073154e-03,
                 2.307055543772e-03, 1.860390255669e-03,
                 1.423481815215e-03, 1.018464888820e-03,
                 6.675418318634e-04, 3.882396115782e-04,
                 1.882250217542e-04, 6.443737761254e-05,
                 1.762004527108e-06, -1.915149969799e-05,
                 -1.789692452104e-05, -9.791398351547e-06,
                 -2.921176698001e-06, 4.752152476576e-07,
                 1.313119818647e-06, 1.236808187675e-06],
                [8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 3.021606040496e-04, 6.592024534376e-04,
                 1.158392687287e-03, 1.786096648149e-03,
                 2.506117646730e-03, 3.267064711513e-03,
                 4.010293405791e-03, 4.681020561614e-03,
                 5.237099553114e-03, 5.646664223126e-03,
                 5.887942345790e-03, 5.957020866721e-03,
                 5.871490726454e-03, 5.666380757294e-03,
                 5.384451638395e-03, 5.066072772345e-03,
                 4.742677284074e-03, 4.435513147253e-03,
                 4.154790425335e-03, 3.899851745321e-03,
                 3.667095526782e-03, 3.448941592710e-03,
                 3.237963147517e-03, 3.024871507869e-03,
                 2.796088268381e-03, 2.542332411726e-03,
                 2.259097210709e-03, 1.944743973164e-03,
                 1.607852001531e-03, 1.262412571917e-03,
                 9.274747502724e-04, 6.248912944691e-04,
                 3.739207786208e-04, 1.873704310151e-04,
                 6.572583540537e-05, 9.931517936937e-07,
                 -2.211401970205e-05, -2.201348989173e-05,
                 -1.329164699243e-05, -4.736314062164e-06,
                 3.518656595183e-07, 2.262699224366e-06],
                [8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 1.647128229452e-04, 3.680429464914e-04,
                 6.558767617985e-04, 1.022376597688e-03,
                 1.448793131258e-03, 1.907581058814e-03,
                 2.366222701840e-03, 2.793588539778e-03,
                 3.165422167117e-03, 3.463277982306e-03,
                 3.673677850692e-03, 3.791881331102e-03,
                 3.824152626876e-03, 3.785935476808e-03,
                 3.697402414657e-03, 3.578703883647e-03,
                 3.446687984310e-03, 3.313677327217e-03,
                 3.186561579531e-03, 3.066563763760e-03,
                 2.952779840210e-03, 2.841742851085e-03,
                 2.729432675851e-03, 2.610278349996e-03,
                 2.475382533625e-03, 2.317006263423e-03,
                 2.129057869461e-03, 1.906618347881e-03,
                 1.651434535911e-03, 1.370385700107e-03,
                 1.076355514936e-03, 7.880790185388e-04,
                 5.262783230452e-04, 3.098379429631e-04,
                 1.487651304356e-04, 4.533810297597e-05,
                 -7.622429855134e-06, -2.526759189627e-05,
                 -2.324115629150e-05, -1.432778313943e-05,
                 -6.458572598654e-06, -2.562629509823e-06],
                [8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 1.058435278900e-04, 2.410192908334e-04,
                 4.341556317273e-04, 6.823688115494e-04,
                 9.741831146784e-04, 1.292170224689e-03,
                 1.615297083515e-03, 1.923022446372e-03,
                 2.199067008952e-03, 2.431222287900e-03,
                 2.610691616223e-03, 2.733843290793e-03,
                 2.803304760000e-03, 2.826883434073e-03,
                 2.815303810640e-03, 2.779777258322e-03,
                 2.730222706890e-03, 2.674310063178e-03,
                 2.616809703388e-03, 2.559352782521e-03,
                 2.502026407729e-03, 2.443199512242e-03,
                 2.380518419194e-03, 2.310381800615e-03,
                 2.226616735019e-03, 2.122865877723e-03,
                 1.992922810698e-03, 1.830732917028e-03,
                 1.634452491059e-03, 1.406353016853e-03,
                 1.154179069765e-03, 8.921951379908e-04,
                 6.388126798233e-04, 4.136945416315e-04,
                 2.311531961579e-04, 1.000474777339e-04,
                 2.032175201929e-05, -1.802568378994e-05,
                 -2.848340839630e-05, -2.479742198169e-05,
                 -1.781795114435e-05, -1.350053594757e-05],
                [8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 7.687862019386e-05, 1.776575365218e-04,
                 3.226437793122e-04, 5.102518747042e-04,
                 7.324964481939e-04, 9.768861631901e-04,
                 1.228106550067e-03, 1.470970905850e-03,
                 1.693268695066e-03, 1.885983597874e-03,
                 2.042816458949e-03, 2.160981781291e-03,
                 2.241674993750e-03, 2.289329696457e-03,
                 2.310354178067e-03, 2.311741072901e-03,
                 2.299971283187e-03, 2.280260476605e-03,
                 2.256135698640e-03, 2.229265045886e-03,
                 2.200142500682e-03, 2.168042158544e-03,
                 2.131512609541e-03, 2.088090313630e-03,
                 2.033285122138e-03, 1.961866372265e-03,
                 1.868060245746e-03, 1.745685426448e-03,
                 1.591176731464e-03, 1.404070268155e-03,
                 1.188454145699e-03, 9.545844488354e-04,
                 7.176072293502e-04, 4.956517411891e-04,
                 3.042018345852e-04, 1.556014867648e-04,
                 5.487198302119e-05, -3.055297958924e-06,
                 -2.826259831092e-05, -3.341614152845e-05,
                 -3.041819580787e-05, -2.727346211022e-05],
                [8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 6.110371042172e-05, 1.427351517572e-04,
                 2.607491965112e-04, 4.141895274305e-04,
                 5.969223457737e-04, 7.991236173614e-04,
                 1.008611183199e-03, 1.213168842500e-03,
                 1.402881848972e-03, 1.570517788592e-03,
                 1.711146679083e-03, 1.822487320009e-03,
                 1.905081509092e-03, 1.961733262537e-03,
                 1.996730793711e-03, 2.014946452272e-03,
                 2.021067245209e-03, 2.018972607932e-03,
                 2.011461859722e-03, 2.000147650522e-03,
                 1.985699492902e-03, 1.967867926495e-03,
                 1.945725507422e-03, 1.917508736798e-03,
                 1.879819009757e-03, 1.828314089668e-03,
                 1.757807562510e-03, 1.662418900461e-03,
                 1.537860634453e-03, 1.382116986120e-03,
                 1.196812672554e-03, 9.890346256133e-04,
                 7.707814026088e-04, 5.578629003483e-04,
                 3.653072771936e-04, 2.068998784189e-04,
                 9.091060711486e-05, 1.632000084670e-05,
                 -2.338141489942e-05, -3.874494862786e-05,
                 -4.139630935732e-05, -4.042239692280e-05],
                [8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 5.172886657470e-05, 1.217405332288e-04,
                 2.232896736983e-04, 3.557474251367e-04,
                 5.140492348114e-04, 6.899426093264e-04,
                 8.731126418956e-04, 1.053133609432e-03,
                 1.221502473012e-03, 1.372071207273e-03,
                 1.500708043066e-03, 1.605429334255e-03,
                 1.686447126565e-03, 1.745718115943e-03,
                 1.786414281356e-03, 1.812268954708e-03,
                 1.826976005439e-03, 1.833651856255e-03,
                 1.834655250956e-03, 1.831525938767e-03,
                 1.825008443748e-03, 1.815117341779e-03,
                 1.801247527046e-03, 1.782089934891e-03,
                 1.754986374700e-03, 1.716289940031e-03,
                 1.661399937184e-03, 1.584887776853e-03,
                 1.482257129521e-03, 1.350647151599e-03,
                 1.190055825231e-03, 1.005177168024e-03,
                 8.053120314028e-04, 6.038661532231e-04,
                 4.146830066509e-04, 2.517925047403e-04,
                 1.253827429030e-04, 3.753837792203e-05,
                 -1.500244798272e-05, -4.033354440774e-05,
                 -4.905916638728e-05, -5.064392658595e-05]]),
    sum=dict(
        gain=[8.105347599729e-01, 2.341733401759e+04],
        content=2.480048292365e-02,
        trapped=[1.951895056511e-02, 2.564627244509e-02, 2.436183159220e-02,
                 2.098154952952e-02, 1.741006422744e-02, 1.423484810908e-02,
                 1.158606928122e-02, 9.438772868997e-03],
        prof3=[1.244637842333e-07, 3.077712396801e-07, 4.553159639176e-07,
               5.807931181432e-07, 6.916276327221e-07, 7.923311672377e-07,
               8.858840353475e-07, 9.743868839119e-07, 1.059415624424e-06,
               1.142205918868e-06, 1.217228252879e-06, 1.286226980111e-06,
               1.355185619037e-06, 1.424775591430e-06, 1.495648573250e-06,
               1.568461919593e-06, 1.643902042409e-06, 1.722707676227e-06,
               1.805694708613e-06, 1.893784221047e-06, 1.988035561527e-06,
               2.089686639550e-06, 2.200204240405e-06, 2.321348072443e-06,
               2.469650176429e-06, 2.657850553645e-06, 2.870290334632e-06,
               3.152925179864e-06, 3.673908967678e-06, 5.375248411513e-06,
               2.469163535864e-04, 2.211877967896e-04, 1.858284956873e-04,
               1.598449002935e-04, 1.381660723261e-04, 1.188154512394e-04,
               1.011562469567e-04, 8.517094649126e-05, 7.114679362930e-05,
               5.902726745571e-05, 4.887322027315e-05, 4.053904067518e-05,
               3.390631024817e-05, 2.886242709810e-05, 2.509009363606e-05,
               2.187064534680e-05, 1.914016730586e-05, 1.710970916230e-05],
        rows80=[[8.080791431421e-01, 7.855686475327e-01,
                 7.609326906368e-01, 7.340994003330e-01,
                 7.050281270243e-01, 6.737179940985e-01,
                 6.402167689873e-01, 6.046295211655e-01,
                 5.671263577149e-01, 5.279483664645e-01,
                 4.874107824616e-01, 4.459023633314e-01,
                 4.038800519569e-01, 3.618582531268e-01,
                 3.607020810653e-05, 8.282973456110e-05,
                 1.498918146441e-04, 2.363902754445e-04,
                 3.384768159347e-04, 4.502141013143e-04,
                 5.643691914454e-04, 6.736982067886e-04,
                 7.725030855648e-04, 8.567880925281e-04,
                 9.238009187215e-04, 9.722579800365e-04,
                 1.002615328901e-03, 1.016861229919e-03,
                 1.017989311511e-03, 1.009329622639e-03,
                 9.940099115244e-04, 9.745923637457e-04,
                 9.527500742186e-04, 9.290338515362e-04,
                 9.033276767490e-04, 8.746261489759e-04,
                 8.413649585166e-04, 8.011718874513e-04,
                 7.500652028091e-04, 6.841077058926e-04,
                 6.005867731833e-04, 4.993319159125e-04,
                 3.860217272775e-04, 2.710508526644e-04,
                 1.674499988951e-04, 8.666853972162e-05,
                 3.390631024817e-05, 6.857655265170e-06,
                 -2.634003610736e-06, -3.414317100795e-06,
                 -1.757093313110e-06, -4.576231926424e-07,
                 1.943008466153e-08, 7.701849487347e-08,
                 2.515640977901e-08, -1.455931185336e-09]]),
)


# the examples' float64 numbers through the kernel against FP2D_PINS: the
# port's plain version on a CPU (its own tensors, which are 2e-11 of their
# max from JAX's) lands 9e-15 of the snapshots' max from them, the 80 deg
# rows' entries within 6e-11 relative
FP2D_RTOL = 1e-8

# phase 34: the JAX package's censuses under grad_mode="autodiff" on a CPU,
# in one batch of the preset's rays as run() traces them (tests/
# test_torch_slice3d.py <preset> <dtype> --batch 10240 --set
# grad_mode='"autodiff"'; raymain and emic_heband with --run), 2026-10-18.
# float64, and with --nudge (every launch latitude one ulp up: the
# package's own spread, nudge_rays with their statuses in the unnudged
# run): ensemble10k's census is the fused set's (9112 / 930 / 72 / 126),
# its median landing L 5.5e-10 from the fused one's; the nudge moves one
# ray (to HIT_EARTH, and the median of the hit set by 1.5e-4: median_l is
# the median over the hits outside nudge_rays); ensemble10k_3d's nudge
# moves none. jax_match, jax_dl: the package's own float32-vs-float64
# agreement under autodiff (--against the float64 run). AD_F32: the float32
# censuses, the JAX package's on a CPU; ensemble10k_tilted's the port's
# plain version on a CPU (--port, the same date), since the JAX package's
# float32 autodiff over the tilted field retires 1,780 rays as
# DT_UNDERFLOW (HIT_EARTH 8455, 2,795,290 steps) where the port's plain
# version retires 869 and its fused set 694 (ROADMAP C)
AD_PINS = {
    "ensemble10k": dict(hit=9112, mpt=930, dtu=72, ms=126,
                        steps=23_706_773, median_l=1.275001526542184,
                        nudge_rays={8386: "DT_UNDERFLOW"},
                        jax_match=0.93603515625, jax_dl=2.242e-4,
                        dl_max=2.5e-4),
    "ensemble10k_3d": dict(hit=9984, mpt=0, dtu=255, ms=1,
                           steps=2_777_437, median_l=3.164676627998958,
                           nudge_rays={}, jax_match=0.9375,
                           jax_dl=1.528e-6, dl_max=1e-4),
}
AD_F32 = {
    "ensemble10k": dict(hit=8599, steps=21_007_601),
    "ensemble10k_3d": dict(hit=9345, steps=2_689_908),
    "ensemble10k_tilted": dict(hit=9366, steps=2_967_407,
                               by="the port's plain version"),
    "ensemble10k_local": dict(hit=8614, steps=5_154_453),
    "emic_heband": dict(hit=0, steps=62_086),
    "raymain": dict(hit=1, steps=2_744),
}

# phase 32: the JAX package's censuses of ensemble10k in float64 on a CPU
# under one knob of the rounds tracer each, in one batch of 10,240 rays as
# run() traces it (tests/test_torch_rounds_knobs.py run as a script). In
# float64 the active set never falls to the merged tail's 64 rays (130
# rays are still active in the last round, 126 end at MAX_STEPS), so
# tail_stepper="dopri5" changes nothing there: its census is the default
# run's, held exactly. The order pools move rays to dopri5 from round 2 on
# and leave 5 at MAX_STEPS. Their census is held as the chaotic ones of
# phases 21-22 are, to the JAX package's own spread: its run with every
# launch latitude one ulp up (--nudge) moves 7 rays (nudge_rays, here with
# their statuses in the unnudged run: wedge rays and stragglers at the
# budget; HIT_EARTH 9181, MAX_PHASE_TIME 983, DT_UNDERFLOW 72, MAX_STEPS 4).
# Outside those 7 rays the card must give JAX's census exactly
KNOB_PINS = {
    "tail_stepper": dict(hit=9112, mpt=930, dtu=72, ms=126,
                         steps=23_705_448, median_l=1.275001527237478),
    "order_switch_dt": dict(hit=9179, mpt=983, dtu=73, ms=5,
                            steps=22_862_126, median_l=1.2806352051147682,
                            nudge_rays={2005: "MAX_STEPS",
                                        8912: "DT_UNDERFLOW",
                                        8944: "DT_UNDERFLOW",
                                        9184: "HIT_EARTH",
                                        9936: "DT_UNDERFLOW",
                                        10176: "DT_UNDERFLOW",
                                        10192: "HIT_EARTH"}),
}


# phase 35: the media and step ceilings the kernel once refused. Five
# shells past the knee (the kernel's parameters hold four, the rest ride in
# a buffer on the card), both weights at 0.5
SIX_SHELLS = ((2.5, 0.05), (3.0, 0.1), (3.5, 0.1), (5.0, 0.2), (6.0, 0.3))
HALF = dict(ps_weight=0.5, de_weight=0.5)
# The JAX package's censuses on a CPU of the phase's full-width paths
# (tests/test_torch_any_medium.py run as a script: the rounds tracer with
# run()'s keywords over the launch in one batch, as run() traces it;
# float64, float32 and the two against each other): ensemble10k_plume at
# 12 harmonics, ensemble10k at ps_weight = 0.5, every 4th ray of
# ensemble10k with the DE factor at de_weight = 0.5. float64 is held as
# phase 9 holds the plume: HIT_EARTH and MAX_PHASE_TIME exactly, the
# attempted steps within 1%, the median landing L within l_rtol, with
# DT_UNDERFLOW and MAX_STEPS printed beside the JAX package's (the stall
# check of a straggler at the budget moves it between the two where the
# rounds differ: in 10 batches of 1,024 rays JAX's ps_half census is 50 /
# 96, in one batch 57 / 89, the card's). The JAX package's own one-ulp
# nudge of every launch latitude moves no ray's status in any of the three
# (--nudge). l_rtol is 1e-9, and 1e-8 for the de fan, as phase 15 holds
# the local fan: there the port's plain version on a CPU lands the median
# 2.95e-9 from JAX's (the same 2,193 rays land, each 6.2e-10 from JAX's at
# the median ray and up to 0.8% on a few grazing ones: the DE factor's exp
# and sqrt differ in the last bit between torch's and XLA's math on a CPU,
# and bs3's error estimate carries those bits into the steps, 7,094,455
# attempts against 7,095,785; with the dopri5 base the same fan's rays
# agree at 5.8e-13 at the median ray), and JAX's own nudge moves its median
# 6.1e-10 (the others' 3e-13 and 8e-14). The card is held to that plain
# run of the port too, at 1e-9 (port_median_l: float64 on a CPU).
# float32 against float64 to the JAX package's own agreement
# less 0.5 points and to dl_max in landing L (1e-4 and 2.5e-4 as phases 9
# and 4 hold their fans; the de fan, a quarter of the rays, at 1.5x the
# JAX package's own 2.3e-4). JAX's float32 censuses (HIT_EARTH, steps):
# 9576, 3,002,361; 8785, 20,460,730; 1982, 5,477,611
ANY_PINS = {
    "plume12": dict(hit=9978, mpt=4, dtu=248, ms=10, steps=3_198_924,
                    median_l=3.149087661473458, l_rtol=1e-9,
                    jax_match=0.959765625, jax_dl=1.186e-6, dl_max=1e-4),
    "ps_half": dict(hit=9203, mpt=891, dtu=57, ms=89, steps=22_279_228,
                    median_l=1.2507818757529943, l_rtol=1e-9,
                    jax_match=0.949609375, jax_dl=1.377e-4, dl_max=2.5e-4),
    "de_half": dict(hit=2193, mpt=240, dtu=55, ms=72, steps=7_095_785,
                    median_l=1.3105999267509558, l_rtol=1e-8,
                    port_median_l=1.3105999306229832,
                    jax_match=0.889453125, jax_dl=2.307e-4, dl_max=3.5e-4),
}


def lightning_chain(k, traj, st_t, f_g, env, conf=LIGHTNING):
    """examples/lightning_to_lifetimes.py after its trace, over `k` (a
    namespace of one package's tier functions taking and returning
    numpy): path_gain, the equator crossings, the shell the rays pick,
    spectrum_from_rays, bounce_averaged at three and at len(e_scan)
    energies, precipitation_lifetime and loss_cone_lifetime_s. traj
    (S, B, 4) and st_t (S, B) of the fan's trajectory. Returns a dict of
    the chain's numbers."""
    import math

    n = traj.shape[1]
    g = k.path_gain(traj, f_g, env, k.HotElectrons(**conf["hot"]))
    inflight = st_t <= 1
    lat_abs = np.where(inflight, np.abs(traj[..., 1]), np.inf)
    i_eq = lat_abs.argmin(axis=0)
    r_eq = traj[i_eq, np.arange(n), 0]
    lat_eq = traj[i_eq, np.arange(n), 1]
    l_eq = r_eq / np.cos(lat_eq) ** 2
    crossed = lat_abs.min(axis=0) < 0.05
    gain_eq = g["gain_neper"][i_eq, np.arange(n)]
    l_star = float(np.median(l_eq[crossed]))
    in_shell = crossed & (np.abs(l_eq - l_star) < 0.15)
    bw_ray = conf["seed_pt"] * 1e-12 * np.exp(np.clip(gain_eq, -20.0, 10.0))
    spec = k.spectrum_from_rays(f_g[in_shell], bw_ray[in_shell])
    rl = 1.0 / l_star
    a_lc = math.asin(math.sqrt(rl**3 / math.sqrt(4.0 - 3.0 * rl)))
    nc = conf["nc"]
    centers = k.make_grid(a_lc, nc)[0]
    daa3 = k.bounce_averaged(conf["e_three"][:, None], centers[None, :],
                             l_star, env, spec, **conf["ba"])["daa"]
    daa_e = k.bounce_averaged(conf["e_scan"][:, None], centers[None, :],
                              l_star, env, spec, **conf["ba"])["daa"]
    dmax = daa_e.max(axis=1, keepdims=True)
    daa_e = np.maximum(daa_e, 1e-8 * np.where(dmax > 0, dmax, 1.0))
    tau_e = k.precipitation_lifetime(daa_e, a_lc, n_cells=nc)
    tau_weak = k.loss_cone_lifetime_s(conf["e_scan"], l_star, env, spec,
                                      **conf["ba"])
    return dict(gamma=g["gamma"], gain_neper=g["gain_neper"],
                crossed=crossed, in_shell=in_shell, l_eq=l_eq,
                l_star=l_star, f_m=spec.f_m, df=spec.df, bw_t=spec.bw_t,
                f_lc=spec.f_lc, f_uc=spec.f_uc, daa3=daa3,
                has_wave=dmax[:, 0] > 0.0, tau_e=tau_e, tau_weak=tau_weak)


def two_belt_chain(k, env, bounce_averaged=None, conf=TWO_BELT):
    """examples/two_belt_structure.py over `k` (numpy in and out): tau(L)
    from bounce_averaged (the example's bounce_averaged_jax where `k` is
    the JAX package) and precipitation_lifetime on each probe shell inside
    the plasmapause, then the radial equilibria (boundary-fed, CRAND-fed,
    no losses) and the storm-recovery refilling from evolve_radial.
    Returns a dict of the chain's numbers, the refilling's inputs
    (`radial`: evolve_radial's arguments) and its wall (`radial_s`: `k`
    returns numpy, so the wall includes the device's work)."""
    import math

    bounce_averaged = bounce_averaged or k.bounce_averaged
    spec = k.WaveSpectrum(**conf["spec"])
    l_probe, nc = conf["l_probe"], conf["nc"]
    tau = np.full(l_probe.size, np.inf)
    for i, L in enumerate(l_probe):
        if L >= float(env.lppi):        # hiss lives inside the plasmasphere
            continue
        rl = 1.0 / L
        a_lc = math.asin(math.sqrt(rl**3 / math.sqrt(4.0 - 3.0 * rl)))
        centers = k.make_grid(a_lc, nc)[0]
        daa = np.asarray(bounce_averaged(
            conf["e_mev"] * 1000.0, centers, float(L), env, spec,
            **conf["ba"])["daa"], np.float64)
        if daa.max() > 0.0:
            tau[i] = float(k.precipitation_lifetime(
                np.maximum(daa, 1e-8 * daa.max()), a_lc, n_cells=nc))
    with np.errstate(divide="ignore"):
        inv_tau_probe = np.where(np.isfinite(tau), 1.0 / tau, 0.0)

    grid = k.make_l_grid(1.6, 6.4, conf["n_l"])
    centers_l = grid[0]
    d_faces = k.dll_power_law(grid[1], d0=conf["d0_ll"], l0=4.0, q=10.0)
    inv_tau = np.interp(centers_l, l_probe, inv_tau_probe)
    src_shape = np.exp(-(((centers_l - 1.9) / 0.25) ** 2))
    f_bnd = k.steady_state(*grid, d_faces, f_out=1.0,
                           inv_tau_centers=inv_tau)
    f_src_unit = k.steady_state(*grid, d_faces, f_out=0.0,
                                inv_tau_centers=inv_tau,
                                source_centers=src_shape)
    s0 = 0.5 / f_src_unit.max()
    src = s0 * src_shape
    f_eq = f_bnd + s0 * f_src_unit
    f_free = k.steady_state(*grid, d_faces, f_out=1.0, source_centers=src)
    radial = dict(args=(np.where(centers_l < 2.5, f_eq, 0.0), *grid,
                        d_faces),
                  kw=dict(dt=conf["dt"], n_steps=conf["n_steps"], f_out=1.0,
                          inv_tau_centers=inv_tau, source_centers=src,
                          save_every=conf["save_every"]))
    t0 = time.perf_counter()
    f_end, snaps = k.evolve_radial(*radial["args"], **radial["kw"])
    radial_s = time.perf_counter() - t0
    return dict(tau=tau, f_bnd=f_bnd, f_src_unit=f_src_unit, s0=s0,
                f_eq=f_eq, f_free=f_free, snaps=snaps, f_end=f_end,
                radial=radial, radial_s=radial_s)


def phase(title, flush=True):
    """Print a phase's title, after the time the previous phase took."""
    now = time.perf_counter()
    if phase.last is not None:
        print(f"  ({phase.last[0]}: {now - phase.last[1]:.1f} s)")
    print(title, flush=flush)
    phase.last = (title.split("]")[0] + "]", now)


phase.last = None


def check(ok, what):
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        sys.exit(1)


def rel_err(a, b):
    """Relative error of a against b: elementwise for per-ray scalars,
    and for (B, n) state vectors per component against the component's
    largest magnitude over the batch (a component that cancels to near
    zero, e.g. dchi/dt at a turning point, has no meaningful elementwise
    relative error). Returns the per-ray worst value."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tiny = np.finfo(np.float64).tiny
    if a.ndim == 1:
        return np.abs(a - b) / np.maximum(np.abs(b), tiny)
    scale = np.maximum(np.abs(b).max(axis=0, initial=0.0), tiny)
    return (np.abs(a - b) / scale).max(axis=1)


def start(name, dtype_name, dev, every=1, medium=None, **over):
    """(carry, f, env, cfg, spec, kw) of a preset's launch on `dev` (over
    `medium`, a MediumConfig, in place of the preset's; `over` overrides
    other fields of the preset): every `every`-th ray, init_carry applied;
    kw holds the launch's frame, root, adaptive, grad_mode and
    legacy_freq_state (an override here, not a preset field), the keywords
    of step_chunk. `over` may also hold env_over and cfg_over, dicts of
    fields of the built env and of the SolverConfig to replace (a
    fractional ps_weight, more ds_local_shells: no preset field reaches
    them); the launch states are the preset's, built over its own env."""
    import torch

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate.solve import init_carry
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.run import _build_u0

    over = dict(over)
    legacy = over.pop("legacy_freq_state", False)
    env_over = dict(over.pop("env_over", ()))
    cfg_over = dict(over.pop("cfg_over", ()))
    conf = preset(name, dtype=dtype_name, **over,
                  **({"medium": medium} if medium else {}))
    env = conf.medium.build()
    np_dt = np.float32 if dtype_name == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device(dev))
    env = env._replace(**env_over)
    u0 = torch.as_tensor(u0[::every]).to(dev)
    f = torch.as_tensor(f[::every]).to(dev)
    rhs_fn, _ = rhs_mod.frame_rhs(conf.frame, env, conf.root, conf.grad_mode,
                                  legacy)
    cfg = conf.solver()._replace(**cfg_over)
    return (init_carry(rhs_fn, u0, f, cfg), f, env, cfg, conf.stop(),
            dict(frame=conf.frame, root=conf.root, adaptive=conf.adaptive,
                 grad_mode=conf.grad_mode, legacy_freq_state=legacy))


def both(carry, f, env, cfg, spec, stepper, n, kw):
    """The kernel and the plain version from the same carry, on the host,
    and the plain version's time in ms (CUDA events)."""
    import torch

    from raytrace_tpu_torch.integrate.solve import RayCarry
    from raytrace_tpu_torch.ops import step_chunk as sc

    got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper,
                        n_steps=n, **kw)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                                  n_steps=n, **kw)
    e1.record()
    torch.cuda.synchronize()
    host = lambda c: {k: getattr(c, k).cpu().numpy()  # noqa: E731
                      for k in RayCarry._fields}
    return host(got), host(ref), e0.elapsed_time(e1)


def n_differ(got, ref):
    """Values that differ between two host carries (NaN == NaN)."""
    return sum(int((~np.equal(got[k], ref[k])
                    & ~(np.isnan(got[k]) & np.isnan(ref[k]))).sum())
               for k in got)


def max_abs(got, ref):
    return max(float(np.nanmax(np.abs(got[k].astype(np.float64) - ref[k])))
               for k in got)


def hold_to_plain(carry, f, env, cfg, spec, kw, what):
    """Phase 2's checks of one launch: float64, 1 step within rtol 1e-12
    and 128 steps with >= 99% of rays identical, per stepper."""
    from raytrace_tpu_torch.integrate.solve import RayCarry

    for stepper in ("bs3", "dopri5"):
        got, ref, _ = both(carry, f, env, cfg, spec, stepper, 1, kw)
        ints = [k for k in RayCarry._fields if got[k].dtype.kind == "i"]
        check(all(np.array_equal(got[k], ref[k]) for k in ints),
              f"{what} float64 {stepper} 1 step, {f.shape[0]} rays: "
              f"{', '.join(ints)} identical")
        # u_lo holds two-sum residuals (~1e-17): held at atol 1e-12, as
        # the JAX package's Pallas parity test holds it
        lo = float(np.abs(got["u_lo"] - ref["u_lo"]).max())
        errs = {k: float(rel_err(got[k], ref[k]).max())
                for k in RayCarry._fields if k not in ints and k != "u_lo"}
        print("  " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f", u_lo abs {lo:.2e}")
        for k in ("u", "k1"):
            el = np.abs(got[k] - ref[k]) / np.maximum(np.abs(ref[k]), 1e-300)
            print(f"  {k} elementwise worst per component: "
                  + ", ".join(f"{v:.1e}" for v in el.max(axis=0)))
        check(max(errs.values()) <= 1e-12 and lo <= 1e-12,
              f"{what} float64 {stepper} 1 step: every field within rtol "
              "1e-12")

        # a ray agrees when its status and step counters are identical and
        # its u, t, dt are within rtol 1e-9; rays that take a borderline
        # accept/reject the other way, or whose trajectory amplifies the
        # last-ulp differences (the cancelling error estimate feeds them
        # into dt), are counted, not failed, as the JAX package's own
        # on-chip Pallas check records (benchmarks/pallas_on_chip.py)
        got, ref, _ = both(carry, f, env, cfg, spec, stepper, 128, kw)
        same = np.ones(f.shape[0], bool)
        for name in ("status", "n_accept", "n_reject"):
            same &= got[name] == ref[name]
        err = np.max([rel_err(got[k], ref[k]) for k in ("u", "t", "dt")],
                     axis=0)
        agree = same & (err <= 1e-9)
        print(f"  {what} float64 {stepper} 128 steps, {f.shape[0]} rays: "
              f"{int((~same).sum())} took another accept/reject path, "
              f"{int((same & ~agree).sum())} more differ by > 1e-9; median "
              f"rel err of the rest {float(np.median(err[agree])):.2e}")
        check(agree.mean() >= 0.99,
              f"{what} float64 {stepper} 128 steps: >= 99% of rays "
              "identical in status/n_accept/n_reject and within rtol 1e-9 "
              "in u, t, dt")


def hold_to_plain_f32(carry, f, env, cfg, spec, kw, what):
    for stepper in ("bs3", "dopri5"):
        got, ref, _ = both(carry, f, env, cfg, spec, stepper, 1, kw)
        check(all(np.array_equal(got[k], ref[k])
                  for k in ("status", "n_accept", "n_reject")),
              f"{what} float32 {stepper} 1 step, {f.shape[0]} rays: statuses "
              "and counters identical")
        worst = max(float(rel_err(got[k], ref[k]).max())
                    for k in ("u", "t", "dt", "k1"))
        check(worst <= 1e-5, f"{what} float32 {stepper} 1 step: u, t, dt, k1 "
                             f"within rtol 1e-5 ({worst:.3e})")


def ops_per_attempt(name, stepper, medium=None, **over):
    """Operations of one attempt of one ray, counted from the plain
    version: every elementwise (pointwise) aten op of one `_step_one` call
    adds its output's element count. A transcendental (sin, exp, sqrt,
    ...) counts one, as does a select (where) or a comparison. Counted on
    a few CPU rays: the count does not depend on the data."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from raytrace_tpu_torch.integrate.solve import _step_one
    from raytrace_tpu_torch.ops import rhs as rhs_mod

    key = (name, stepper, repr(medium), repr(sorted(over.items())))
    if key in ops_per_attempt.cache:
        return ops_per_attempt.cache[key]
    carry, f, env, cfg, spec, kw = start(name, "float64", "cpu", every=640,
                                         medium=medium, **over)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Count.n += sum(o.numel() for o in outs
                               if isinstance(o, torch.Tensor))
            return out

    rhs_fn, gidx = rhs_mod.frame_rhs(kw["frame"], env, kw["root"],
                                     kw["grad_mode"],
                                     kw["legacy_freq_state"])
    with Count():
        _step_one(rhs_fn, carry, f, cfg, spec, gidx, kw["adaptive"], stepper)
    ops_per_attempt.cache[key] = Count.n / f.shape[0]
    return ops_per_attempt.cache[key]


ops_per_attempt.cache = {}


def carry_bytes(n_state, itemsize, rays):
    """Bytes one launch must move: each carry field read once and written
    once (4 vectors of n_state, 4 per-ray scalars, 6 int32 counters), and
    f read once."""
    per_ray = 2 * ((4 * n_state + 4) * itemsize + 6 * 4) + itemsize
    return per_ray * rays


def bound(name, dtype_name, stepper, n_state, attempts, rays, medium=None,
          **over):
    """The least time (ms) the card could take for a launch: the larger of
    its operations over the peak rate of its type and its bytes over the
    memory rate. attempts: the attempts this launch's data needed."""
    ops_ms = (ops_per_attempt(name, stepper, medium, **over) * attempts
              / PEAK_OPS[dtype_name])
    itemsize = 4 if dtype_name == "float32" else 8
    bytes_ms = carry_bytes(n_state, itemsize, rays) / PEAK_BYTES
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms) * 1e3, by


def time_kernel(carry, f, env, cfg, spec, stepper, n, kw, reps):
    """(mean ms of reps kernel launches between two CUDA events, the
    carry of the warm-up launch before them)."""
    import torch

    from raytrace_tpu_torch.ops import step_chunk as sc

    out = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper,
                        n_steps=n, **kw)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper, n_steps=n,
                      **kw)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def full_chain_off(name, dtype_name, stepper, dev, n=512, reps=5):
    """A preset's axisymmetric launch x n attempts through the kernel's
    full-chain instance (every feature flag off) and through its own
    axisymmetric instance, timed in turns (axi, full, full, axi). Returns
    ({instance: [ms, ms]}, values that differ between the two outputs)."""
    from raytrace_tpu_torch.integrate.solve import RayCarry
    from raytrace_tpu_torch.ops import step_chunk as sc

    carry, f, env, cfg, spec, kw = start(name, dtype_name, dev)
    own = sc.medium_code
    check(own(env) == 0, f"{name} takes the axisymmetric instances")
    ms, outs = {"axi": [], "full": []}, {}
    for which in ("axi", "full", "full", "axi"):
        sc.medium_code = (own if which == "axi"
                          else (lambda env, cfg, *modes: 1))
        try:
            t, out = time_kernel(carry, f, env, cfg, spec, stepper, n, kw,
                                 reps)
        finally:
            sc.medium_code = own
        ms[which].append(t)
        outs[which] = {k: getattr(out, k).cpu().numpy()
                       for k in RayCarry._fields}
    return ms, n_differ(outs["full"], outs["axi"])


def time_plain(carry, f, env, cfg, spec, stepper, n, kw):
    """One plain-version run between two CUDA events, ms."""
    import torch

    from raytrace_tpu_torch.ops import step_chunk as sc

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                            n_steps=n, **kw)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def plain_cut(name, dtype_name, stepper, dev, medium=None, every=10,
              n=CUT_N, **over):
    """The plain version over every `every`-th ray of a preset's launch x
    n attempts: {plain_ms, plain_rays, plain_n}. Its time is set by the
    small launches of each attempt, not by the rays, so this says what an
    attempt costs it at a fraction of the full timing's wait."""
    carry, f, env, cfg, spec, kw = start(name, dtype_name, dev, every=every,
                                         medium=medium, **over)
    return dict(plain_ms=time_plain(carry, f, env, cfg, spec, stepper, n,
                                    kw),
                plain_rays=f.shape[0], plain_n=n)


def time_instance(name, dtype_name, stepper, dev, n=512, reps=5,
                  medium=None, plain_full=True, plain_ms=None, plain_n=None,
                  plain=None, every=1, **over):
    """The kernel over a preset's whole launch x n attempts (CUDA events,
    mean of reps after a warm-up launch) beside its bound and one
    plain-version run: of the same launch (plain_full, the instances of
    the kernels' JSON record; plain_ms where that run was timed already,
    over plain_n attempts, n by default) or of plain_cut's (`plain`, its
    dict, where that run was timed already). `over` overrides fields of
    the preset; every: every `every`-th ray of the launch. Returns a
    dict."""
    carry, f, env, cfg, spec, kw = start(name, dtype_name, dev, every=every,
                                         medium=medium, **over)
    kernel_ms, out = time_kernel(carry, f, env, cfg, spec, stepper, n, kw,
                                 reps)
    attempts = int(((out.n_accept + out.n_reject)
                    - (carry.n_accept + carry.n_reject)).sum())
    if plain_full:
        if plain_ms is None:
            plain_ms = time_plain(carry, f, env, cfg, spec, stepper, n, kw)
        plain = dict(plain_ms=plain_ms, plain_rays=f.shape[0],
                     plain_n=plain_n or n)
    elif plain is None:
        plain = plain_cut(name, dtype_name, stepper, dev, medium, **over)
    bound_ms, by = bound(name, dtype_name, stepper, carry.u.shape[1],
                         attempts, f.shape[0], medium, **over)
    return dict(ms=kernel_ms, bound_ms=bound_ms, bound_by=by,
                attempts=attempts, rays=f.shape[0], n=n, **plain)


def print_timing(what, t, card):
    if (t["plain_rays"], t["plain_n"]) == (t["rays"], t["n"]):
        plain = (f"plain PyTorch {t['plain_ms']:.1f} ms "
                 f"({t['plain_ms'] / t['ms']:.1f}x)")
    else:
        plain = (f"plain PyTorch {t['plain_ms']:.1f} ms for "
                 f"{t['plain_rays']:,} rays x {t['plain_n']} steps")
    print(f"  {what}, {t['rays']:,} rays x {t['n']} steps "
          f"({t['attempts']:,} attempts made): kernel {t['ms']:.3f} ms, "
          f"{plain}, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
          f"({t['bound_ms'] / t['ms']:.1%} of it) on {card}", flush=True)


def bit_for_bit(what, name, dtype_name, stepper, dev, n, every=1,
                medium=None, **over):
    """One launch through the kernel and the plain version; fails unless
    every field agrees bit for bit. `over` overrides fields of the
    preset. Returns (max abs err, plain ms); bit_for_bit.rays is the
    launch's ray count."""
    carry, f, env, cfg, spec, kw = start(name, dtype_name, dev, every=every,
                                         medium=medium, **over)
    got, ref, plain_ms = both(carry, f, env, cfg, spec, stepper, n, kw)
    n_diff = n_differ(got, ref)
    print(f"  {what} {dtype_name} {stepper}, {f.shape[0]:,} rays x {n} "
          f"steps: {int((got['status'] != 0).sum())} rays stopped, {n_diff} "
          f"values differ"
          + (f", max |drho_phi/dt| "
             f"{float(np.abs(got['k1'][:, 5]).max()):.3e}"
             if kw["frame"] == "3d" else ""), flush=True)
    check(n_diff == 0, f"{what} {dtype_name} {stepper}: bit for bit")
    bit_for_bit.rays = f.shape[0]
    return max_abs(got, ref), plain_ms


def flags_cost(what, name, dev, card, n=512, reps=5):
    """A preset's float32 bs3 launch (all rays x n attempts, from the
    launch carry) without and with finish and fresh, timed in turns
    (without, with, with, without; time_kernel). Returns (ms without, ms
    with), each the mean of its two turns."""
    carry, f, env, cfg, spec, kw = start(name, "float32", dev)
    ms = {False: [], True: []}
    for on in (False, True, True, False):
        k = dict(kw, finish=True, fresh=True) if on else kw
        ms[on].append(time_kernel(carry, f, env, cfg, spec, "bs3", n, k,
                                  reps)[0])
    off, on = (sum(ms[x]) / 2 for x in (False, True))
    print(f"  {what} float32 bs3, {f.shape[0]:,} rays x {n} steps: "
          f"{ms[False][0]:.3f} / {ms[False][1]:.3f} ms without the flags, "
          f"{ms[True][0]:.3f} / {ms[True][1]:.3f} ms with finish and fresh "
          f"({on / off:.4f}x) on {card}", flush=True)
    return off, on


def finish_fresh(what, name, dtype_name, stepper, dev, m, n, every=1,
                 medium=None, stop=None, team=False, **over):
    """One launch with finish and fresh (a trace's end and start inside
    the launch) against the plain path that they replace on the same
    carry: k1 = rhs(u) (init_carry's right-hand side), step_chunk_reference,
    refine_events. The carry is the preset's launch (every `every`-th ray;
    `stop` overrides fields of its StopSpec) stepped m attempts by the
    kernel, with k1 set to NaN (fresh must not read it); the launch runs n
    more, so that it refines rays that retired before it and rays that
    land inside it. Fails unless every field agrees bit for bit and the
    launch went through the body it should (`team`)."""
    import torch

    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.integrate.solve import RayCarry, refine_events
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc

    carry, f, env, cfg, spec, kw = start(name, dtype_name, dev, every=every,
                                         medium=medium, **over)
    spec = spec._replace(**(stop or {}))
    # fresh tensors: the result's fields are views of the kernel's buffers
    mid = RayCarry(*(x.clone() for x in sc.step_chunk(
        carry, f, env, cfg, spec, stepper=stepper, n_steps=m, **kw)))
    counts = (sc.step_chunk.finish_launches, sc.step_chunk.fresh_launches,
              sc.step_chunk.team_launches)
    got = sc.step_chunk(mid._replace(k1=torch.full_like(mid.k1, np.nan)), f,
                        env, cfg, spec, stepper=stepper, n_steps=n,
                        finish=True, fresh=True, **kw)
    check((sc.step_chunk.finish_launches, sc.step_chunk.fresh_launches,
           sc.step_chunk.team_launches) == (
              counts[0] + 1, counts[1] + 1, counts[2] + int(team)),
          f"{what}: one launch with finish and fresh, through the "
          f"{'team' if team else 'one-thread'} body")
    rhs_fn = rhs_mod.frame_rhs(kw["frame"], env, kw["root"], kw["grad_mode"],
                               kw["legacy_freq_state"])[0]
    ref = sc.step_chunk_reference(mid._replace(k1=rhs_fn(mid.u, f)), f, env,
                                  cfg, spec, stepper=stepper, n_steps=n, **kw)
    ref = refine_events(rhs_fn, ref, f, spec)
    host = lambda c: {k: getattr(c, k).cpu().numpy()  # noqa: E731
                      for k in RayCarry._fields}
    got, ref = host(got), host(ref)
    n_diff = n_differ(got, ref)
    ev = lambda st: (st == events.HIT_EARTH) | (  # noqa: E731
        (st == events.HIT_EQUATOR) & (spec.stop_at_equator > 0.5))
    before = ev(mid.status.cpu().numpy())
    inside = ev(got["status"]) & ~before
    print(f"  {what} {dtype_name} {stepper}, {f.shape[0]:,} rays, {m} "
          f"attempts then a launch of {n} with finish and fresh: "
          f"{int(before.sum())} rays refined that retired before it, "
          f"{int(inside.sum())} that landed in it "
          f"({int((got['status'] == events.HIT_EQUATOR).sum())} at the "
          f"equator), {n_diff} values differ", flush=True)
    check(before.any() and inside.any(),
          f"{what}: the launch refined rays of both kinds")
    check(n_diff == 0, f"{what} {dtype_name} {stepper}: finish and fresh bit "
                       "for bit with init_carry's right-hand side, the plain "
                       "version and refine_events")
    return max_abs(got, ref)


def field_cost(dtype_name, stepper, dev, card, n=512, reps=5):
    """The plume launch (dipole instance) and the same fan over the tilted
    and the IGRF field (the general-field instances), all 10,240 rays x n
    attempts, timed in turns plume, tilted, igrf, igrf, tilted, plume on
    one card. Returns {field: dict(ms, bound_ms, ...)} of the two fields,
    each with `ratio`, its mean time over the plume's."""
    names = {"plume": "ensemble10k_plume", "tilted": "ensemble10k_tilted",
             "igrf": "ensemble10k_igrf"}
    starts = {k: start(v, dtype_name, dev) for k, v in names.items()}
    ms, outs = {k: [] for k in names}, {}
    for k in ("plume", "tilted", "igrf", "igrf", "tilted", "plume"):
        carry, f, env, cfg, spec, kw = starts[k]
        t, outs[k] = time_kernel(carry, f, env, cfg, spec, stepper, n, kw,
                                 reps)
        ms[k].append(t)
    res = {}
    for k in ("tilted", "igrf"):
        carry, f = starts[k][:2]
        attempts = int(((outs[k].n_accept + outs[k].n_reject)
                        - (carry.n_accept + carry.n_reject)).sum())
        bound_ms, by = bound(names[k], dtype_name, stepper, 7, attempts,
                             f.shape[0])
        res[k] = dict(ms=sum(ms[k]) / 2, bound_ms=bound_ms, bound_by=by,
                      attempts=attempts, rays=f.shape[0], n=n,
                      ratio=sum(ms[k]) / sum(ms["plume"]))
        print(f"  {k} {dtype_name} {stepper}: {ms[k][0]:.3f} / "
              f"{ms[k][1]:.3f} ms beside the dipole plume instance "
              f"{ms['plume'][0]:.3f} / {ms['plume'][1]:.3f} ms "
              f"({res[k]['ratio']:.3f}x) on {card}", flush=True)
    return res


def field_slice(name, card, census):
    """Phases 12 and 13: a non-axial-field preset through run.run in
    float32 and float64 against FIELD_PINS; the float32 run's launches in
    the tail layout (its merged tail) through the team body and the others
    through the one-thread body, then its merged tail replayed
    (tail_timing) and held in both bodies (tail_layouts, with (a)-(e) in
    cycles an attempt). Returns the float32 run's kernel launches, the
    tail's replay and tail_layouts' record."""
    from raytrace_tpu_torch.config import preset

    pin = FIELD_PINS[name]
    print(f"  {name} through raytrace_tpu_torch.run.run, float32",
          flush=True)
    conf = preset(name)
    drive(conf, "warm-up", card)
    out32, _, launches32, ref_calls = drive(conf, "float32", card)
    stats = out32["stats"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    check(launches32 > 0, "the slice stepped through the kernel")
    check(ref_calls == 0, "the plain version was not called")
    check(drive.sparse_launches > 0
          and drive.team_launches == drive.sparse_launches,
          f"{name} float32: its {drive.sparse_launches} launch(es) in the "
          f"tail layout through the team body, the other "
          f"{launches32 - drive.sparse_launches} through the one-thread body")
    tail = tail_timing(f"{name} float32", card)
    latency = tail_layouts(f"{name} float32", conf, card, census)
    check(abs(n_hit - pin["rec_hit"]) <= FIELD_HIT_RTOL * pin["rec_hit"],
          f"HIT_EARTH {n_hit} within {FIELD_HIT_RTOL:.0%} of the TPU record "
          f"{pin['rec_hit']} (the JAX package on a CPU: "
          f"{pin['cpu_f32_hit']})")
    check(abs(steps - pin["rec_steps"]) <= 0.05 * pin["rec_steps"],
          f"attempted steps {steps} within 5% of the TPU record "
          f"{pin['rec_steps']} (the JAX package on a CPU: "
          f"{pin['cpu_f32_steps']})")
    check(np.isfinite(out32["result"].u[out32["valid"]]).all(),
          "every final state is finite")

    print(f"  {name}, float64", flush=True)
    out64, _, launches, ref_calls = drive(preset(name, dtype="float64"),
                                          "float64", card)
    st64 = out64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    check(launches > 0 and ref_calls == 0,
          "float64 stepped through the kernel, never the plain version")
    from raytrace_tpu_torch.integrate import events

    wedge = pin["f64_wedge_rays"]
    status = np.asarray(out64["result"].status)[out64["valid"]]
    rest = np.ones(status.size, bool)
    rest[list(wedge)] = False
    n_hit = int((status[rest] == events.HIT_EARTH).sum())
    n_mpt = int((status[rest] == events.MAX_PHASE_TIME).sum())
    check(n_hit == pin["f64_hit"] and n_mpt == pin["f64_mpt"],
          f"over the {int(rest.sum())} rays besides {wedge}: HIT_EARTH "
          f"{n_hit} and MAX_PHASE_TIME {n_mpt} equal the JAX package's "
          f"float64 {pin['f64_hit']} and {pin['f64_mpt']}")
    rays_alone(name, wedge, out64)
    check(abs(steps64 - pin["f64_steps"]) <= 0.01 * pin["f64_steps"],
          f"attempted steps {steps64} within 1% of the JAX package's float64 "
          f"{pin['f64_steps']}")
    check(abs(med64 - pin["f64_median_l"]) <= 1e-9 * pin["f64_median_l"],
          f"median landing L within 1e-9 of the JAX package's float64 "
          f"{pin['f64_median_l']}")
    match, med_rel, n_m = landing_agreement(
        out32, out64, lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, "
          f"median relative landing-L error {med_rel:.3e} over {n_m} "
          "matched HIT_EARTH rays")
    floor = pin["jax_match"] - 0.005
    check(match >= floor,
          f"statuses match on >= {floor:.2%} of rays (the JAX package's "
          f"own: {pin['jax_match']:.2%})")
    check(med_rel < FIELD_F32_F64_MEDIAN_DL,
          f"median relative landing-L error < {FIELD_F32_F64_MEDIAN_DL:g}")
    return launches32, tail, latency


def general_field_kernels(dev, card):
    """Phase 11. Returns {field: (max abs err, timing dict)} of the two
    float32 bs3 instances, the ones on the main paths of phases 12-13
    (their launches in the tail layout, of at most
    step_chunk.layout_limit(True) = 264 rays, run on the team body, the
    wider ones on the one-thread body; their float64, dopri5 and rk4
    siblings keep the one-thread body)."""
    from raytrace_tpu_torch.config import MediumConfig
    from raytrace_tpu_torch.constants import B0_3D
    from raytrace_tpu_torch.ops import step_chunk as sc

    fields = {"tilted": "ensemble10k_tilted", "igrf": "ensemble10k_igrf"}
    for k, code in (("tilted", 1), ("igrf", 2)):
        warps = {(dt, st): (sc.team_warps(dt, st, 1, sc.FULL, code),
                            sc.tail_layout(dt, st, 1, sc.FULL, code))
                 for dt in (0, 1) for st in (0, 1, 2)}
        check(warps == {key: (4, True) if key == (0, 0) else (0, False)
                        for key in warps},
              f"{k}: the float32 bs3 instance takes the team body in the "
              f"tail layout, its siblings the one-thread body ({warps})")

    def through(team, run, *a, **kw):
        # run(*a, **kw), checking that its one kernel launch took the team
        # body or did not
        team0, launches0 = (sc.step_chunk.team_launches,
                            sc.step_chunk.launches)
        out = run(*a, **kw)
        n = sc.step_chunk.launches - launches0
        check(sc.step_chunk.team_launches - team0 == (n if team else 0),
              f"{a[0]} {a[2]} {a[3]}: its {n} launch(es) through the "
              f"{'team' if team else 'one-thread'} body")
        return out

    errs, plain_ms = {}, {}
    for k, name in fields.items():
        # the slice's first launch: 10,240 rays, float32 bs3
        errs[k], plain_ms[k] = through(False, bit_for_bit, k, name,
                                       "float32", "bs3", dev, SIDE_N)
        # every 40th ray, 256: the tail layout, the team body
        through(True, bit_for_bit, k, name, "float32", "bs3", dev, SIDE_N,
                every=40)
        for stepper in ("bs3", "dopri5"):
            through(False, bit_for_bit, k, name, "float64", stepper, dev,
                    CUT_N, every=10)
    finish_fresh("tilted", "ensemble10k_tilted", "float32", "bs3", dev, 192,
                 64)
    finish_fresh("tilted, team body", "ensemble10k_tilted", "float32",
                 "bs3", dev, 192, 64, every=40, team=True)
    finish_fresh("IGRF", "ensemble10k_igrf", "float64", "dopri5", dev, 160,
                 32, every=10)
    # a tilted field with an axisymmetric density (ps_mlt off: the chain
    # rule through mlat alone), in both bodies, and IGRF over the
    # MLT-resolved GCPM
    for every in (10, 40):
        through(every == 40, bit_for_bit,
                "tilted field, axisymmetric density", "ensemble10k_plume",
                "float32", "bs3", dev, CUT_N, every=every,
                medium=MediumConfig(b0=B0_3D, b_model="tilted", b_tilt=0.2,
                                    b_tilt_phi=0.5))
    bit_for_bit("IGRF x MLT GCPM", "ensemble10k_plume", "float64", "dopri5",
                dev, CUT_N, every=10,
                medium=MediumConfig(b0=B0_3D, ps_mlt=True, ps_model="gcpm",
                                    b_model="igrf"))

    # tilt = 0 through the general instance against the dipole instance of
    # the full chain on the plume launch: not bit for bit (the magnetic
    # longitude passes through atan2, the latitude through asin: last-ulp
    # differences), and not within 1e-12 for every ray either: the general
    # chain forms d cos psi/dr as a difference that is 0 for a dipole, and
    # near the resonance cone dmu/dcos psi multiplies that rounding noise
    # up (measured: 1% of the rays differ by 1e-7..2e-6 after 24 attempts,
    # the median by 1.4e-16). Over 24 dopri5 attempts where the arc
    # ceiling sets every step (ds_max 0.002 RE, as the CPU tests hold the
    # JAX package) statuses and counters must be identical, the median
    # difference of the state within 1e-12 and the worst within 1e-5.
    # Over 256 attempts the rays that pass a wedge turn the noise into
    # other accept/reject paths (6 of 1,024): >= 98% must keep their
    # counters; at the preset's own ceiling, where the controller sets
    # most steps, the shares are printed and not gated (PERF.md).
    from raytrace_tpu_torch.integrate.solve import RayCarry

    tilt0 = MediumConfig(b0=B0_3D, ps_mlt=True, b_model="tilted", b_tilt=0.0)
    ceiling = dict(ds_max=0.002, dt0=1e-4)
    for what, over, n in (("ds_max 0.002 RE", ceiling, 24),
                          ("ds_max 0.002 RE", ceiling, 256),
                          ("the preset's ds_max", {}, 256)):
        outs = {}
        for k, med in (("dipole", None), ("tilt = 0", tilt0)):
            carry, f, env, cfg, spec, kw = start(
                "ensemble10k_plume", "float64", dev, every=10, medium=med,
                **over)
            check(sc.field_code(env) == (0 if med is None else 1),
                  f"{k}: field code {sc.field_code(env)}")
            out = sc.step_chunk(carry, f, env, cfg, spec, stepper="dopri5",
                                n_steps=n, **kw)
            outs[k] = {m: getattr(out, m).cpu().numpy()
                       for m in RayCarry._fields}
        a, b = outs["tilt = 0"], outs["dipole"]
        same = np.ones(a["status"].shape, bool)
        for m in ("status", "n_accept", "n_reject"):
            same &= a[m] == b[m]
        err = np.max([rel_err(a[m], b[m]) for m in ("u", "t")], axis=0)
        print(f"  tilt = 0 through the general instance against the dipole "
              f"instance, float64 dopri5, {same.size:,} rays x {n} steps at "
              f"{what}: {int((~same).sum())} rays took another accept/reject "
              f"path; relative difference of u, t over the rest: median "
              f"{float(np.median(err[same])):.3e}, 99th percentile "
              f"{float(np.quantile(err[same], 0.99)):.3e}, worst "
              f"{float(err[same].max()):.3e}", flush=True)
        if over and n == 24:
            check(bool(same.all()), "tilt = 0, 24 steps: statuses and "
                                    "counters identical")
            check(float(np.median(err)) <= 1e-12 and float(err.max()) <= 1e-5,
                  "tilt = 0, 24 steps: u and t within 1e-12 in the median, "
                  "1e-5 at worst")
        elif over:
            check(same.mean() >= 0.98, "tilt = 0, 256 steps: >= 98% of rays "
                                       "keep their counters")

    # every new instance beside the dipole plume instance, in turns
    out = {}
    for dt_name, stepper in (("float32", "bs3"), ("float32", "dopri5"),
                             ("float64", "bs3"), ("float64", "dopri5")):
        res = field_cost(dt_name, stepper, dev, card)
        for k, name in fields.items():
            t = res[k]
            if (dt_name, stepper) == ("float32", "bs3"):
                t.update(plain_ms=plain_ms[k], plain_rays=t["rays"],
                         plain_n=SIDE_N)
                out[k] = (errs[k], t)
            else:
                t.update(plain_cut(name, dt_name, stepper, dev))
            print_timing(f"{k} {dt_name} {stepper}", t, card)
    return out



def drive(conf, what, card):
    """One run of the slice through run.run on the card with the launch
    counts set to 0 just before; returns (out, wall, launches, calls).
    drive.team_launches is the run's launches through the team body (and
    drive.group_launches through the group body; drive.sizes the rays of
    each trace call's launch),
    drive.finish_launches and drive.fresh_launches those with each flag,
    drive.traces the trace calls on kernel pools (one launch each, or one
    a block of the trajectory channel), drive.post_refines the calls of
    refine_events in trace's _finish (the torch-op pools' and the
    trajectory channel's post-pass) and drive.init_rhs the right-hand
    sides init_carry formed on the host, and drive.tail its last launch
    (kernel_ab.capture_tail's form)."""
    from raytrace_tpu_torch.integrate import solve
    from raytrace_tpu_torch.kernel_ab import recording_launches
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.run import run, summarize

    sc.step_chunk.launches = 0
    sc.step_chunk.team_launches = 0
    sc.step_chunk.sparse_launches = 0
    sc.step_chunk.group_launches = 0
    sc.step_chunk.finish_launches = 0
    sc.step_chunk.fresh_launches = 0
    sc.step_chunk_reference.calls = 0
    refine, init = solve.refine_events, solve.init_carry
    post, rhs_inits = [], []
    solve.refine_events = lambda *a, **k: post.append(1) or refine(*a, **k)
    solve.init_carry = (lambda rhs_fn, *a, **k: rhs_inits.append(
        rhs_fn is not None) or init(rhs_fn, *a, **k))
    try:
        with recording_launches() as seen:
            t0 = time.perf_counter()
            out = run(conf, device="cuda")
            wall = time.perf_counter() - t0
    finally:
        solve.refine_events, solve.init_carry = refine, init
    launches = sc.step_chunk.launches
    drive.team_launches = sc.step_chunk.team_launches
    drive.sparse_launches = sc.step_chunk.sparse_launches
    drive.group_launches = sc.step_chunk.group_launches
    drive.finish_launches = sc.step_chunk.finish_launches
    drive.fresh_launches = sc.step_chunk.fresh_launches
    drive.post_refines, drive.init_rhs = len(post), sum(rhs_inits)
    drive.traces = len(seen)
    calls = sc.step_chunk_reference.calls
    drive.kws = [launch[-1] for launch in seen]
    drive.sizes = [int(launch[1].shape[0]) for launch in seen]
    carry, f, env, cfg, spec, kw = seen[-1]
    drive.tail = dict(name=conf.name, env=env, carry=carry._asdict(), f=f,
                      kw=kw, cfg=cfg._asdict(), spec=spec._asdict(),
                      round=dict(out["rounds"][-1]))
    stats, valid = out["stats"], out["valid"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_stiff = int(np.asarray(out["stiff"])[valid].sum())
    print(f"  {summarize(out['result'], valid)}, median landing L "
          f"{float(stats['median_landing_l']):.15f}")
    for r in out["rounds"]:
        print(f"   round: {r['stepper']:6s} active {r['active']:5d} bucket "
              f"{r['bucket']:5d} steps {r['steps']:5d} attempted "
              f"{r['attempted']:9d} wall {r['wall_s'] * 1e3:8.1f} ms")
    print(f"  step kernel launches {launches} ({drive.team_launches} through "
          f"the team body, {drive.group_launches} through the group body, "
          f"{drive.sparse_launches} in the tail layout, "
          f"{drive.finish_launches} with finish, "
          f"{drive.fresh_launches} with fresh), plain-version calls {calls}, "
          f"rays on the stiff pool {n_stiff}; refine_events after a launch "
          f"{drive.post_refines}, right-hand sides of init_carry on the host "
          f"{drive.init_rhs}")
    print(f"  {what}: wall {wall:.4f} s, {steps} attempted ray-steps, "
          f"{steps / wall / 1e6:.2f}M ray-steps/s on {card}", flush=True)
    return out, wall, launches, calls


def finished_on_card(conf, what, card):
    """Phases 4 and 6: in the last drive every trace call on a kernel pool
    (a round's launch) made one launch with finish, the first also with
    fresh, and the host refined no event and formed no first right-hand
    side (the stiff pool is empty in these runs); then one more run under
    torch.profiler counts the small kernels that remain around the step
    kernel (profile_run.profiled)."""
    from raytrace_tpu_torch.profile_run import profiled

    check(drive.traces > 0 and drive.finish_launches == drive.traces
          and drive.fresh_launches == 1,
          f"{what}: {drive.finish_launches} launches with finish for "
          f"{drive.traces} trace calls on kernel pools, one with fresh")
    check(drive.post_refines == 0 and drive.init_rhs == 0,
          f"{what}: refine_events never ran after a launch, init_carry formed "
          "no right-hand side on the host")
    r = profiled(conf)
    busy = r["busy_us"] / 1e6
    print(f"  {what}, one run under torch.profiler: step kernel "
          f"{len(r['step_us'])} launches, {sum(r['step_us']) / 1e3:.2f} ms; "
          f"small kernels {r['other_n']}, {r['other_us'] / 1e3:.2f} ms; "
          f"device busy {busy * 1e3:.2f} ms, idle "
          f"{1 - busy / r['profiled_wall']:.1%} of {r['profiled_wall']:.4f} s "
          f"on {card}", flush=True)
    return r


def tail_timing(what, card, reps=2):
    """The last launch of the last drive (the merged tail of a run with
    one) replayed on the card: {ms, rays, bucket, attempts, longest}."""
    from raytrace_tpu_torch.kernel_ab import replay_tail

    t = replay_tail(drive.tail, reps, env=drive.tail["env"])
    t.pop("out")
    print(f"  {what}: the last launch replayed, {t['rays']} rays in a "
          f"bucket of {t['bucket']}, {t['attempts']:,} attempts made (the "
          f"longest ray {t['longest']:,}): {t['ms']:.3f} ms, "
          f"{t['ms'] * 1e3 / max(t['longest'], 1):.3f} us per attempt of "
          f"the longest on {card}", flush=True)
    return t


def layout_of(b, flags_before):
    """The layout of the launch just made of b rays, by the tail layout's
    counter (step_chunk.sparse_launches, its value before the launch)."""
    from raytrace_tpu_torch.ops import step_chunk as sc

    return ("tail (one ray a warp, or the team body over the non-axial "
            "fields)" if sc.step_chunk.sparse_launches > flags_before
            else "dense (32 rays a warp)")


def chain_layouts(frame, dev, card, n=CUT_N):
    """Phases 2 and 16: the main path's redesigned instance of `frame`
    (float32 bs3 over the axisymmetric medium: the stage loop, the short
    chain, the tail layout) bit for bit with its plain version, B rays of
    the fan x n attempts with finish and fresh, at B = 1, 31, 33, 41, 256,
    the tail layout's threshold and one past it, each launch's layout
    printed and checked against the rule; in the colatitude frame also
    the whole fan in the dense layout with the flags off and on (phase 2
    holds the latitude frame's there)."""
    import torch

    from raytrace_tpu_torch.integrate.solve import RayCarry, refine_events
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc

    full = start("ensemble10k", "float32", dev, frame=frame)
    carry, f, env, cfg, spec, kw = full
    limit = sc.TAIL_LAYOUT_MAX_RAYS
    rhs_fn = rhs_mod.frame_rhs(frame, env)[0]
    cases = [(b, True) for b in (1, 31, 33, 41, 256, limit, limit + 1)]
    if frame == "2d_colat":
        cases += [(f.shape[0], False), (f.shape[0], True)]
    for b, flags in cases:
        rows = torch.arange(b, device=dev) * (f.shape[0] // b)
        c = RayCarry(*(x.index_select(0, rows) for x in carry))
        fb = f.index_select(0, rows)
        before = sc.step_chunk.sparse_launches
        got = sc.step_chunk(c, fb, env, cfg, spec, stepper="bs3", n_steps=n,
                            finish=flags, fresh=flags, **kw)
        layout = layout_of(b, before)
        ref = sc.step_chunk_reference(c, fb, env, cfg, spec, stepper="bs3",
                                      n_steps=n, **kw)
        if flags:
            ref = refine_events(rhs_fn, ref, fb, spec)
        host = lambda x: {k: getattr(x, k).cpu().numpy()  # noqa: E731
                          for k in RayCarry._fields}
        n_diff = n_differ(host(got), host(ref))
        print(f"  {frame} float32 bs3, {b:,} rays x {n} attempts"
              f"{' with finish and fresh' if flags else ''}: layout "
              f"{layout}, {n_diff} values differ", flush=True)
        check(layout.startswith("tail") == (b <= limit),
              f"{frame} {b} rays: the tail layout exactly at <= {limit} rays")
        check(n_diff == 0, f"{frame} {b} rays, layout {layout.split()[0]}: "
                           "bit for bit with the plain version")


def tail_layouts(what, conf, card, census, n=CUT_N):
    """After a drive of conf (phases 4, 12, 13 and 16): its merged tail
    replayed in the tail layout (one ray a warp, or over the non-axial
    fields the team body) and in the dense one, the whole launch, bit for
    bit; the tail layout against the plain version over the tail's first n
    attempts; then (a)-(e) of latency_floor.measure_cell (the launch, the
    tail dense, its longest ray alone, one ray a warp, and the tail as the
    wrapper launches it) with clocks.sm, in cycles an attempt, beside the
    attempt loop's size of each body of the instance (census,
    sass_census.run_census; in 2D its chain is not walkable through the
    stage loop, so the latency floor is PERF.md's, from the unrolled
    parent) and the chain with what it waits on. Returns measure_cell's
    record."""
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import (
        RayCarry, SolverConfig, refine_events,
    )
    from raytrace_tpu_torch.latency_floor import measure_cell
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc

    tail = drive.tail
    env = tail["env"]
    carry = RayCarry(**tail["carry"])
    f, kw = tail["f"], tail["kw"]
    cfg, spec = SolverConfig(**tail["cfg"]), StopSpec(**tail["spec"])
    host = lambda x: {k: getattr(x, k).cpu().numpy()  # noqa: E731
                      for k in RayCarry._fields}
    outs = {}
    for limit in (sc.TAIL_LAYOUT_MAX_RAYS, 0):
        own, sc.TAIL_LAYOUT_MAX_RAYS = sc.TAIL_LAYOUT_MAX_RAYS, limit
        try:
            before = sc.step_chunk.sparse_launches
            outs[limit] = host(sc.step_chunk(carry, f, env, cfg, spec, **kw))
            outs[limit, "layout"] = layout_of(f.shape[0], before)
        finally:
            sc.TAIL_LAYOUT_MAX_RAYS = own
    lay, dense = outs[sc.TAIL_LAYOUT_MAX_RAYS], outs[0]
    n_diff = n_differ(lay, dense)
    print(f"  {what}: the merged tail ({tail['round']['active']} rays in a "
          f"bucket of {f.shape[0]}) replayed whole in the layouts "
          f"{outs[sc.TAIL_LAYOUT_MAX_RAYS, 'layout']} and "
          f"{outs[0, 'layout']}: {n_diff} values differ", flush=True)
    check(outs[sc.TAIL_LAYOUT_MAX_RAYS, "layout"].startswith("tail"),
          f"{what}: the merged tail runs in the tail layout")
    check(n_diff == 0, f"{what}: the merged tail bit for bit in both layouts")
    cut = {k: v for k, v in kw.items() if k not in ("finish", "fresh")}
    got = host(sc.step_chunk(carry, f, env, cfg, spec,
                             **dict(cut, n_steps=n)))
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec,
                                  **dict(cut, n_steps=n))
    n_diff = n_differ(got, host(ref))
    print(f"  {what}: the merged tail's first {n} attempts in the tail layout "
          f"against the plain version: {n_diff} values differ", flush=True)
    check(n_diff == 0, f"{what}: the merged tail in the tail layout bit for "
                       "bit with the plain version")
    tail = dict(tail, kw=cut)
    rec = measure_cell(conf, tail, crossover=False)
    from raytrace_tpu_torch import sass_census
    from raytrace_tpu_torch.latency_floor import instance_of

    for key, inst in sass_census.bodies(census, instance_of(conf)).items():
        print(f"  {what}, {key}: attempt loop {inst['loop']:,} SASS "
              f"instructions, {inst['loop_bytes']:,} bytes, "
              f"{inst['inner_loop']:,} of them its inner loop, chain with "
              f"what it waits on {inst['chain_cycles_total']:,} cycles "
              "(sass_census)")
    names = {"a": "(a) the launch, 10,240 rays x 512",
             "b": "(b) the merged tail, dense layout",
             "c": "(c) its longest ray alone, B = 1",
             "d": "(d) the tail one ray a warp (spaced lanes)",
             "e": "(e) the tail as launched (tail layout)"}
    for key, name in names.items():
        r = rec[key]
        print(f"  {what} {name}: {r['ms']:.3f} ms at clocks.sm "
              f"{r['mhz']:.0f} MHz, {r['cycles_per_attempt']:,.0f} cycles an "
              f"attempt of the longest ray ({r['longest']:,} attempts) on "
              f"{card}", flush=True)
    check(rec["tail"]["spread_same"] and rec["tail"]["alone_attempts"]
          == rec["tail"]["longest"],
          f"{what}: the spaced lanes and the longest ray alone step as in "
          "the tail")
    return rec


def body(launches, what, team):
    """Fails unless every launch of the last drive went through the team
    body (team) or none did (the instances that keep the one-thread
    body)."""
    if team:
        check(launches > 0 and drive.team_launches == launches,
              f"{what}: all {launches} launches went through the team body")
    else:
        check(launches > 0 and drive.team_launches == 0,
              f"{what}: all {launches} launches went through the one-thread "
              "body (its instance keeps it)")


def stop_branches(dev):
    """Phase 19: EVANESCENT (stop_retrograde, a third of the rays started
    at a negative group delay) and ESCAPED (r_ceil 2% above the launch
    radius) through two team instances (the 3D full float bs3 and double
    dopri5) and a one-thread instance (the 2D float bs3), every 10th ray x
    128 attempts, bit for bit with the plain version; each stop must
    occur."""
    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.ops import step_chunk as sc

    for name, dt_name, stepper, team, what in (
        ("ensemble10k_plume", "float32", "bs3", True,
         "team body, 3D full medium"),
        ("ensemble10k_plume", "float64", "dopri5", True,
         "team body, 3D full medium"),
        ("ensemble10k", "float32", "bs3", False,
         "one-thread body, 2D axisymmetric"),
    ):
        carry, f, env, cfg, spec, kw = start(name, dt_name, dev, every=10)
        spec = spec._replace(r_ceil=float(carry.u[:, 0].max()) * 1.02,
                             stop_retrograde=1.0)
        u = carry.u.clone()
        u[::3, -1] = -1.0e-3
        carry = carry._replace(u=u)
        k = sc.team_warps(0 if dt_name == "float32" else 1,
                          sc._STEPPER_CODE[stepper],
                          sc._FRAME_CODE[kw["frame"]][0],
                          sc.medium_code(env, cfg), sc.field_code(env))
        check((k > 0) == team, f"{name} {dt_name} {stepper} takes the {what}")
        got, ref, _ = both(carry, f, env, cfg, spec, stepper, 128, kw)
        n_diff = n_differ(got, ref)
        n_esc = int((got["status"] == events.ESCAPED).sum())
        n_eva = int((got["status"] == events.EVANESCENT).sum())
        print(f"  {name} {dt_name} {stepper} ({what}), {f.shape[0]:,} rays x "
              f"128 steps: {n_esc} ESCAPED, {n_eva} EVANESCENT, {n_diff} "
              "values differ", flush=True)
        check(n_esc > 0 and n_eva > 0 and n_diff == 0,
              f"{name} {dt_name} {stepper}: ESCAPED and EVANESCENT launched, "
              "bit for bit with the plain version")


def rays_alone(name, rays, out64, **over):
    """Each named ray of a float64 run of preset `name` (`over` overrides
    other fields of the preset), traced alone on the card (one ray, one
    full-budget round and what `over` adds): it must keep the status it
    has in the fan."""
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.run import run

    conf = preset(name)
    axes = ("lats", "phis", "chis", "freqs")
    for i in rays:
        idx = np.unravel_index(i, [len(getattr(conf, k)) for k in axes])
        one = run(preset(name, dtype="float64", **over,
                         **{k: (getattr(conf, k)[j],)
                            for k, j in zip(axes, idx)}), device="cuda")
        res, res1 = out64["result"], one["result"]
        print(f"  ray {i}: {events.STATUS_NAMES[int(res.status[i])]} after "
              f"{int(res.n_accept[i])} accepted + {int(res.n_reject[i])} "
              f"rejected; alone {events.STATUS_NAMES[int(res1.status[0])]} "
              f"after {int(res1.n_accept[0])} + {int(res1.n_reject[0])}")
        check(int(res1.status[0]) == int(res.status[i]),
              f"ray {i} alone keeps its status in the fan")


def landing_agreement(out32, out64, lat_to_l):
    """(status match share, median relative landing-L error over the
    matched HIT_EARTH rays, their count) of a float32 run against a
    float64 run of the same launch."""
    from raytrace_tpu_torch.integrate import events

    valid = out64["valid"]
    s32 = out32["result"].status[valid]
    s64 = out64["result"].status[valid]
    match = s32 == s64
    hit = match & (s64 == events.HIT_EARTH)
    u32 = out32["result"].u[valid].astype(np.float64)[hit]
    u64 = out64["result"].u[valid][hit]
    L32, L64 = lat_to_l(u32), lat_to_l(u64)
    return (float(match.mean()), float(np.median(np.abs(L32 - L64) / L64)),
            int(hit.sum()))


def variant_kernels(dev, card):
    """Phase 14. Returns {variant: (max abs err, timing dict)} of the four
    instances of the kernels' JSON record."""
    from raytrace_tpu_torch.config import MediumConfig
    from raytrace_tpu_torch.constants import B0_2D, B0_3D

    ions_2d = MediumConfig(b0=B0_2D, **MULTI_ION)
    errs, plain = {}, {}
    # float32 over all rays: the main paths' first launches (10,240 rays x
    # SIDE_N attempts) where an instance is in the kernels' record, else 1
    # attempt
    for k, label, name, st, n, med, over in (
        ("local", "ensemble10k_local (the first round's launch)",
         "ensemble10k_local", "bs3", SIDE_N, None, {}),
        ("colat", "the ensemble10k launch in the colatitude frame",
         "ensemble10k", "bs3", SIDE_N, None, COLAT),
        ("multi_ion", "the ensemble10k fan over He+ and O+", "ensemble10k",
         "dopri5", SIDE_N, ions_2d, {}),
        ("emic", "emic_heband (root -1)", "emic_heband", "dopri5", 1, None,
         {}),
        ("rk4_f32", "rk4, the ensemble10k launch at dt0 = dt_max",
         "ensemble10k", "bs3", 1, None, RK4),
        ("raymain", "raymain", "raymain", "dopri5", 1, None, {}),
    ):
        errs[k], plain[k] = bit_for_bit(label, name, "float32", st, dev, n,
                                        medium=med, **over)
    # the rk4 instance of the record is float64: the whole launch
    errs["rk4"], plain["rk4"] = bit_for_bit(
        "rk4, the ensemble10k launch at dt0 = dt_max", "ensemble10k",
        "float64", "bs3", dev, SIDE_N, **RK4)
    # float64 over every 10th ray (emic_heband's 48 whole), CUT_N attempts;
    # then each variant through the full density chain and a general field
    for label, name, steppers, every, med, over in (
        ("ensemble10k_local", "ensemble10k_local", ("bs3", "dopri5"), 10,
         None, {}),
        ("colatitude frame", "ensemble10k", ("bs3", "dopri5"), 10, None,
         COLAT),
        ("emic_heband", "emic_heband", ("bs3", "dopri5"), 1, None, {}),
        ("He+ and O+ fan", "ensemble10k", ("dopri5",), 10, ions_2d, {}),
        ("rk4 in the colatitude frame", "ensemble10k", ("bs3",), 10, None,
         dict(RK4, **COLAT)),
        ("ds_local over GCPM, a duct (a second shell), day/night",
         "ensemble10k_local", ("bs3",), 10,
         MediumConfig(b0=B0_2D, **FULL_2D["gcpm+iono_mlt+duct"]), {}),
        ("ds_local over the tilted field", "ensemble10k_tilted",
         ("dopri5",), 10, None, dict(ds_local=True)),
        ("colatitude frame over the smoothed, refilled medium",
         "ensemble10k", ("dopri5",), 10,
         MediumConfig(b0=B0_2D, **FULL_2D["smooth+refill_q+iono_mlt+duct"]),
         COLAT),
        ("He+ and O+ over the MLT medium (3D)", "ensemble10k_plume",
         ("bs3",), 10, MediumConfig(b0=B0_3D, ps_mlt=True, **MULTI_ION), {}),
        ("He+ and O+ over IGRF", "ensemble10k_igrf", ("dopri5",), 10,
         MediumConfig(b0=B0_3D, ps_mlt=True, b_model="igrf", **MULTI_ION),
         {}),
        ("rk4 over the MLT medium (3D)", "ensemble10k_plume", ("bs3",), 10,
         None, dict(adaptive=False, dt0=1.0e-3)),
        ("rk4 over the tilted field", "ensemble10k_tilted", ("bs3",), 10,
         None, dict(adaptive=False, dt0=1.0e-3)),
    ):
        for st in steppers:
            bit_for_bit(label, name, "float64", st, dev, CUT_N, every=every,
                        medium=med, **over)

    # every instance that a path of phases 15-18 launches, at 10,240 rays
    # (the multi-ion ones on the He+ and O+ fan) x 512 attempts; the plain
    # version over the whole launch (its check's SIDE_N attempts) where
    # the instance is in the kernels' record
    out = {}
    for k, label, name, dt_name, st, med, over in (
        ("local", "ds_local", "ensemble10k_local", "float32", "bs3", None,
         {}),
        (None, "ds_local", "ensemble10k_local", "float64", "bs3", None, {}),
        ("colat", "colat", "ensemble10k", "float32", "bs3", None, COLAT),
        (None, "colat", "ensemble10k", "float64", "bs3", None, COLAT),
        (None, "colat", "ensemble10k", "float32", "dopri5", None, COLAT),
        (None, "colat", "ensemble10k", "float64", "dopri5", None, COLAT),
        ("multi_ion", "multi-ion", "ensemble10k", "float32", "dopri5",
         ions_2d, {}),
        (None, "multi-ion", "ensemble10k", "float64", "dopri5", ions_2d, {}),
        (None, "rk4", "ensemble10k", "float32", "bs3", None, RK4),
        ("rk4", "rk4", "ensemble10k", "float64", "bs3", None, RK4),
        # rk4 over the 3D full chain (the team body; no preset), at the
        # plume's dt0
        (None, "rk4 3D full", "ensemble10k_plume", "float32", "bs3", None,
         dict(adaptive=False)),
        (None, "rk4 3D full", "ensemble10k_plume", "float64", "bs3", None,
         dict(adaptive=False)),
    ):
        t = time_instance(name, dt_name, st, dev, medium=med,
                          plain_full=k is not None,
                          plain_ms=plain.get(k), plain_n=SIDE_N, **over)
        stepper = "rk4" if over.get("adaptive") is False else st
        print_timing(f"{label} {dt_name} {stepper}", t, card)
        if k is not None:
            out[k] = (errs[k], t)
    return out


def local_slice(card):
    """Phase 15. Returns the float32 run's kernel launches."""
    from raytrace_tpu_torch.config import preset

    pin = LOCAL_PINS
    conf = preset("ensemble10k_local")
    drive(conf, "warm-up", card)
    out32, _, launches32, calls = drive(conf, "float32", card)
    stats = out32["stats"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    med_l = float(stats["median_landing_l"])
    check(launches32 > 0 and calls == 0,
          "the slice stepped through the kernel, never the plain version")
    check(abs(n_hit - pin["rec_hit"]) <= 0.01 * pin["rec_hit"],
          f"HIT_EARTH {n_hit} within 1% of the TPU record {pin['rec_hit']}")
    check(abs(steps - pin["rec_steps"]) <= 0.05 * pin["rec_steps"],
          f"attempted steps {steps} within 5% of the TPU record "
          f"{pin['rec_steps']}")
    check(abs(med_l - pin["rec_median_l"])
          <= REC_MEDIAN_L_RTOL * pin["rec_median_l"],
          f"median landing L {med_l:.6f} within {REC_MEDIAN_L_RTOL:g} of the "
          f"TPU record {pin['rec_median_l']}")
    print("  ensemble10k_local, float64", flush=True)
    out64, _, launches, calls = drive(
        preset("ensemble10k_local", dtype="float64"), "float64", card)
    st64 = out64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    check(launches > 0 and calls == 0,
          "float64 stepped through the kernel, never the plain version")
    check(int(st64["n_hit_earth"]) == pin["f64_hit"]
          and int(st64["n_max_phase_time"]) == pin["f64_mpt"],
          f"HIT_EARTH and MAX_PHASE_TIME equal the JAX package's float64 "
          f"{pin['f64_hit']} and {pin['f64_mpt']}")
    check(abs(steps64 - pin["f64_steps"]) <= 0.01 * pin["f64_steps"],
          f"attempted steps {steps64} within 1% of the JAX package's float64 "
          f"{pin['f64_steps']}")
    rtol = pin["f64_median_l_rtol"]
    check(abs(med64 - pin["f64_median_l"]) <= rtol * pin["f64_median_l"],
          f"median landing L {med64!r} within {rtol:g} of the JAX package's "
          f"float64 {pin['f64_median_l']}")
    match, med_rel, n_m = landing_agreement(
        out32, out64, lambda u: u[:, 0] / np.cos(u[:, 1]) ** 2)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, median "
          f"relative landing-L error {med_rel:.3e} over {n_m} matched "
          "HIT_EARTH rays (the JAX package's own: 95.02%, 2.39e-4)")
    return launches32


def colat_slices(dev, card, census):
    """Phase 16. Returns the kernel launches of the float32 colatitude
    fan, its merged tail's replay (tail_timing) and tail_layouts'
    record."""
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate import events

    print("  raymain, float64 and float32", flush=True)
    ray64, _, launches, calls = drive(preset("raymain", dtype="float64"),
                                      "float64", card)
    res = ray64["result"]
    check(launches > 0 and calls == 0,
          "raymain stepped through the kernel, never the plain version")
    check(int(res.status[0]) == events.HIT_EARTH
          and (int(res.n_accept[0]), int(res.n_reject[0]))
          == (RAYMAIN_F64["n_accept"], RAYMAIN_F64["n_reject"]),
          f"float64 HIT_EARTH after {RAYMAIN_F64['n_accept']} accepted and "
          f"{RAYMAIN_F64['n_reject']} rejected steps, as the JAX package's")
    err = max(float(np.max(np.abs(res.u[0] - np.asarray(RAYMAIN_F64["u"]))
                           / np.abs(RAYMAIN_F64["u"]))),
              abs(float(res.t[0]) / RAYMAIN_F64["t"] - 1.0))
    print(f"  final state and phase path: worst relative difference "
          f"{err:.3e} from the JAX package's float64")
    check(err <= 1e-9, "raymain float64 final state and t within 1e-9")
    ray32, _, _, _ = drive(preset("raymain"), "float32", card)
    check(int(ray32["result"].status[0]) == events.HIT_EARTH,
          "raymain float32 HIT_EARTH, as the JAX package's float32")

    print("  the ensemble10k fan in the colatitude frame, float32",
          flush=True)
    pin = COLAT_PINS
    conf = preset("ensemble10k", **COLAT)
    drive(conf, "warm-up", card)
    out32, _, launches32, calls = drive(conf, "float32", card)
    check(launches32 > 0 and calls == 0,
          "the colatitude fan stepped through the kernel, never the plain "
          "version")
    body(launches32, "the colatitude fan float32", team=False)
    tail = tail_timing("the colatitude fan float32", card)
    latency = tail_layouts("the colatitude fan float32", conf, card, census)
    chain_layouts("2d_colat", dev, card)
    check(np.isfinite(out32["result"].u[out32["valid"]]).all(),
          "every final state is finite")
    print("  the colatitude fan, float64", flush=True)
    out64, _, launches, calls = drive(
        preset("ensemble10k", dtype="float64", **COLAT), "float64", card)
    st64 = out64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    check(launches > 0 and calls == 0,
          "float64 stepped through the kernel, never the plain version")
    check(int(st64["n_hit_earth"]) == pin["f64_hit"]
          and int(st64["n_max_phase_time"]) == pin["f64_mpt"],
          f"HIT_EARTH and MAX_PHASE_TIME equal the JAX package's float64 "
          f"{pin['f64_hit']} and {pin['f64_mpt']}")
    check(abs(steps64 - pin["f64_steps"]) <= 0.01 * pin["f64_steps"],
          f"attempted steps {steps64} within 1% of the JAX package's float64 "
          f"{pin['f64_steps']}")
    check(abs(med64 - pin["f64_median_l"]) <= 1e-9 * pin["f64_median_l"],
          f"median landing L within 1e-9 of the JAX package's float64 "
          f"{pin['f64_median_l']}")
    # the colatitude frame carries theta: landing L = r / sin^2(theta)
    match, med_rel, n_m = landing_agreement(
        out32, out64, lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, median "
          f"relative landing-L error {med_rel:.3e} over {n_m} matched "
          "HIT_EARTH rays")
    floor = pin["jax_match"] - 0.005
    check(match >= floor, f"statuses match on >= {floor:.2%} of rays (the "
                          f"JAX package's own: {pin['jax_match']:.2%})")
    check(med_rel < 1e-4, "median relative landing-L error < 1e-4 (the JAX "
                          "package's own: 3.58e-6)")
    return launches32, tail, latency


def emic_slice(card):
    """Phase 17. Returns the float32 run's kernel launches."""
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate import events

    out32, _, launches32, calls = drive(preset("emic_heband"), "float32",
                                        card)
    check(launches32 > 0 and calls == 0,
          "emic_heband stepped through the kernel, never the plain version")
    n_mpt = int(out32["stats"]["n_max_phase_time"])
    check(abs(n_mpt - 48) <= 2,
          f"float32 MAX_PHASE_TIME {n_mpt} within 2 rays of the JAX "
          "package's float32 (all 48)")
    out64, _, launches, calls = drive(preset("emic_heband", dtype="float64"),
                                      "float64", card)
    res, valid = out64["result"], out64["valid"]
    check(launches > 0 and calls == 0,
          "float64 stepped through the kernel, never the plain version")
    check(bool((res.status[valid] == events.MAX_PHASE_TIME).all()
               and (res.n_accept[valid] == EMIC_F64["n_accept"]).all()
               and (res.n_reject[valid] == 0).all()),
          f"float64: every ray MAX_PHASE_TIME after {EMIC_F64['n_accept']} "
          "accepted steps and no rejection, as in the JAX package")
    u = res.u[valid]
    err = max(float(np.max(np.abs(u.sum(0) - EMIC_F64["u_sum"])
                           / np.asarray(EMIC_F64["u_abs_sum"]))),
              float(np.max(np.abs(np.abs(u).sum(0) - EMIC_F64["u_abs_sum"])
                           / np.asarray(EMIC_F64["u_abs_sum"]))),
              float(np.max(np.abs(res.t[valid] / EMIC_F64["t"] - 1.0))))
    print(f"  float64 final states summed over the rays: worst relative "
          f"difference {err:.3e} from the JAX package's")
    check(err <= 1e-9, "float64 final states and t within 1e-9")
    return launches32


def rk4_slice(card):
    """Phase 18. Returns the float64 run's kernel launches."""
    from raytrace_tpu_torch.config import preset

    conf = preset("ensemble10k", **RK4)
    drive(conf, "warm-up", card)
    out32, _, launches, calls = drive(conf, "float32", card)
    check(launches > 0 and calls == 0,
          "the rk4 fan stepped through the kernel, never the plain version")
    body(launches, "the rk4 fan float32", team=False)
    check(int(out32["stats"]["total_rejected_steps"]) == 0,
          "fixed steps: no rejection")
    print("  (float32 reported: the JAX package's on a CPU is HIT_EARTH "
          "9136 / MAX_PHASE_TIME 1077 / INVALID 27, 20,425,402 steps)")
    out64, _, launches64, calls = drive(preset("ensemble10k", dtype="float64",
                                               **RK4), "float64", card)
    st64 = out64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    check(launches64 > 0 and calls == 0,
          "float64 stepped through the kernel, never the plain version")
    body(launches64, "the rk4 fan float64", team=False)
    tail = tail_timing("the rk4 fan float64", card)
    pin = RK4_F64
    n_hit = int(st64["n_hit_earth"])
    n_mpt = int(st64["n_max_phase_time"])
    check(n_hit + n_mpt == int(np.asarray(out64["valid"]).sum())
          and abs(n_hit - pin["hit"]) <= pin["flips"],
          f"float64: every ray HIT_EARTH or MAX_PHASE_TIME, HIT_EARTH "
          f"{n_hit} within {pin['flips']} rays of the JAX package's "
          f"{pin['hit']}")
    check(abs(steps64 - pin["steps"]) <= 0.01 * pin["steps"],
          f"steps {steps64} within 1% of the JAX package's float64 "
          f"{pin['steps']}")
    check(abs(med64 - pin["median_l"]) <= pin["median_l_rtol"]
          * pin["median_l"],
          f"median landing L {med64!r} within {pin['median_l_rtol']:g} of "
          f"the JAX package's float64 {pin['median_l']}")
    match, med_rel, n_m = landing_agreement(
        out32, out64, lambda u: u[:, 0] / np.cos(u[:, 1]) ** 2)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, median "
          f"relative landing-L error {med_rel:.3e} over {n_m} matched "
          "HIT_EARTH rays (the JAX package's own: 99.53%, 2.35e-6)")
    return launches64, tail


def ref_kernels(dev, card):
    """Phase 20: the 18 ALT instances (3 frames x bs3, dopri5, rk4 x
    float32, float64) bit for bit with their plain version: bs3 over the
    whole launch x SIDE_N attempts (the reference + legacy mode in the 2D
    frames, the reference set in 3D), dopri5 and rk4 over every 10th ray x
    CUT_N; each timed at 10,240 rays x 512 beside its bound and the plain
    version (the whole launch for bs3, whose plain run the check timed;
    else the cut). Returns {(frame, dtype): (max abs err, timing)} of the
    bs3 instances."""
    out = {}
    for frame, name, over in (
        ("2d_lat", "ensemble10k", REF_LEGACY),
        ("2d_colat", "ensemble10k", dict(COLAT, **REF_LEGACY)),
        ("3d", "ensemble10k_3d", REF),
    ):
        label = f"{frame} {'reference + legacy' if frame != '3d' else 'reference'}"
        for dt_name in ("float32", "float64"):
            err, plain_ms = bit_for_bit(label, name, dt_name, "bs3", dev,
                                        SIDE_N, **over)
            t = time_instance(name, dt_name, "bs3", dev, plain_ms=plain_ms,
                              plain_n=SIDE_N, **over)
            print_timing(f"{label} {dt_name} bs3", t, card)
            out[frame, dt_name] = (err, t)
        for st in ("dopri5", "rk4"):
            more = {}
            if st == "rk4":
                more = RK4_3D if frame == "3d" else RK4
            kst = "bs3" if st == "rk4" else st
            for dt_name in ("float32", "float64"):
                _, plain_ms = bit_for_bit(label, name, dt_name, kst, dev,
                                          CUT_N, every=10, **over, **more)
                plain = dict(plain_ms=plain_ms, plain_rays=bit_for_bit.rays,
                             plain_n=CUT_N)
                t = time_instance(name, dt_name, kst, dev, plain_full=False,
                                  plain=plain, **over, **more)
                print_timing(f"{label} {dt_name} {st}", t, card)
    return out


def ref_slice(name, card):
    """Phases 21-22: preset `name` with grad_mode="reference" through
    run.run, float32 and float64, against the JAX package's censuses
    (REF_PINS). Returns (the float32 run's launches, its tail)."""
    from raytrace_tpu_torch.config import preset

    pin = REF_PINS[name]
    conf = preset(name, **REF)
    drive(conf, "warm-up", card)
    out32, _, launches32, calls = drive(conf, "float32", card)
    check(launches32 > 0 and calls == 0,
          f"{name} (reference) stepped through the kernel, never the plain "
          "version")
    body(launches32, f"{name} reference float32", team=False)
    tail = tail_timing(f"{name} reference float32", card)
    st = out32["stats"]
    steps = int(st["total_accepted_steps"] + st["total_rejected_steps"])
    got = {k: int(st[f"n_{v}"]) for k, v in (
        ("hit", "hit_earth"), ("mpt", "max_phase_time"),
        ("dtu", "dt_underflow"), ("ms", "max_steps"))}
    band = pin["f32_band"]
    for who, p32 in (("the JAX package's", pin["f32"]),
                     ("the port's plain version's", pin["port_f32"])):
        print(f"  float32: {got}, {steps} steps, against {who} on a CPU "
              f"{p32}")
        check(abs(got["hit"] - p32["hit"]) <= max(0.02 * p32["hit"], 2)
              and all(abs(got[k] - p32[k]) <= band[k] for k in band),
              f"float32 HIT_EARTH within 2% (or 2 rays) of {who}, and "
              f"MAX_PHASE_TIME / DT_UNDERFLOW / MAX_STEPS within {band} "
              "rays (the JAX package's own float32 one-ulp nudge's flow)")
        check(abs(steps - p32["steps"]) <= 0.05 * p32["steps"],
              f"float32 attempted steps {steps} within 5% of {who} "
              f"{p32['steps']}")
    check(np.isfinite(out32["result"].u[out32["valid"]]).all(),
          "every final state is finite")

    out64, _, launches64, calls = drive(preset(name, dtype="float64", **REF),
                                        "float64", card)
    check(launches64 > 0 and calls == 0,
          "float64 stepped through the kernel, never the plain version")
    st = out64["stats"]
    steps64 = int(st["total_accepted_steps"] + st["total_rejected_steps"])
    med64 = float(st["median_landing_l"])
    got = {k: int(st[f"n_{v}"]) for k, v in (
        ("hit", "hit_earth"), ("mpt", "max_phase_time"),
        ("dtu", "dt_underflow"), ("ms", "max_steps"))}
    band = pin["f64_band"]
    for who, p64 in (("the JAX package's", pin["f64"]),
                     ("the port's plain version's", pin["port_f64"])):
        print(f"  float64: {got}, {steps64} steps, median landing L "
              f"{med64!r} against {who} on a CPU {p64}")
        check(all(abs(got[k] - p64[k]) <= band[k] for k in band),
              f"float64 HIT_EARTH / MAX_PHASE_TIME / DT_UNDERFLOW / "
              f"MAX_STEPS within {band} rays of {who} (the JAX package's "
              "own one-ulp nudge's flow)")
        check(abs(steps64 - p64["steps"]) <= 0.01 * p64["steps"],
              f"float64 attempted steps {steps64} within 1% of {who} "
              f"{p64['steps']}")
        check(abs(med64 - p64["median_l"]) <= 1e-9 * p64["median_l"],
              f"float64 median landing L within 1e-9 of {who}")
    lat_to_l = ((lambda u: u[:, 0] / np.cos(u[:, 1]) ** 2)
                if preset(name).frame == "2d_lat"
                else (lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2))
    match, med_rel, n_m = landing_agreement(out32, out64, lat_to_l)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, median "
          f"relative landing-L error {med_rel:.3e} over {n_m} matched "
          f"HIT_EARTH rays (the JAX package's own: {pin['jax_match']:.2%}, "
          f"{pin['jax_dl']:.3g})")
    floor = pin["jax_match"] - 0.005
    check(match >= floor, f"statuses match on >= {floor:.2%} of rays")
    check(med_rel < 1e-4, "median relative landing-L error < 1e-4")
    return launches32, tail


def golden_rays(dev, card):
    """Phase 23: the golden rays of tests/test_goldens.py through trace()
    on the card, float64, reference + legacy. Returns the launches of the
    two dopri5 instances, and each one's max abs error against its plain
    version (bit for bit over 128 attempts from its golden launch) and
    timing there."""
    import torch

    from raytrace_tpu_torch.constants import RE
    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import (
        SolverConfig, init_carry, trace,
    )
    from raytrace_tpu_torch.models.medium import (
        make_env_lat, make_env_raymain,
    )
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc

    u0 = torch.tensor([[(RE + 1.0e6) / RE, np.pi / 4, 0.0, 0.0]],
                      dtype=torch.float64, device=dev)
    cfg = SolverConfig(dt0=1e-4, rtol=1e-9, atol=1e-14)
    colat = dict(lat_sign=-1.0, lat_offset=np.pi / 2)
    rays = {
        "raymain_t40": ("2d_colat", make_env_raymain(), 5000.0,
                        StopSpec(r_floor=1.0, t_max=40.0, **colat)),
        "lat_budget": ("2d_lat", make_env_lat(), 1000.0,
                       StopSpec(r_floor=1.0, t_max=5.0e9 / RE)),
        "raymain_wedge": ("2d_colat", make_env_raymain(), 5000.0,
                          StopSpec(r_floor=1.0, t_max=5.0e9 / RE, **colat)),
    }
    launches, res = {"2d_colat": 0, "2d_lat": 0}, {}
    for key, (frame, env, fq, spec) in rays.items():
        f = torch.tensor([fq], dtype=torch.float64, device=dev)
        sc.step_chunk.launches = 0
        sc.step_chunk_reference.calls = 0
        t0 = time.perf_counter()
        r = trace(env, u0, f, frame=frame, cfg=cfg, spec=spec,
                  stepper="dopri5", max_steps=100000, chunk=256,
                  grad_mode="reference", legacy_freq_state=True)
        u = r.u[0].cpu().numpy()
        wall = time.perf_counter() - t0
        launches[frame] += sc.step_chunk.launches
        check(sc.step_chunk.launches == 1
              and sc.step_chunk_reference.calls == 0,
              f"{key}: one kernel launch, never the plain version")
        res[key] = r
        print(f"  {key}: {events.STATUS_NAMES[int(r.status[0])]} at t = "
              f"{float(r.t[0]):.6f} after {int(r.n_accept[0])} accepted + "
              f"{int(r.n_reject[0])} rejected, u = {u.tolist()}, wall "
              f"{wall:.3f} s on {card}", flush=True)
    for key, gold in (("raymain_t40", GOLD_RAYMAIN_T40),
                      ("lat_budget", GOLD_LAT_BUDGET)):
        r = res[key]
        u = r.u[0].cpu().numpy()
        rel = np.abs(u - gold) / np.abs(gold)
        print(f"  {key}: relative distance from the golden state "
              + ", ".join(f"{x:.2e}" for x in rel))
        check(int(r.status[0]) == events.MAX_PHASE_TIME
              and (rel[:3] <= 1e-6).all() and rel[3] <= 1e-4,
              f"{key}: MAX_PHASE_TIME, (r, angle, chi) within rtol 1e-6 and "
              "T within 1e-4 of the golden state")
    r = res["raymain_wedge"]
    check(int(r.status[0]) == events.DT_UNDERFLOW
          and abs(float(r.t[0]) - GOLD_WEDGE_T) <= 0.05,
          f"raymain past t = 40: DT_UNDERFLOW at t = {GOLD_WEDGE_T} +- 0.05")

    # each golden instance on its golden launch, 1 ray x 128 attempts:
    # bit for bit with the plain version, then timed (kernel: mean of 5
    # after a warm-up)
    timing, errs = {}, {}
    for key in ("raymain_t40", "lat_budget"):
        frame, env, fq, spec = rays[key]
        f = torch.tensor([fq], dtype=torch.float64, device=dev)
        kw = dict(frame=frame, grad_mode="reference", legacy_freq_state=True,
                  root=1.0, adaptive=True)
        carry = init_carry(rhs_mod.frame_rhs(frame, env, 1.0, "reference",
                                             True)[0], u0, f, cfg)
        got, ref, plain_ms = both(carry, f, env, cfg, spec, "dopri5", 128,
                                  kw)
        n_diff = n_differ(got, ref)
        errs[frame] = max_abs(got, ref)
        print(f"  {key}: {frame} reference + legacy float64 dopri5, 1 ray x "
              f"128 steps from the golden launch: {n_diff} values differ, "
              f"max abs err {errs[frame]:.3e}")
        check(n_diff == 0, f"{key}: the golden instance bit for bit with "
                           "its plain version")
        ms, out = time_kernel(carry, f, env, cfg, spec, "dopri5", 128, kw, 5)
        attempts = int(((out.n_accept + out.n_reject)
                        - (carry.n_accept + carry.n_reject)).sum())
        ops = ops_per_attempt("raymain" if frame == "2d_colat"
                              else "ensemble10k", "dopri5",
                              **(dict(COLAT, **REF_LEGACY)
                                 if frame == "2d_colat" else REF_LEGACY))
        ops_ms = ops * attempts / PEAK_OPS["float64"] * 1e3
        bytes_ms = carry_bytes(4, 8, 1) / PEAK_BYTES * 1e3
        timing[frame] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            attempts=attempts, rays=1, n=128, plain_rays=1, plain_n=128)
        print_timing(f"{key} ({frame} reference + legacy float64 dopri5)",
                     timing[frame], card)
    return launches, errs, timing


def mr_continuation(dev, card):
    """Phase 24: mr_fan_3d float64 with continue_until_done: its rounds
    run, then dopri5 budgets for the MAX_STEPS rays. Returns the run's
    launches of the continuation instance (3D full float64 dopri5, the
    team body), the last continuation launch replayed, and that instance
    bit for bit with its plain version over every 10th ray of the launch x
    64 attempts: (max abs err, its timing there)."""
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate import events

    out, _, launches, calls = drive(
        preset("mr_fan_3d", dtype="float64", continue_until_done=True),
        "float64 with continue_until_done", card)
    check(launches > 0 and calls == 0,
          "stepped through the kernel, never the plain version")
    body(launches, "mr_fan_3d float64 with continuations", team=True)
    kw = drive.tail["kw"]
    n_cont = sum(k["stepper"] == "dopri5" for k in drive.kws)
    check(kw["stepper"] == "dopri5" and n_cont > 0,
          f"the last launch is a continuation on dopri5 (stepper auto): "
          f"{n_cont} continuation launches of the {launches}")
    carry = drive.tail["carry"]
    drive.tail["round"] = dict(
        active=int((carry["status"] == events.ACTIVE).sum()))
    tail = tail_timing("mr_fan_3d float64, the last continuation", card)
    res = out["result"]
    status = np.asarray(res.status)[out["valid"]]
    rest = np.ones(status.size, bool)
    rest[list(F64_R_WEDGE_RAYS)] = False
    got = {k: int((status[rest] == code).sum()) for k, code in (
        ("hit_rest", events.HIT_EARTH), ("mpt_rest", events.MAX_PHASE_TIME),
        ("dtu_rest", events.DT_UNDERFLOW), ("ms_rest", events.MAX_STEPS))}
    steps = int(np.asarray(res.n_accept).sum()
                + np.asarray(res.n_reject).sum())
    print(f"  over the {int(rest.sum())} rays besides {F64_R_WEDGE_RAYS}: "
          f"{got}, {steps} steps in all; the JAX package's: {MR_CONT}; the "
          "wedge rays end "
          + ", ".join(events.STATUS_NAMES[int(status[i])]
                      for i in F64_R_WEDGE_RAYS))
    check(all(got[k] == MR_CONT[k] for k in got),
          "HIT_EARTH / MAX_PHASE_TIME / DT_UNDERFLOW / MAX_STEPS after the "
          "continuations equal the JAX package's (the wedge rays aside)")
    check(abs(steps - MR_CONT["steps"]) <= 0.01 * MR_CONT["steps"],
          f"attempted steps {steps} within 1% of the JAX package's "
          f"{MR_CONT['steps']}")
    rays_alone("mr_fan_3d", F64_R_WEDGE_RAYS, out,
               continue_until_done=True)
    check(np.isfinite(np.asarray(res.u)[out["valid"]]).all(),
          "every final state is finite")
    err, plain_ms = bit_for_bit("the mr_fan_3d launch", "mr_fan_3d",
                                "float64", "dopri5", dev, 64, every=10)
    t = time_instance("mr_fan_3d", "float64", "dopri5", dev, n=64,
                      plain_ms=plain_ms, every=10)
    print_timing("3d full float64 dopri5 (the continuation instance)", t,
                 card)
    return n_cont, tail, (err, t)


def plain_trajectory(carry, f, env, cfg, spec, stepper, kw, n_outer,
                     save_every, save_fn):
    """The trajectory channel through the plain version on the card, as
    integrate.solve.trace records it: n_outer blocks of save_every
    attempts (step_chunk_reference), a snapshot of u, t and status after
    each, the extras over all snapshots in one call, and the final carry
    relabelled (ACTIVE -> MAX_STEPS) and refined. Returns (traj, carry)."""
    import torch

    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.integrate.solve import refine_events
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc

    rows = {"u": [], "t": [], "status": []}
    for _ in range(n_outer):
        carry = sc.step_chunk_reference(carry, f, env, cfg, spec,
                                        stepper=stepper, n_steps=save_every,
                                        **kw)
        for k in rows:
            rows[k].append(getattr(carry, k))
    traj = {k: torch.stack(v) for k, v in rows.items()}
    b, n = carry.u.shape
    traj["extras"] = save_fn(traj["u"].reshape(n_outer * b, n),
                             f.repeat(n_outer)).reshape(n_outer, b, -1)
    carry = carry._replace(status=torch.where(
        carry.status == events.ACTIVE, events.MAX_STEPS, carry.status
    ).to(torch.int32))
    rhs_fn, _ = rhs_mod.frame_rhs(kw["frame"], env, kw["root"],
                                  kw["grad_mode"], kw["legacy_freq_state"])
    return traj, refine_events(rhs_fn, carry, f, spec)


def trajectory_kernel(what, name, dev, every, n_outer, team,
                      save_every=32):
    """trace(save_every, save_fn) through the kernel -- one launch per
    block on the resident carry -- against plain_trajectory on the same
    carry of a preset's float32 launch (every `every`-th ray), bit for bit
    in every snapshot, the extras and the final carry. Returns (max abs
    err, the launches made); team: the instance's body is the team one."""
    import torch

    from raytrace_tpu_torch.integrate.saving import save_fn_for
    from raytrace_tpu_torch.integrate.solve import RayCarry, trace
    from raytrace_tpu_torch.ops import step_chunk as sc

    carry, f, env, cfg, spec, kw = start(name, "float32", dev, every=every)
    save_fn = save_fn_for(kw["frame"], env)
    n0, calls0 = sc.step_chunk.launches, sc.step_chunk_reference.calls
    team0 = sc.step_chunk.team_launches
    res = trace(env, carry.u, f, carry0=carry, cfg=cfg, spec=spec,
                stepper="bs3", max_steps=n_outer * save_every,
                save_every=save_every, save_fn=save_fn, **kw)
    torch.cuda.synchronize()
    launches = sc.step_chunk.launches - n0
    check(sc.step_chunk_reference.calls == calls0 and 0 < launches <= n_outer,
          f"{what}: {launches} kernel launches for {n_outer} blocks, the "
          "plain version not called")
    check(sc.step_chunk.team_launches - team0 == (launches if team else 0),
          f"{what}: the launches went through the "
          f"{'team' if team else 'one-thread'} body")
    ref_traj, ref_carry = plain_trajectory(carry, f, env, cfg, spec, "bs3",
                                           kw, n_outer, save_every, save_fn)

    def host(traj, c):
        d = {k: v.cpu().numpy() for k, v in traj.items()}
        d.update((f"carry.{k}", getattr(c, k).cpu().numpy())
                 for k in RayCarry._fields)
        return d

    got, ref = host(res.traj, res.carry), host(ref_traj, ref_carry)
    n_diff = n_differ(got, ref)
    st = got["status"]
    print(f"  {what} float32 bs3, {f.shape[0]:,} rays x {n_outer} blocks of "
          f"{save_every}: {int((st[-1] != 0).sum())} rays stopped, "
          f"traj u {got['u'].shape}, extras {got['extras'].shape}, "
          f"{n_diff} values differ", flush=True)
    check(n_diff == 0, f"{what}: every snapshot, the extras and the final "
                       "carry bit for bit with the plain version")
    return max_abs(got, ref), launches


def trajectory_slice(dev, card, out32, wall32, launches32):
    """Phase 25's full-width part: ensemble10k float32 with save_every=32
    and the diagnostics through run.run (the rounds tracer's channel),
    against the final-state run of phase 4 (out32, its wall and
    launches), and the rounds-assembled
    trajectory against use_rounds=False (pinned bs3, the rounds tracer's
    stall retirement off) bit for bit. Returns the trajectory run's
    launches, its states (rows, rays, 4), the rays' frequencies and the
    medium (phase 29 takes the growth along them)."""
    import torch

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.integrate.saving import save_fn_for
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.parallel.ensemble import (
        make_rounds_tracer, pad_batch,
    )
    from raytrace_tpu_torch.run import _build_u0, run, summarize

    conf = preset("ensemble10k", save_every=32, save_diagnostics=True)
    walls = []
    for _ in range(2):      # a warm-up, then the run measured
        sc.step_chunk.launches = 0
        sc.step_chunk_reference.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(conf, device=dev)
        walls.append(time.perf_counter() - t0)
    launches, calls = sc.step_chunk.launches, sc.step_chunk_reference.calls
    res, valid = out["result"], out["valid"]
    traj = res.traj
    n_rows = conf.max_steps // conf.save_every
    host_bytes = sum(v.nbytes for v in traj.values())
    row_bytes = sum(v[0, 0].nbytes for v in traj.values())
    d2h = sum((r["steps"] // conf.save_every) * r["active"] * row_bytes
              for r in out["rounds"])
    print(f"  {summarize(res, valid)}; traj " + ", ".join(
        f"{k} {v.shape} {v.dtype}" for k, v in traj.items()))
    for r in out["rounds"]:
        print(f"   round: {r['stepper']:6s} active {r['active']:5d} bucket "
              f"{r['bucket']:5d} steps {r['steps']:5d} attempted "
              f"{r['attempted']:9d} wall {r['wall_s'] * 1e3:8.1f} ms")
    print(f"  trajectory run: walls {walls[0]:.4f} s (warm-up), "
          f"{walls[1]:.4f} s; the final-state run of phase 4 {wall32:.4f} s "
          f"({walls[1] / wall32:.1f}x); {launches} kernel launches (the "
          f"final-state run: {launches32}), {len(out['rounds'])} "
          f"rounds; host buffer {host_bytes / 2**20:.1f} MiB, "
          f"{d2h / 2**20:.1f} MiB fetched from the card in the rounds' "
          f"blocks, on {card}",
          flush=True)
    check(launches > 0 and calls == 0,
          "stepped through the kernel, never the plain version")
    width = len(out32["valid"])     # 10,240 rays
    check(traj["u"].shape == traj["extras"].shape == (n_rows, width, 4)
          and traj["t"].shape == traj["status"].shape == (n_rows, width),
          f"traj u ({n_rows}, {width}, 4), t and status ({n_rows}, "
          f"{width}), extras ({n_rows}, {width}, 4)")
    v = np.asarray(valid)
    check(np.isfinite(traj["u"][:, v]).all()
          and np.isfinite(traj["t"][:, v]).all(),
          "every snapshot's u and t finite")
    nonfin = ~np.isfinite(traj["extras"][:, v])
    bad = int(nonfin.any(axis=(0, 2)).sum())
    cols = [int(nonfin[..., c].any(axis=0).sum()) for c in range(4)]
    print(f"  rays with a non-finite diagnostic in some row: {bad} (mu "
          f"{cols[0]}, dmu/dpsi {cols[1]}, dip {cols[2]}, psi {cols[3]})")
    n_any, n_mu, n_dmu = TRAJ_NONFINITE
    check(bad == n_any and cols[1] == n_dmu and abs(cols[0] - n_mu) <= 1,
          f"the rays with a non-finite diagnostic are the reference's: "
          f"{n_any} in some column and {n_dmu} in dmu/dpsi, and {n_mu} in "
          f"mu within one ray (the float32 platform band)")

    # the final states against the final-state run: the channel gives the
    # merged tail exactly its rows' attempts (14,880), the final-state
    # trace ceil(14,880 / 512) * 512 = 15,360, as the JAX package's scan
    # and chunked while_loop do; only rays that ran the whole budget can
    # differ
    ref = out32["result"]
    differ = np.zeros(v.size, bool)
    for k in ("u", "t", "status", "n_accept", "n_reject"):
        d = ~np.equal(getattr(res, k), getattr(ref, k))
        differ |= d.reshape(v.size, -1).any(axis=1)
    differ &= v
    att = res.n_accept + res.n_reject
    n_ms = int((res.status[v] == events.MAX_STEPS).sum())
    print(f"  against the final-state run: {int(differ.sum())} rays differ "
          f"(MAX_STEPS here {n_ms}, there "
          f"{int((ref.status[v] == events.MAX_STEPS).sum())}); the other "
          f"{int((v & ~differ).sum())} rays bit for bit")
    check((att[differ] == conf.max_steps).all(),
          f"every ray that differs ran the whole budget of "
          f"{conf.max_steps} attempts here (the final-state run gives the "
          f"merged tail up to 480 more)")

    # rounds vs the single program, bit for bit, stall retirement off
    pinned = dict(stepper="bs3", save_every=32, save_diagnostics=True)
    env = conf.medium.build()
    u0, f = _build_u0(conf, env, np.float32, dev)
    u0, f, valid = pad_batch(u0, f)
    t0 = time.perf_counter()
    rounds = make_rounds_tracer(
        env, device=dev, dtype=torch.float32, frame=conf.frame,
        cfg=conf.solver(), spec=conf.stop(), adaptive=conf.adaptive,
        max_steps=conf.max_steps, grad_mode=conf.grad_mode, root=conf.root,
        want_carry=False, stall_progress=0.0, stepper="bs3",
        save_every=32, save_fn=save_fn_for(conf.frame, env),
    )(u0, f, valid)
    t1 = time.perf_counter()
    single = run(preset("ensemble10k", use_rounds=False, **pinned),
                 device=dev)["result"]
    t2 = time.perf_counter()
    v = np.asarray(valid)
    n_diff = sum(int((~np.equal(rounds.traj[k][:, v], single.traj[k][:, v])
                      & ~(np.isnan(rounds.traj[k][:, v])
                          & np.isnan(single.traj[k][:, v]))).sum())
                 for k in ("u", "t", "extras")) + int(
        (rounds.traj["status"][:, v] != single.traj["status"][:, v]).sum())
    n_fin = sum(int((~np.equal(getattr(rounds, k)[v],
                               getattr(single, k)[v])).sum())
                for k in ("u", "t", "status", "n_accept", "n_reject"))
    print(f"  pinned bs3, no stall retirement: rounds {t1 - t0:.3f} s, "
          f"use_rounds=False {t2 - t1:.3f} s (its {n_rows} blocks over all "
          f"{width:,} rays, the whole history on the card); {n_diff} snapshot "
          f"values and {n_fin} final values differ", flush=True)
    check(n_diff == 0 and n_fin == 0,
          "the rounds-assembled trajectory equals use_rounds=False bit for "
          "bit (every row, the extras, the final states)")
    return launches, traj["u"], _build_u0(conf, env, np.float32, dev)[1], env


def altx_kernels(dev, card):
    """Phase 26: the 18 ALTX instances (3 frames x bs3, dopri5, rk4 x
    float32, float64) bit for bit with their plain version over every 10th
    ray x CUT_N attempts: the reference set over the MLT plume in 3D (its
    closed form over the density at the base parameters), the reference +
    legacy mode over GCPM with the duct and the day/night ionosphere in
    the 2D frames; then the local arc ceiling under the reference set, the
    He+ and O+ medium under legacy_freq_state (emic_heband's 48 rays and
    the ensemble10k fan over its ions) and the MLT GCPM plume through the
    same instances. The float32 instances that phase 27's paths launch are
    timed at 10,240 rays x 512 beside their bound and the plain version's
    cut, then the other 14 on the three launches above. Returns {path:
    (max abs err, timing)} of phase 27's four."""
    from raytrace_tpu_torch.config import MediumConfig
    from raytrace_tpu_torch.constants import B0_2D, B0_3D
    from raytrace_tpu_torch.ops import step_chunk as sc

    gcpm_2d = MediumConfig(b0=B0_2D, **GCPM_2D)
    ions_2d = MediumConfig(b0=B0_2D, **MULTI_ION)
    errs, plain = {}, {}
    launches = (
        ("3d", "ensemble10k_plume", None, REF),
        ("2d_lat", "ensemble10k", gcpm_2d, REF_LEGACY),
        ("2d_colat", "ensemble10k", gcpm_2d, dict(COLAT, **REF_LEGACY)),
    )

    def label_of(frame):
        return (f"{frame} {'reference' if frame == '3d' else 'ref + legacy'}"
                f" over {'the MLT plume' if frame == '3d' else 'GCPM'}")

    for frame, name, med, over in launches:
        label = label_of(frame)
        carry, f, env, cfg, spec, kw = start(name, "float64", "cpu", every=640,
                                             medium=med, **over)
        check(sc.medium_code(env, cfg, kw["grad_mode"],
                             kw["legacy_freq_state"]) == sc.ALTX,
              f"{label}: the launch takes the ALTX instances")
        for st in ("bs3", "dopri5", "rk4"):
            more = {}
            if st == "rk4":
                more = RK4_3D if frame == "3d" else RK4
            kst = "bs3" if st == "rk4" else st
            for dt_name in ("float32", "float64"):
                errs[frame, st, dt_name], ms = bit_for_bit(
                    label, name, dt_name, kst, dev, CUT_N, every=10,
                    medium=med, **over, **more)
                plain[frame, st, dt_name] = dict(
                    plain_ms=ms, plain_rays=bit_for_bit.rays, plain_n=CUT_N)
    for label, name, dt_name, st, every, med, over in (
        ("ensemble10k_local, reference", "ensemble10k_local", "float32",
         "bs3", 10, None, REF),
        ("ensemble10k_local, reference", "ensemble10k_local", "float64",
         "bs3", 10, None, REF),
        ("emic_heband, legacy", "emic_heband", "float32", "dopri5", 1, None,
         dict(legacy_freq_state=True)),
        ("emic_heband, legacy", "emic_heband", "float64", "dopri5", 1, None,
         dict(legacy_freq_state=True)),
        ("the ensemble10k fan over He+ and O+, legacy", "ensemble10k",
         "float32", "dopri5", 10, ions_2d, dict(legacy_freq_state=True)),
        ("the MLT GCPM plume, reference", "ensemble10k_plume", "float64",
         "dopri5", 10, MediumConfig(b0=B0_3D, ps_model="gcpm", ps_mlt=True,
                                    **{k: v for k, v in GCPM_2D.items()
                                       if k != "ps_model"}), REF),
    ):
        errs[label, dt_name], ms = bit_for_bit(
            label, name, dt_name, st, dev, CUT_N, every=every, medium=med,
            **over)
        plain[label, dt_name] = dict(plain_ms=ms, plain_rays=bit_for_bit.rays,
                                     plain_n=CUT_N)
    out = {}
    for k, label, name, st, med, over, cut in (
        ("plume", "3d reference, the plume", "ensemble10k_plume", "bs3",
         None, REF, ("3d", "bs3", "float32")),
        ("local", "2d_lat reference, ensemble10k_local", "ensemble10k_local",
         "bs3", None, REF, ("ensemble10k_local, reference", "float32")),
        ("colat", "2d_colat ref + legacy over GCPM", "ensemble10k", "bs3",
         gcpm_2d, dict(COLAT, **REF_LEGACY), ("2d_colat", "bs3", "float32")),
        ("emic", "2d_lat legacy over He+ and O+ (the ensemble10k fan)",
         "ensemble10k", "dopri5", ions_2d, dict(legacy_freq_state=True),
         ("the ensemble10k fan over He+ and O+, legacy", "float32")),
    ):
        t = time_instance(name, "float32", st, dev, medium=med,
                          plain_full=False, plain=plain[cut], **over)
        print_timing(f"{label} float32 {st}", t, card)
        out[k] = (errs[cut], t)
    # the other 14 instances on the launches above, each beside its bound
    # and the plain version's cut of the bit-for-bit check
    timed = {("3d", "bs3", "float32"), ("2d_lat", "bs3", "float32"),
             ("2d_colat", "bs3", "float32"), ("2d_lat", "dopri5", "float32")}
    for frame, name, med, over in launches:
        for st in ("bs3", "dopri5", "rk4"):
            more = (RK4_3D if frame == "3d" else RK4) if st == "rk4" else {}
            for dt_name in ("float32", "float64"):
                if (frame, st, dt_name) in timed:
                    continue
                t = time_instance(name, dt_name,
                                  "bs3" if st == "rk4" else st, dev,
                                  medium=med, plain_full=False,
                                  plain=plain[frame, st, dt_name], **over,
                                  **more)
                print_timing(f"{label_of(frame)} {dt_name} {st}", t, card)
    return out


def ad_kernels(dev, card):
    """Phase 34 (a): the 30 AD instances (the lat, colat, 3D dipole, tilted
    and IGRF rows x bs3, dopri5, rk4 x float32, float64) bit for bit with
    their plain version: bs3 over every 10th ray of the launch x CUT_N
    attempts, dopri5 and rk4 over every 20th x 16 (the launches: ensemble10k,
    the ensemble10k fan in the colatitude frame over GCPM with the duct and
    the day/night ionosphere, the MLT plume, the tilted and IGRF fans); then
    the run-time flags of the same instances (legacy_freq_state, He+ and
    O+ at the EMIC root, the local ceiling). Each instance is timed at the
    launch's 10,240 rays x 512 attempts beside its bound and the plain
    version's cut. Returns {(row, stepper, dtype): (max abs err,
    timing)}."""
    from raytrace_tpu_torch.config import MediumConfig
    from raytrace_tpu_torch.constants import B0_2D
    from raytrace_tpu_torch.ops import step_chunk as sc

    gcpm_2d = MediumConfig(b0=B0_2D, **GCPM_2D)
    out = {}
    for row, name, med, over in (
        ("2d_lat", "ensemble10k", None, {}),
        ("2d_colat over GCPM", "ensemble10k", gcpm_2d, COLAT),
        ("3d over the MLT plume", "ensemble10k_plume", None, {}),
        ("3d tilted", "ensemble10k_tilted", None, {}),
        ("3d IGRF", "ensemble10k_igrf", None, {}),
    ):
        _, _, env, cfg, _, kw = start(name, "float64", "cpu", every=640,
                                      medium=med, **AD, **over)
        check(sc.medium_code(env, cfg, kw["grad_mode"]) == sc.AD
              and sc.team_warps(0, 0, sc._FRAME_CODE[kw["frame"]][0], sc.AD,
                                sc.field_code(env)) == 0,
              f"AD {row}: the launch takes the AD instances, no team body")
        for st in ("bs3", "dopri5", "rk4"):
            more = {}
            if st == "rk4":
                more = RK4_3D if row.startswith("3d") else RK4
            kst = "bs3" if st == "rk4" else st
            every, n = (10, CUT_N) if st == "bs3" else (20, 16)
            for dt_name in ("float32", "float64"):
                err, ms = bit_for_bit(
                    f"AD {row}" + (" (fixed-step rk4)" if more else ""),
                    name, dt_name, kst, dev, n, every=every, medium=med,
                    **AD, **over, **more)
                plain = dict(plain_ms=ms, plain_rays=bit_for_bit.rays,
                             plain_n=n)
                t = time_instance(name, dt_name, kst, dev, reps=3,
                                  medium=med, plain_full=False, plain=plain,
                                  **AD, **over, **more)
                print_timing(f"AD {row} {dt_name} {st}", t, card)
                out[row, st, dt_name] = (err, t)
    for what, name, dt_name, st, every, over in (
        ("2d_lat legacy_freq_state", "ensemble10k", "float64", "bs3", 10,
         dict(legacy_freq_state=True)),
        ("emic_heband (He+, O+, root -1)", "emic_heband", "float32",
         "dopri5", 1, {}),
        ("emic_heband (He+, O+, root -1)", "emic_heband", "float64",
         "dopri5", 1, {}),
        ("ensemble10k_local (the local ceiling)", "ensemble10k_local",
         "float32", "bs3", 10, {}),
    ):
        bit_for_bit(f"AD {what}", name, dt_name, st, dev, CUT_N,
                    every=every, **AD, **over)
    # the instances with a group body, in each body
    for name, dt_name in GROUP_CUTS:
        ad_group_cut(name, dev, dt_name)
    ad_group_cut("ensemble10k", dev, legacy_freq_state=True)
    return out


# the runs whose instance has a group body (ops/step_chunk.py::group_lanes:
# the bs3 AD instances of the 2D latitude frame in float32 and float64, of
# the tilted dipole in float32 and of the 3D dipole in float64), by preset
# and dtype, and the launches phase 34 (a) cuts
GROUP_RUNS = (("ensemble10k", "float32"), ("ensemble10k_local", "float32"),
              ("ensemble10k_tilted", "float32"), ("ensemble10k", "float64"),
              ("ensemble10k_3d", "float64"))
GROUP_CUTS = (("ensemble10k", "float32"), ("ensemble10k_tilted", "float32"),
              ("ensemble10k", "float64"), ("ensemble10k_3d", "float64"))


def group_key(name, dt_name):
    """The codes (dtype, stepper, frame, medium, field) of the bs3 AD
    instance of a preset's autodiff run in a dtype: its key of
    ops/step_chunk.py::GROUP_MAX_RAYS."""
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.ops import step_chunk as sc

    conf = preset(name, dtype=dt_name, **AD)
    env = conf.medium.build()
    return (int(dt_name == "float64"), sc._STEPPER_CODE["bs3"],
            sc._FRAME_CODE[conf.frame][0],
            sc.medium_code(env, conf.solver(), "autodiff"),
            sc.field_code(env))


def group_bodies(what, carry, f, env, cfg, spec, kw, ref=None):
    """One launch of an instance with a group body in each of its bodies
    (latency_floor.GROUP_BODIES: the one-thread body, the group body),
    each bit for bit with `ref` (a host carry: the plain version's) or,
    without it, with the first body's; fails unless the group body's
    launch, and only it, counted on step_chunk.group_launches. Returns
    ({body: ms of its one launch, CUDA events}, the first body's output
    carry)."""
    import torch

    from raytrace_tpu_torch.integrate.solve import RayCarry
    from raytrace_tpu_torch.latency_floor import GROUP_BODIES, on_body
    from raytrace_tpu_torch.ops import step_chunk as sc

    ms, first = {}, None
    for body in GROUP_BODIES:
        with on_body(sc, body):
            before = sc.step_chunk.group_launches
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = sc.step_chunk(carry, f, env, cfg, spec, **kw)
            e1.record()
            torch.cuda.synchronize()
        ms[body] = e0.elapsed_time(e1)
        got = {k: getattr(out, k).cpu().numpy() for k in RayCarry._fields}
        if first is None:
            first = out
            ref = got if ref is None else ref
        n_diff = n_differ(got, ref)
        print(f"  {what}, {body} body: {ms[body]:.3f} ms, {n_diff} values "
              "differ", flush=True)
        check(sc.step_chunk.group_launches - before
              == (body != "one-thread"), f"{what}: the launch took the "
                                         f"{body} body")
        check(n_diff == 0, f"{what}, {body} body: bit for bit")
    return ms, first


def ad_group_cut(name, dev, dt_name="float32", **over):
    """Phase 34 (a): a cut of the launch of an instance with a group body
    (every 10th ray x CUT_N attempts) in each body, bit for bit with the
    plain version."""
    from raytrace_tpu_torch.integrate.solve import RayCarry
    from raytrace_tpu_torch.ops import step_chunk as sc

    carry, f, env, cfg, spec, kw = start(name, dt_name, dev, every=10,
                                         **AD, **over)
    kw = dict(kw, stepper="bs3", n_steps=CUT_N)
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, **kw)
    group_bodies(f"AD {name} {dt_name} bs3, {f.shape[0]:,} rays x {CUT_N} "
                 "attempts", carry, f, env, cfg, spec, kw,
                 {k: getattr(ref, k).cpu().numpy()
                  for k in RayCarry._fields})


def ad_group_tails(card, tails, census):
    """Phase 34 (a) on the captured tails: the merged tail of each of
    GROUP_RUNS (ad_slices' drive.tail, `tails` by preset and dtype)
    replayed whole in each body, bit for
    bit with one another, and its first CUT_N attempts with finish and
    fresh in each, bit for bit with the plain path (k1 = rhs(u),
    step_chunk_reference, refine_events); each body's ms and cycles an
    attempt of the longest ray, at clocks.sm read while the wrapper's
    launches run (latency_floor._timed), beside the latency floor of each
    body's SASS chain with what it waits on (census). Returns {(preset,
    dtype): {body: ms, ..., "as launched": ms, "mhz", "longest",
    "floor_ms": {body: ms}}}."""
    from raytrace_tpu_torch import sass_census
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import (
        RayCarry, SolverConfig, refine_events,
    )
    from raytrace_tpu_torch.latency_floor import _made, _timed, instance_of
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc

    out = {}
    for (name, dt_name), tail in tails.items():
        env, f = tail["env"], tail["f"]
        carry = RayCarry(**tail["carry"])
        cfg, spec = SolverConfig(**tail["cfg"]), StopSpec(**tail["spec"])
        cut = {k: v for k, v in tail["kw"].items()
               if k not in ("finish", "fresh")}
        rhs_fn = rhs_mod.frame_rhs(cut.get("frame", "2d_lat"), env,
                                   cut.get("root", 1.0), cut["grad_mode"],
                                   cut.get("legacy_freq_state", False))[0]
        what = (f"{name} autodiff {dt_name}, the merged tail "
                f"({tail['round']['active']} rays in a bucket of "
                f"{f.shape[0]})")
        first = dict(cut, n_steps=CUT_N)
        ref = sc.step_chunk_reference(
            carry._replace(k1=rhs_fn(carry.u, f)), f, env, cfg, spec,
            **first)
        ref = refine_events(rhs_fn, ref, f, spec)
        group_bodies(f"{what}, its first {CUT_N} attempts with finish and "
                     "fresh", carry, f, env, cfg, spec,
                     dict(first, finish=True, fresh=True),
                     {k: getattr(ref, k).cpu().numpy()
                      for k in RayCarry._fields})
        ms, whole = group_bodies(f"{what}, whole", carry, f, env, cfg, spec,
                                 cut)
        longest = int(_made(whole, carry)[:tail["round"]["active"]].max())
        ms["as launched"], mhz = _timed(
            lambda: sc.step_chunk(carry, f, env, cfg, spec, **cut), 1)
        floors = {key: inst["chain_cycles_total"] * longest / (mhz * 1e3)
                  for key, inst in sass_census.bodies(
                      census, instance_of(preset(name, dtype=dt_name,
                                                 **AD))).items()}
        print(f"  {what}, at clocks.sm {mhz:.0f} MHz, the longest ray "
              f"{longest:,} attempts: " + ", ".join(
                  f"{b} {t:.3f} ms ({t * 1e3 * mhz / longest:,.0f} cycles "
                  "an attempt)" for b, t in ms.items())
              + "; latency floor " + ", ".join(
                  f"{t:.3f} ms ({key})" for key, t in floors.items())
              + f" on {card}", flush=True)
        out[name, dt_name] = dict(ms, mhz=mhz, longest=longest,
                                  floor_ms=floors)
    return out


def group_run(conf, out, what, card):
    """Phase 34 (b) on a run of GROUP_RUNS just made by drive(conf): every
    launch of at most the wrapper's GROUP_MAX_RAYS rays for its instance
    took the group body, the rest the one-thread body; its merged tail,
    replayed (tail_timing), took the group body; the run again with every
    launch on the one-thread body gives every result bit for bit. Returns
    (the replay's timing, the run's drive.tail)."""
    from raytrace_tpu_torch.latency_floor import on_body
    from raytrace_tpu_torch.ops import step_chunk as sc

    limit = sc.GROUP_MAX_RAYS[group_key(conf.name, conf.dtype)]
    want = sum(b <= limit for b in drive.sizes)
    check(drive.team_launches == 0 and drive.group_launches == want > 0,
          f"{what}: {drive.group_launches} of its launches (of "
          f"{drive.sizes} rays) went through the group body, those of at "
          f"most {limit} rays, the rest through the one-thread body")
    tail = drive.tail
    before = (sc.step_chunk.launches, sc.step_chunk.group_launches)
    timing = tail_timing(what, card)
    replays = sc.step_chunk.launches - before[0]
    took = sc.step_chunk.group_launches - before[1]
    check(took == replays > 0,
          f"{what}: the merged tail ({tail['f'].shape[0]} rays) took the "
          f"group body ({took} of {replays} replays)")
    with on_body(sc, "one-thread"):
        thread, _, _, _ = drive(conf, f"{what}, every launch on the "
                                      "one-thread body", card)
    check(drive.group_launches == 0, "no launch took the group body")
    res, res1 = out["result"], thread["result"]
    fields = ("u", "t", "status", "n_accept", "n_reject")
    n_diff = n_differ({k: np.asarray(getattr(res, k)) for k in fields},
                      {k: np.asarray(getattr(res1, k)) for k in fields})
    check(n_diff == 0, f"{what}: the run bit for bit with the run on the "
                       "one-thread body")
    return timing, tail


def ad_pinned(out64, pin, what, lat_to_l):
    """Phase 34's float64 gate: outside the rays that the JAX package's own
    one-ulp nudge moves, the census equals the JAX package's and so does
    the median landing L of the hit rays (the statistic's lower median,
    within 1e-9); the attempted steps within 1%. A ray the nudge moves
    may land or not, and where it lands is chaotic: counted in the
    median it can be the median itself."""
    from raytrace_tpu_torch.integrate import events

    st = out64["stats"]
    status = np.asarray(out64["result"].status)[out64["valid"]]
    steps = int(st["total_accepted_steps"] + st["total_rejected_steps"])
    nudge = pin["nudge_rays"]
    idx = np.asarray(sorted(nudge), int)
    keys = (("hit", "HIT_EARTH"), ("mpt", "MAX_PHASE_TIME"),
            ("dtu", "DT_UNDERFLOW"), ("ms", "MAX_STEPS"))
    code = {k: events.STATUS_NAMES.index(v) for k, v in keys}
    got = {k: int((status == code[k]).sum()) for k, _ in keys}
    print(f"  {what}: {got}, {steps} steps, median landing L "
          f"{float(st['median_landing_l'])!r}; JAX on a CPU "
          f"{ {k: pin[k] for k, _ in keys} }, {pin['steps']}, "
          f"{pin['median_l']!r}")
    if len(idx):
        print("  the JAX package's one-ulp-nudge rays on the card: "
              + ", ".join(f"{i} {events.STATUS_NAMES[int(status[i])]} (JAX "
                          f"{nudge[i]})" for i in idx))
    outside = {k: got[k] - int((status[idx] == code[k]).sum())
               for k, _ in keys}
    outside_jax = {k: pin[k] - sum(v == name for v in nudge.values())
                   for k, name in keys}
    check(outside == outside_jax,
          f"{what}: the census equals the JAX package's outside its "
          f"{len(idx)} one-ulp-nudge rays: {outside}")
    check(abs(steps - pin["steps"]) <= 0.01 * pin["steps"],
          f"{what}: attempted steps within 1% of the JAX package's")
    hit = status == events.HIT_EARTH
    hit[idx] = False
    lands = np.sort(lat_to_l(np.asarray(out64["result"].u)[out64["valid"]]
                             [hit].astype(np.float64)))
    med = float(lands[(lands.size - 1) // 2])
    print(f"  median landing L of the hits outside those rays {med!r} "
          f"(JAX {pin['median_l']!r})")
    check(abs(med - pin["median_l"]) <= 1e-9 * pin["median_l"],
          f"{what}: that median within 1e-9 of the JAX package's")


def ad_slices(card, fused):
    """Phase 34 (b): the slice's paths with grad_mode="autodiff" through
    run.run, every launch on an AD instance: ensemble10k and
    ensemble10k_3d in float32 (after a warm-up) and float64, the float64
    censuses against the JAX package's (AD_PINS), float32 against float64
    and against the JAX package's float32 census (AD_F32), the fused set's
    float32 run of phases 4 and 6 (`fused`: {preset: out}) beside it;
    then emic_heband, ensemble10k_tilted, ensemble10k_local and raymain
    once in float32 against the JAX package's float32 census. The runs of
    GROUP_RUNS: their merged tail took the group body, and the run again
    with every launch on the one-thread body gives every result bit for
    bit; so do the float64 runs of ensemble10k and ensemble10k_3d. Returns
    {(preset, dtype): (the run's launches, its last launch replayed, that
    launch as drive.tail has it)}: float32 for every preset, float64 for
    those of AD_PINS."""
    from raytrace_tpu_torch.config import preset

    runs = {}
    for name in ("ensemble10k", "ensemble10k_3d", "emic_heband",
                 "ensemble10k_tilted", "ensemble10k_local", "raymain"):
        conf = preset(name, **AD)
        if name in ("ensemble10k", "ensemble10k_3d", "ensemble10k_tilted"):
            drive(conf, f"{name} autodiff warm-up", card)
        out32, _, launches, calls = drive(conf, f"{name} autodiff float32",
                                          card)
        check(launches > 0 and calls == 0 and all(
                  kw.get("grad_mode") == "autodiff" for kw in drive.kws),
              f"{name} (autodiff) stepped through the AD instances, never "
              "the plain version")
        check(np.isfinite(out32["result"].u[out32["valid"]]).all(),
              "every final state is finite")
        what = f"{name} autodiff float32"
        if (name, "float32") in GROUP_RUNS:
            runs[name, "float32"] = (launches,
                                     *group_run(conf, out32, what, card))
        else:
            body(launches, what, team=False)
            runs[name, "float32"] = (launches, tail_timing(what, card),
                                     drive.tail)
        got, steps = census(out32)
        pin32 = AD_F32[name]
        who = pin32.get("by", "the JAX package's")
        print(f"  float32 {got}, {steps} steps; {who} float32 autodiff "
              f"census on a CPU: HIT_EARTH {pin32['hit']}, {pin32['steps']} "
              "steps")
        check(abs(got["hit"] - pin32["hit"]) <= max(0.02 * pin32["hit"], 2)
              and abs(steps - pin32["steps"]) <= 0.05 * pin32["steps"],
              f"float32: HIT_EARTH within 2% (or 2 rays) and attempted "
              f"steps within 5% of {who} (float32 censuses differ by the "
              "platforms' rounding)")
        if name in fused:
            want, steps_f = census(fused[name])
            valid = out32["valid"]
            match = float(np.mean(out32["result"].status[valid]
                                  == fused[name]["result"].status[valid]))
            print(f"  the fused set's float32 run (same card): {want}, "
                  f"{steps_f} steps; {match:.2%} of statuses match")
        if name not in AD_PINS:
            continue
        pin = AD_PINS[name]
        conf64 = preset(name, dtype="float64", **AD)
        what = f"{name} autodiff float64"
        out64, _, launches64, calls = drive(conf64, what, card)
        check(launches64 > 0 and calls == 0,
              "float64 stepped through the kernel, never the plain version")
        runs[name, "float64"] = (launches64,
                                 *group_run(conf64, out64, what, card))
        lat_to_l = ((lambda u: u[:, 0] / np.cos(u[:, 1]) ** 2)
                    if name == "ensemble10k"
                    else (lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2))
        ad_pinned(out64, pin, f"{name} autodiff float64", lat_to_l)
        match, med_rel, n_m = landing_agreement(out32, out64, lat_to_l)
        print(f"  float32 vs float64: {match * 100:.2f}% statuses match, "
              f"median relative landing-L error {med_rel:.3e} over {n_m} "
              f"matched HIT_EARTH rays (the JAX package's own under "
              f"autodiff: {pin['jax_match']:.2%}, {pin['jax_dl']:.3g})")
        floor = pin["jax_match"] - 0.005
        check(match >= floor, f"statuses match on >= {floor:.2%} of rays")
        check(med_rel < pin["dl_max"],
              f"median relative landing-L error < {pin['dl_max']:g}")
    return runs


def override_run(conf, what, card, env_over=None, cfg_over=None, every=1):
    """One run of a preset's launch (every `every`-th ray) through
    make_rounds_tracer with run()'s keywords, over the preset's env with
    the fields of env_over replaced and its SolverConfig with those of
    cfg_over (what no RunConfig field reaches: a fractional weight, more
    ds_local_shells), the launch counts set to 0 just before; the launch
    states are run()'s, over the preset's own env. Returns (out, wall,
    launches) with out run()'s {result, valid, stats}; out["team"] holds
    the launches through the team body."""
    import torch

    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.parallel.ensemble import (
        ensemble_stats, make_rounds_tracer, pad_batch,
    )
    from raytrace_tpu_torch.run import _build_u0

    env = conf.medium.build()
    np_dt = np.float32 if conf.dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device("cuda"))
    u0, f, valid = pad_batch(u0[::every], f[::every])
    kw = rounds_kw(conf)
    kw["cfg"] = kw["cfg"]._replace(**(cfg_over or {}))
    tracer = make_rounds_tracer(
        env._replace(**(env_over or {})), device="cuda",
        dtype=torch.float32 if conf.dtype == "float32" else torch.float64,
        **kw)
    sc.step_chunk.launches = 0
    sc.step_chunk.team_launches = 0
    sc.step_chunk_reference.calls = 0
    t0 = time.perf_counter()
    res = tracer(u0, f, valid)
    wall = time.perf_counter() - t0
    launches = sc.step_chunk.launches
    spec = conf.stop()
    stats = ensemble_stats(res, valid, lat_sign=spec.lat_sign,
                           lat_offset=spec.lat_offset)
    got, steps = census({"stats": stats})
    print(f"  {what}: {got}, {steps} attempted steps, median landing L "
          f"{float(stats['median_landing_l'])!r}; {launches} launches "
          f"({sc.step_chunk.team_launches} through the team body), "
          f"plain-version calls {sc.step_chunk_reference.calls}; wall "
          f"{wall:.4f} s on {card}", flush=True)
    check(launches > 0 and sc.step_chunk_reference.calls == 0,
          f"{what}: stepped through the kernel, never the plain version")
    check(np.isfinite(np.asarray(res.u)[valid]).all(),
          f"{what}: every final state is finite")
    return dict(result=res, valid=valid, stats=stats,
                team=sc.step_chunk.team_launches), wall, launches


def any_medium_kernels(dev, card):
    """Phase 35 (a): the media and ceilings the kernel once refused, each
    launch bit for bit with its plain version (the whole launch x SIDE_N
    attempts, or every 10th ray x CUT_N): the ANY instances in 2D, in 3D
    over the plume and over the tilted dipole at ps_weight = de_weight =
    0.5 with the DE factor on, with six local-ceiling shells, under the
    reference set at ps_weight = 0.5 and over the plume at 12 MLT harmonics
    (the coefficients past eight from their buffer); AD_ANY over the plume
    at 12 harmonics and with six shells in 2D; AD over the plume at 0
    harmonics (c0 with a tangent of zeros). The float32 bs3 launch of each
    is timed at 10,240 rays x 512 attempts beside its bound and the plain
    version's cut. Returns {key: (max abs err, timing)}."""
    import dataclasses

    from raytrace_tpu_torch.config import MediumConfig, preset
    from raytrace_tpu_torch.constants import B0_2D, B0_3D
    from raytrace_tpu_torch.ops import step_chunk as sc

    de_2d = MediumConfig(b0=B0_2D, de_correction=True)
    de_mlt = MediumConfig(b0=B0_3D, ps_mlt=True, de_correction=True)
    de_tilted = dataclasses.replace(preset("ensemble10k_tilted").medium,
                                    de_correction=True)
    h12 = MediumConfig(b0=B0_3D, ps_mlt=True, ps_mlt_harmonics=12)
    h0 = MediumConfig(b0=B0_3D, ps_mlt=True, ps_mlt_harmonics=0)
    half = dict(env_over=HALF)
    six = dict(cfg_over=dict(ds_local_shells=SIX_SHELLS))
    ps_half = dict(env_over=dict(ps_weight=0.5))
    out = {}
    # (key, preset, medium, overrides, medium code, f64 stepper); every
    # one of them on the one-thread body
    for key, name, med, over, code, st64 in (
        ("2d weights", "ensemble10k", de_2d, half, sc.ANY, "bs3"),
        ("3d weights", "ensemble10k_plume", de_mlt, half, sc.ANY, "dopri5"),
        ("3d weights tilted", "ensemble10k_tilted", de_tilted, half, sc.ANY,
         "bs3"),
        ("2d six shells", "ensemble10k_local", None, six, sc.ANY, "bs3"),
        ("2d reference ps_weight", "ensemble10k", None, dict(ps_half, **REF),
         sc.ANY, "bs3"),
        ("3d 12 harmonics", "ensemble10k_plume", h12, {}, sc.ANY, "dopri5"),
        ("3d autodiff 12 harmonics", "ensemble10k_plume", h12, AD, sc.AD_ANY,
         "bs3"),
        ("2d autodiff six shells", "ensemble10k_local", None,
         dict(six, **AD), sc.AD_ANY, "bs3"),
        ("3d autodiff 0 harmonics", "ensemble10k_plume", h0, AD, sc.AD,
         "bs3"),
    ):
        _, _, env, cfg, _, kw = start(name, "float64", "cpu", every=640,
                                      medium=med, **over)
        codes = (0, 0, sc._FRAME_CODE[kw["frame"]][0],
                 sc.medium_code(env, cfg, kw["grad_mode"]),
                 sc.field_code(env))
        check(codes[3] == code and not sc.team_warps(*codes),
              f"{key}: the launch takes medium code {code}, the one-thread "
              "body")
        # float32 bs3: the whole launch where the plain version's attempts
        # are fused ops, every 10th ray for the AD chain, the reference
        # set and the general field
        whole = (kw["grad_mode"] == "fused"
                 and not name.endswith("tilted"))
        every, n = (1, SIDE_N) if whole else (10, CUT_N)
        err, ms = bit_for_bit(f"[35] {key}", name, "float32", "bs3", dev, n,
                              every=every, medium=med, **over)
        plain = dict(plain_ms=ms, plain_rays=bit_for_bit.rays, plain_n=n)
        t = time_instance(name, "float32", "bs3", dev, reps=3, medium=med,
                          plain_full=False, plain=plain, **over)
        print_timing(f"[35] {key} float32 bs3", t, card)
        out[key] = (err, t)
        bit_for_bit(f"[35] {key}", name, "float64", st64, dev, CUT_N,
                    every=10, medium=med, **over)
    return out


def any_medium_paths(card):
    """Phase 35 (b): the full-width paths over those media, every launch on
    the kernel (its ANY instances) and none of the plain version:
    ensemble10k_plume at 12 MLT harmonics through run.run, ensemble10k at ps_weight = 0.5 and every 4th
    ray of it with the DE factor at de_weight = 0.5 through
    make_rounds_tracer, each in float32 and float64 (float64 against the
    JAX package's census, ANY_PINS; float32 against float64); then, in
    float32, the plume and the tilted fan at both weights 0.5, the local
    fan with six shells, ensemble10k under the reference set at ps_weight
    = 0.5, the plume under the autodiff set at 12 and at 0 harmonics, and
    the local fan under it with six shells.
    Returns {any_medium_kernels' key: (the float32 runs' launches of that
    instance, the last launch replayed where the run went through
    run.run, else None)}."""
    import dataclasses

    from raytrace_tpu_torch.config import MediumConfig, preset
    from raytrace_tpu_torch.constants import B0_2D, B0_3D

    h12 = MediumConfig(b0=B0_3D, ps_mlt=True, ps_mlt_harmonics=12)
    runs = {}

    def plume12(dt):
        out, _, launches, calls = drive(
            preset("ensemble10k_plume", dtype=dt, medium=h12),
            f"ensemble10k_plume, 12 harmonics, {dt}", card)
        check(launches > 0 and calls == 0 and drive.team_launches == 0,
              f"ensemble10k_plume at 12 harmonics {dt}: every launch through "
              "the one-thread body of ANY, never the plain version")
        return out, launches

    lat_l = lambda u: u[:, 0] / np.cos(u[:, 1]) ** 2  # noqa: E731
    colat_l = lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2  # noqa: E731
    # (pin, how to run it in a dtype, landing L of a state)
    for pin_name, go, to_l in (
        ("plume12", plume12, colat_l),
        ("ps_half", lambda dt: override_run(
            preset("ensemble10k", dtype=dt), f"ensemble10k, ps_weight 0.5, "
            f"{dt}", card, env_over=dict(ps_weight=0.5))[::2], lat_l),
        ("de_half", lambda dt: override_run(
            preset("ensemble10k", dtype=dt,
                   medium=MediumConfig(b0=B0_2D, de_correction=True)),
            f"every 4th ray of ensemble10k, de_weight 0.5, {dt}", card,
            env_over=dict(de_weight=0.5), every=4)[::2], lat_l),
    ):
        out32, launches = go("float32")
        runs[pin_name] = (launches, tail_timing(f"[35] {pin_name} float32",
                                                card)
                          if pin_name == "plume12" else None)
        out64, launches64 = go("float64")
        check(launches64 > 0, f"{pin_name} float64 stepped through the "
                              "kernel")
        pin = ANY_PINS[pin_name]
        got, steps = census(out64)
        med = float(out64["stats"]["median_landing_l"])
        print(f"  {pin_name} float64: {got}, {steps} steps, median landing L "
              f"{med!r}; JAX on a CPU "
              f"{ {k: pin[k] for k in ('hit', 'mpt', 'dtu', 'ms')} }, "
              f"{pin['steps']}, {pin['median_l']!r}")
        check(got["hit"] == pin["hit"] and got["mpt"] == pin["mpt"],
              f"{pin_name} float64: HIT_EARTH and MAX_PHASE_TIME equal the "
              "JAX package's")
        check(abs(steps - pin["steps"]) <= 0.01 * pin["steps"],
              f"{pin_name} float64: attempted steps within 1% of the JAX "
              "package's")
        check(abs(med - pin["median_l"]) <= pin["l_rtol"] * pin["median_l"],
              f"{pin_name} float64: median landing L within "
              f"{pin['l_rtol']:g} of the JAX package's")
        if "port_median_l" in pin:
            port = pin["port_median_l"]
            print(f"  {pin_name} float64: the port's plain version on a CPU "
                  f"{port!r}, {abs(med - port) / port:.3e} apart")
            check(abs(med - port) <= 1e-9 * port,
                  f"{pin_name} float64: median landing L within 1e-9 of the "
                  "port's plain version on a CPU")
        match, med_rel, n_m = landing_agreement(out32, out64, to_l)
        print(f"  {pin_name} float32 vs float64: {match * 100:.2f}% statuses "
              f"match, median relative landing-L error {med_rel:.3e} over "
              f"{n_m} matched HIT_EARTH rays (the JAX package's own: "
              f"{pin['jax_match']:.2%}, {pin['jax_dl']:.3g})")
        floor = pin["jax_match"] - 0.005
        check(match >= floor, f"statuses match on >= {floor:.2%} of rays")
        check(med_rel < pin["dl_max"],
              f"median relative landing-L error < {pin['dl_max']:g}")
    # the instances of those paths, by any_medium_kernels' keys: the plume's
    # ANY instance, and the 2D ANY one that both weights' runs took
    runs["3d 12 harmonics"] = runs.pop("plume12")
    runs["2d weights"] = (runs.pop("ps_half")[0] + runs.pop("de_half")[0],
                          None)
    de_mlt = MediumConfig(b0=B0_3D, ps_mlt=True, de_correction=True)
    de_tilted = dataclasses.replace(preset("ensemble10k_tilted").medium,
                                    de_correction=True)
    for key, conf, env_over, cfg_over in (
        ("3d weights", preset("ensemble10k_plume", medium=de_mlt), HALF,
         None),
        ("3d weights tilted", preset("ensemble10k_tilted", medium=de_tilted),
         HALF, None),
        ("2d six shells", preset("ensemble10k_local"), None,
         dict(ds_local_shells=SIX_SHELLS)),
        ("2d reference ps_weight", preset("ensemble10k", **REF),
         dict(ps_weight=0.5), None),
        ("2d autodiff six shells", preset("ensemble10k_local", **AD), None,
         dict(ds_local_shells=SIX_SHELLS)),
    ):
        out, _, launches = override_run(conf, f"{key} float32", card,
                                        env_over, cfg_over)
        check(launches > 0 and out["team"] == 0,
              f"{key}: {out['team']} of {launches} launches through the "
              "team body")
        runs[key] = (launches, None)
    for key, med in (("3d autodiff 12 harmonics", h12),
                     ("3d autodiff 0 harmonics",
                      MediumConfig(b0=B0_3D, ps_mlt=True,
                                   ps_mlt_harmonics=0))):
        out, _, launches, calls = drive(
            preset("ensemble10k_plume", medium=med, **AD), f"{key} float32",
            card)
        check(launches > 0 and calls == 0 and all(
                  kw.get("grad_mode") == "autodiff" for kw in drive.kws),
              f"{key}: stepped through the AD instances, never the plain "
              "version")
        check(np.isfinite(out["result"].u[out["valid"]]).all(),
              "every final state is finite")
        runs[key] = (launches, tail_timing(f"[35] {key} float32", card))
    return runs


def ad_cli(card):
    """Phase 34 (c): the CLI with grad_mode="autodiff" in a config file,
    `python -m raytrace_tpu_torch cut.json --out DIR` on the card (a cut of
    ensemble10k, in a process of its own that loads the library built
    above): its final states equal this process's run.run of the same
    config through the AD instances bit for bit."""
    import os
    import tempfile

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.run import run

    conf = preset("ensemble10k", lats=(0.5, 0.7, 0.9), chis=(-0.2, 0.3),
                  freqs=(1000.0, 4000.0), grad_mode="autodiff")
    sc.step_chunk.launches = 0
    want = run(conf, device="cuda")
    check(sc.step_chunk.launches > 0, "the cut stepped through the kernel")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cut.json")
        with open(path, "w") as fh:
            fh.write(conf.to_json())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "raytrace_tpu_torch", path, "--out",
             os.path.join(d, "out")], capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        print("  " + proc.stdout.strip().splitlines()[0] if proc.stdout
              else proc.stderr[-2000:])
        check(proc.returncode == 0, f"the CLI ran ({wall:.1f} s with its "
                                    f"start-up) on {card}")
        got = np.load(os.path.join(d, "out", "ensemble10k_final.npz"))
        same = all(np.array_equal(got[k], np.asarray(
            getattr(want["result"], k)), equal_nan=k == "u")
            for k in ("u", "status"))
    check(same, "the CLI's final states and statuses equal run.run's bit "
                "for bit")


def drive_legacy(conf, what, card):
    """drive() for legacy_freq_state=True, which is not a RunConfig field:
    run.run's rounds path (make_rounds_tracer with the run's keywords, one
    full-budget round for a batch of at most 64 rays) with the mode on.
    Returns (out, wall, launches, calls); out holds result, stats, valid;
    drive.kws, drive.tail and drive.team_launches as drive() sets them."""
    import torch

    from raytrace_tpu_torch.kernel_ab import recording_launches
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.parallel.ensemble import (
        ensemble_stats, make_rounds_tracer, pad_batch,
    )
    from raytrace_tpu_torch.run import _build_u0, summarize

    dev = torch.device("cuda")
    env = conf.medium.build()
    np_dt = np.float32 if conf.dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, dev)
    u0, f, valid = pad_batch(u0, f)
    spec = conf.stop()
    kw = dict(frame=conf.frame, cfg=conf.solver(), spec=spec,
              adaptive=conf.adaptive, max_steps=conf.max_steps,
              grad_mode=conf.grad_mode, root=conf.root, device=dev,
              dtype=getattr(torch, conf.dtype), stepper=conf.stepper,
              base_stepper=conf.base_stepper, want_carry=False,
              legacy_freq_state=True)
    if conf.round_steps:
        kw["round_steps"] = tuple(conf.round_steps)
    if int(valid.sum()) <= 64:
        kw["round_steps"] = (conf.max_steps,)
    tracer = make_rounds_tracer(env, **kw)
    sc.step_chunk.launches = 0
    sc.step_chunk.team_launches = 0
    sc.step_chunk_reference.calls = 0
    with recording_launches() as seen:
        t0 = time.perf_counter()
        result = tracer(u0, f, valid)
        wall = time.perf_counter() - t0
    launches, calls = sc.step_chunk.launches, sc.step_chunk_reference.calls
    drive.team_launches = sc.step_chunk.team_launches
    drive.kws = [launch[-1] for launch in seen]
    carry, fl, env_l, cfg, spec_l, kw_l = seen[-1]
    drive.tail = dict(name=conf.name, env=env_l, carry=carry._asdict(), f=fl,
                      kw=kw_l, cfg=cfg._asdict(), spec=spec_l._asdict(),
                      round=dict(tracer.last_rounds[-1]))
    stats = {k: np.asarray(v) for k, v in ensemble_stats(
        result, valid, lat_sign=spec.lat_sign,
        lat_offset=spec.lat_offset).items()}
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    print(f"  {summarize(result, valid)}; step kernel launches {launches}, "
          f"plain-version calls {calls}")
    print(f"  {what}: wall {wall:.4f} s, {steps} attempted ray-steps on "
          f"{card}", flush=True)
    return dict(result=result, stats=stats, valid=valid), wall, launches, calls


def census(out):
    st = out["stats"]
    got = {k: int(st[f"n_{v}"]) for k, v in (
        ("hit", "hit_earth"), ("mpt", "max_phase_time"),
        ("dtu", "dt_underflow"), ("ms", "max_steps"))}
    return got, int(st["total_accepted_steps"] + st["total_rejected_steps"])


def altx_slice(name, card):
    """Phase 27: preset `name` in the mode of ALTX_PINS through run.run
    (emic_heband's legacy_freq_state through drive_legacy), float32 and
    float64, every launch on an ALTX instance, against the JAX package's
    censuses. Returns (the float32 run's launches, its last launch
    replayed)."""
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.ops import step_chunk as sc

    pin = ALTX_PINS[name]
    legacy = pin["over"].get("legacy_freq_state", False)
    over = {k: v for k, v in pin["over"].items() if k != "legacy_freq_state"}

    def go(dtype, what):
        conf = preset(name, dtype=dtype, **over)
        res = (drive_legacy(conf, what, card) if legacy
               else drive(conf, what, card))
        env, cfg = drive.tail["env"], SolverConfig(**drive.tail["cfg"])
        codes = {sc.medium_code(env, cfg, kw.get("grad_mode", "fused"),
                                kw.get("legacy_freq_state", False))
                 for kw in drive.kws}
        check(res[2] > 0 and res[3] == 0 and codes == {sc.ALTX},
              f"{name} {what}: {res[2]} launches, every one on an ALTX "
              "instance; the plain version never called")
        body(res[2], f"{name} {what}", team=False)
        return res

    from raytrace_tpu_torch.integrate.solve import SolverConfig

    go("float32", "warm-up")
    out32, _, launches32, _ = go("float32", "float32")
    tail = tail_timing(f"{name} float32", card)
    got, steps = census(out32)
    res32 = out32["result"]
    check(bool(np.isfinite(res32.u[out32["valid"]]).all()
               and (res32.status[out32["valid"]] != 0).all()),
          "float32: every ray stopped, every final state finite")
    print(f"  float32: {got}, {steps} steps, against the JAX package's on a "
          f"CPU {pin['f32']}")
    if "port_f32" in pin:
        p32, band = pin["port_f32"], pin["f32_band"]
        print(f"  and the port's plain version's on a CPU {p32}")
        check(abs(got["hit"] - p32["hit"]) <= max(0.02 * p32["hit"], 2)
              and all(abs(got[k] - p32[k]) <= band[k] for k in band)
              and abs(steps - p32["steps"]) <= 0.05 * p32["steps"],
              "float32 HIT_EARTH within 2% (or 2 rays), MAX_PHASE_TIME / "
              f"DT_UNDERFLOW / MAX_STEPS within {band} rays (the JAX "
              "package's float32 one-ulp nudge's flow) and attempted steps "
              "within 5% of the port's float32 census on a CPU")
    out64, _, _, _ = go("float64", "float64")
    got, steps64 = census(out64)
    p64, band = pin["f64"], pin["f64_band"]
    med64 = float(out64["stats"]["median_landing_l"])
    print(f"  float64: {got}, {steps64} steps, median landing L {med64!r} "
          f"against the JAX package's on a CPU {p64}; its one-ulp nudge's "
          f"flow {band}"
          + (f"; the port's plain version's on a CPU {pin['port_f64']}"
             if "port_f64" in pin else ""))
    check(all(abs(got[k] - p64[k]) <= band[k] for k in band),
          f"float64 HIT_EARTH / MAX_PHASE_TIME / DT_UNDERFLOW / MAX_STEPS "
          f"within {band} rays of the JAX package's census")
    check(abs(steps64 - p64["steps"]) <= pin["steps_band"] * p64["steps"],
          f"float64 attempted steps within {pin['steps_band']:.1%} of the "
          "JAX package's (twice its one-ulp nudge's change, at least 1%)")
    if p64["hit"]:
        check(abs(med64 - p64["median_l"]) <= 1e-9 * p64["median_l"],
              "float64 median landing L within 1e-9 of the JAX package's")
    s32, s64 = np.asarray(res32.status), np.asarray(out64["result"].status)
    v = np.asarray(out64["valid"])
    match = float((s32[v] == s64[v]).mean())
    print(f"  float32 vs float64: {match:.2%} statuses match (the JAX "
          f"package's own {pin['jax_match']:.2%})")
    check(match >= pin["jax_match"] - 0.005,
          "statuses match to the JAX package's own less 0.5 points")
    if pin["jax_dl"] is not None:
        lat_to_l = ((lambda u: u[:, 0] / np.cos(u[:, 1]) ** 2)
                    if preset(name).frame == "2d_lat"
                    else (lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2))
        _, med_rel, n_m = landing_agreement(out32, out64, lat_to_l)
        print(f"  median relative landing-L error {med_rel:.3e} over {n_m} "
              f"matched HIT_EARTH rays (the JAX package's own "
              f"{pin['jax_dl']:.3g})")
        check(med_rel < 1e-4, "median relative landing-L error < 1e-4")
    return launches32, tail


def sensitivity_phase(dev, card):
    """Phase 28: the landing sensitivity, the variational system as torch
    ops on the card (one attempt captured as a CUDA graph and replayed):
    graph and eager bit for bit over a short leg, each attempt's cost; the
    canonical RayTrace_lat ray's event-projected Jacobian against the JAX
    package's (SENS_CANON); run(sensitivity_rays=4) on ensemble10k at a
    budget of 512 attempts. Returns the canonical ray's wall."""
    import torch

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.constants import RE
    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import SolverConfig, trace_rhs
    from raytrace_tpu_torch.models.medium import make_env_lat
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.run import run
    from raytrace_tpu_torch.sensitivity import (
        landing_sensitivity, make_variational_rhs,
    )

    fn = rhs_mod.frame_rhs("2d_lat", make_env_lat())[0]
    cfg = SolverConfig(rtol=1e-9, atol=1e-13)
    spec = StopSpec(r_floor=1.0, t_max=5e9 / RE)
    u0 = np.array([(RE + 1.0e6) / RE, np.pi / 4, 0.0, 0.0])
    ua0 = torch.cat([torch.tensor(u0), torch.eye(4).reshape(16)]).to(
        dev, torch.float64)[None]
    f = torch.tensor([1000.0], dtype=torch.float64, device=dev)
    aug = make_variational_rhs(fn, 4)
    legs, walls = {}, {}
    for graph in (False, True, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        legs[graph] = trace_rhs(aug, ua0, f, cfg=cfg, spec=spec,
                                max_steps=16, chunk=16, graph=graph)
        torch.cuda.synchronize()
        walls[graph] = time.perf_counter() - t0
    a, b = legs[False], legs[True]
    same = all(torch.equal(x, y) for x, y in zip(a.carry, b.carry))
    n_att = int(a.n_accept[0] + a.n_reject[0])
    print(f"  a 16-attempt leg of the canonical ray's variational system "
          f"(4 + 16 states, float64): eager {walls[False]:.3f} s "
          f"({walls[False] / n_att * 1e3:.2f} ms an attempt), through the "
          f"CUDA graph {walls[True]:.3f} s ({walls[True] / n_att * 1e3:.2f} "
          f"ms an attempt, the capture included) on {card}")
    check(same, "the CUDA graph's attempts equal the eager ones bit for bit")
    sc.step_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = landing_sensitivity(fn, u0, 1000.0, cfg=cfg, spec=spec,
                              device=dev)
    wall = time.perf_counter() - t0
    rel = abs(out["amplification"] / SENS_CANON["amp"] - 1.0)
    print(f"  the canonical ray: {events.STATUS_NAMES[out['status']]}, "
          f"d(lat_land)/d(lat_0) = {out['jac'][1, 1]!r} (the JAX package "
          f"on a CPU {SENS_CANON['jac11']!r}, relative difference "
          f"{rel:.3e}), landing state {out['u_land'].tolist()}, wall "
          f"{wall:.1f} s on {card}", flush=True)
    check(out["status"] == events.HIT_EARTH, "the canonical ray lands")
    check(rel <= 1e-3, "amplification within 1e-3 of the JAX package's")
    check(float(np.max(np.abs(out["u_land"] - SENS_CANON["u_land"])))
          <= 1e-6, "landing state within 1e-6 of the JAX package's")
    check(sc.step_chunk.launches == 0,
          "the variational system runs as torch ops (no step-kernel "
          "launch)")
    conf = preset("ensemble10k", max_steps=512, sensitivity_rays=4)
    t0 = time.perf_counter()
    res = run(conf, device="cuda")
    wall_run = time.perf_counter() - t0
    amp = np.asarray(res["stats"]["sensitivity_amplification"])
    st = np.asarray(res["stats"]["sensitivity_status"])
    print(f"  run(ensemble10k, max_steps=512, sensitivity_rays=4), "
          f"float32: amplification {amp.tolist()}, status "
          f"{[events.STATUS_NAMES[int(x)] for x in st]}, wall "
          f"{wall_run:.1f} s on {card}", flush=True)
    check(amp.shape == (4,) and np.isfinite(amp).all(),
          "four finite amplifications in the stats")
    check(bool(np.isin(st, [events.HIT_EARTH, events.MAX_PHASE_TIME,
                            events.DT_UNDERFLOW, events.MAX_STEPS]).all()),
          "each sensitivity ray ended on a stop or at the budget")
    return wall


def worst_rel(a, b):
    """The largest relative difference of a against b over b's finite
    entries."""
    a, b = np.ravel(a), np.ravel(b)
    fin = np.isfinite(b)
    return float(rel_err(a[fin], b[fin]).max()) if fin.any() else 0.0


def sync(dev):
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tiers_for(dev, graph=True):
    """The port's tier functions on `dev`, numpy in and out: the namespace
    lightning_chain and two_belt_chain take. graph: precipitation_lifetime
    and evolve_radial replay one iteration (one CN step) as a CUDA graph."""
    import inspect
    from types import SimpleNamespace

    import torch

    from raytrace_tpu_torch import diffusion, fokker_planck, growth, radial

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(host(v) for v in x)
        return x

    def wrap(fn):
        extra = ({"graph": graph}
                 if "graph" in inspect.signature(fn).parameters else {})
        return lambda *a, **kw: host(fn(*a, device=dev, **extra, **kw))

    ns = SimpleNamespace(HotElectrons=growth.HotElectrons,
                         WaveSpectrum=diffusion.WaveSpectrum)
    for mod, names in (
            (growth, ("path_gain",)),
            (diffusion, ("spectrum_from_rays", "bounce_averaged",
                         "loss_cone_lifetime_s")),
            (fokker_planck, ("make_grid", "precipitation_lifetime")),
            (radial, ("make_l_grid", "dll_power_law", "steady_state",
                      "evolve_radial"))):
        for name in names:
            setattr(ns, name, wrap(getattr(mod, name)))
    return ns


def lightning_fan(conf=LIGHTNING):
    """The fan of examples/lightning_to_lifetimes.py: launch states at
    1000 km over lats x freqs (chi = 0), and the frequencies."""
    from raytrace_tpu_torch.constants import RE

    lat_g, f_g = np.meshgrid(conf["lats"], conf["freqs"], indexing="ij")
    u0 = np.zeros((lat_g.size, 4))
    u0[:, 0] = (RE + 1.0e6) / RE
    u0[:, 1] = lat_g.ravel()
    return u0, f_g.ravel()


def lightning_setup(dev, conf=LIGHTNING):
    """(u0, f, env, cfg, spec) of the lightning fan on `dev`, float64."""
    import torch

    from raytrace_tpu_torch.constants import RE
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import SolverConfig
    from raytrace_tpu_torch.models.medium import make_env_lat

    u0, f_g = lightning_fan(conf)
    return (torch.as_tensor(u0, device=dev), torch.as_tensor(f_g, device=dev),
            make_env_lat(),
            SolverConfig(rtol=conf["rtol"], atol=conf["atol"],
                         dt0=conf["dt0"]),
            StopSpec(r_floor=1.0, t_max=conf["t_max_m"] / RE))


def lightning_stage(dev, card):
    """Phase 29 (a): examples/lightning_to_lifetimes.py as it runs, on the
    card after a warm-up and on the CPU: the fan through trace (float64
    dopri5, save_every 25: one step-kernel launch per block), then
    lightning_chain; the card's numbers against LIGHTNING_PINS. Then one
    block's launch (20 rays x 25 attempts) bit for bit with the plain
    version and timed beside its bound (lightning_block). Returns
    (launches, max abs err, timing) for the kernels' record."""
    import torch

    from raytrace_tpu_torch.integrate.solve import trace
    from raytrace_tpu_torch.ops import step_chunk as sc

    conf = LIGHTNING

    def run(device):
        u0, f, env, cfg, spec = lightning_setup(device)
        sync(device)
        t0 = time.perf_counter()
        res = trace(env, u0, f, cfg=cfg, spec=spec, stepper="dopri5",
                    max_steps=conf["max_steps"],
                    save_every=conf["save_every"])
        out = lightning_chain(tiers_for(device), res.traj["u"].cpu().numpy(),
                              res.traj["status"].cpu().numpy(),
                              f.cpu().numpy(), env)
        sync(device)
        return out, res, time.perf_counter() - t0

    run(dev)                                       # warm-up
    sc.step_chunk.launches = 0
    sc.step_chunk_reference.calls = 0
    out, res, wall = run(dev)
    launches, calls = sc.step_chunk.launches, sc.step_chunk_reference.calls
    cpu, _, wall_cpu = run(torch.device("cpu"))
    att = (res.n_accept + res.n_reject).cpu().numpy()
    print(f"  the fan: {att.size} rays, {int(att.sum()):,} attempts "
          f"(longest {int(att.max())}), traj {tuple(res.traj['u'].shape)}, "
          f"{launches} kernel launches; {int(out['crossed'].sum())} cross "
          f"the equator, {int(out['in_shell'].sum())} within 0.15 of "
          f"L* = {out['l_star']:.6f}; band f_m {out['f_m']:.3f} Hz, df "
          f"{out['df']:.3f} Hz, Bw {out['bw_t'] * 1e12:.4f} pT")
    print(f"  wall: card {wall:.3f} s, the port on the CPU {wall_cpu:.3f} s "
          f"(the CPU traces through the plain version), on {card}",
          flush=True)
    check(launches > 0 and calls == 0,
          "the fan stepped through the kernel, never the plain version")
    pins = LIGHTNING_PINS
    check(np.flatnonzero(out["in_shell"]).tolist() == pins["in_shell"]
          and int(out["crossed"].sum()) == pins["crossed"],
          f"the in-shell ray set {pins['in_shell']} exactly (the JAX "
          "package's on a CPU)")
    worst = max(abs(out[k] - pins[k]) / abs(pins[k])
                for k in ("l_star", "f_m", "df", "bw_t"))
    check(worst <= 1e-8, f"l_star, f_m, df, bw_t within 1e-8 of the JAX "
                         f"package's ({worst:.2e})")
    has = np.array(pins["has_wave"])
    tau_w = np.array(pins["tau_weak"])
    fin = np.isfinite(tau_w)
    err_e = rel_err(out["tau_e"][has], np.array(pins["tau_e"])[has]).max()
    err_w = rel_err(out["tau_weak"][fin], tau_w[fin]).max()
    check(np.array_equal(out["has_wave"], has)
          and np.array_equal(np.isfinite(out["tau_weak"]), fin)
          and max(err_e, err_w) <= 1e-6,
          f"the lifetimes within 1e-6 of the JAX package's (eigen "
          f"{err_e:.2e}, weak-diffusion {err_w:.2e})")
    print("  card against the port on the CPU: " + ", ".join(
        f"{k} {worst_rel(out[k], cpu[k]):.2e}"
        for k in ("l_star", "f_m", "bw_t", "tau_e", "tau_weak")))
    return (launches, *lightning_block(dev, card))


def lightning_block(dev, card):
    """One block's launch of the lightning fan (20 rays x save_every
    attempts, float64 dopri5, from the launch carry) bit for bit with the
    plain version, timed beside its bound. Returns (max abs err,
    timing)."""
    from raytrace_tpu_torch.integrate.solve import init_carry
    from raytrace_tpu_torch.ops import rhs as rhs_mod

    u0, f, env, cfg, spec = lightning_setup(dev)
    rhs_fn, _ = rhs_mod.frame_rhs("2d_lat", env, 1.0, "fused", False)
    carry = init_carry(rhs_fn, u0, f, cfg)
    kw = dict(frame="2d_lat", root=1.0, adaptive=True, grad_mode="fused",
              legacy_freq_state=False)
    n = LIGHTNING["save_every"]
    got, ref, plain_ms = both(carry, f, env, cfg, spec, "dopri5", n, kw)
    n_diff = n_differ(got, ref)
    check(n_diff == 0, f"the fan's first block (20 rays x {n} attempts, "
                       "float64 dopri5): kernel and plain version bit for "
                       "bit")
    ms, blk = time_kernel(carry, f, env, cfg, spec, "dopri5", n, kw, 50)
    attempts = int(((blk.n_accept + blk.n_reject)
                    - (carry.n_accept + carry.n_reject)).sum())
    bound_ms, by = bound("ensemble10k", "float64", "dopri5", 4, attempts,
                         f.shape[0])
    t = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
             attempts=attempts, rays=f.shape[0], n=n,
             plain_rays=f.shape[0], plain_n=n)
    print_timing("float64 dopri5, one block of the lightning fan", t, card)
    return max_abs(got, ref), t


def trajectory_gain_stage(dev, card, traj_u, f, env):
    """Phase 29 (b): path_gain along the whole ensemble10k trajectory of
    phase 25 ((625, 10240, 4), float32 states taken as float64) on the
    card, every 10th ray against the port on the CPU: gamma and the gain
    each within 1e-10 of the ray's largest magnitude."""
    import torch

    from raytrace_tpu_torch.growth import HotElectrons, path_gain

    hot = HotElectrons(**LIGHTNING["hot"])
    u = traj_u.astype(np.float64)
    f = np.asarray(f, np.float64)

    def run(device, rays):
        sync(device)
        t0 = time.perf_counter()
        g = path_gain(u[:, rays], f[rays], env, hot, device=device)
        g = {k: v.cpu().numpy() for k, v in g.items()}
        sync(device)
        return g, time.perf_counter() - t0

    run(dev, slice(None))                          # warm-up
    g, wall = run(dev, slice(None))
    ref, wall_cpu = run(torch.device("cpu"), slice(None, None, 10))
    db = g["gain_db"][-1]
    print(f"  path_gain over {u.shape[0]} rows x {u.shape[1]:,} rays: card "
          f"{wall:.3f} s, the port on the CPU {wall_cpu:.3f} s for every "
          f"10th ray, on {card}; final gain min {db.min():.3e} / median "
          f"{np.median(db):.3e} / max {db.max():.3e} dB, "
          f"{int((db > 0).sum())} rays with net growth", flush=True)
    check(all(np.isfinite(v).all() for v in g.values()),
          "gamma, gain and t finite for every ray and row")
    errs = {}
    for k in ("gamma", "gain_neper"):
        got, want = g[k][:, ::10], ref[k]
        scale = np.maximum(np.abs(want).max(axis=0), np.finfo(float).tiny)
        errs[k] = float((np.abs(got - want) / scale).max())
    check(max(errs.values()) <= 1e-10,
          "every 10th ray's gamma and gain within 1e-10 of its largest "
          "magnitude against the port on the CPU ("
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + ")")


def diffusion_map_stage(dev, card, conf=DIFFUSION_MAP):
    """Phase 29 (c): the bounce-averaged diffusion map of
    examples/diffusion_map.py (44 energies x 44 pitch angles x n_lat 48 at
    L = 4) at n_grid 512, n_bisect 30: float64 'si' on the card, every 4th
    energy row against the port on the CPU (D within 1e-9 wherever it is
    above 1e-6 of its row's maximum, root counts equal); float32 'mc'
    against float64, reported."""
    import torch

    from raytrace_tpu_torch.constants import C_LIGHT, FCE_E, M_E
    from raytrace_tpu_torch.diffusion import WaveSpectrum, bounce_averaged
    from raytrace_tpu_torch.models import medium

    env = medium.make_env_lat()
    one = torch.ones((), dtype=torch.float64)
    fce = FCE_E * float(medium.b_mag(4.0 * one, 0.0 * one, env))
    spec = WaveSpectrum(bw_t=100e-12, f_m=0.15 * fce, df=0.10 * fce,
                        f_lc=0.05 * fce, f_uc=0.50 * fce)
    ee, aa = np.meshgrid(np.geomspace(10.0, 2000.0, conf["n_e"]),
                         np.radians(np.linspace(3.0, 89.0, conf["n_a"])),
                         indexing="ij")
    every = conf["every"]

    def run(device, rows, dtype, units):
        e = torch.as_tensor(ee[rows], device=device).to(dtype)
        a = torch.as_tensor(aa[rows], device=device).to(dtype)
        sync(device)
        t0 = time.perf_counter()
        out = bounce_averaged(e, a, 4.0, env, spec, n_lat=conf["n_lat"],
                              n_grid=conf["n_grid"],
                              n_bisect=conf["n_bisect"], momentum_units=units)
        out = {k: v.cpu().numpy().astype(np.float64) if v.is_floating_point()
               else v.cpu().numpy() for k, v in out.items()}
        sync(device)
        return out, time.perf_counter() - t0

    run(dev, slice(None, None, 11), torch.float64, "si")     # warm-up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    m64, wall = run(dev, slice(None), torch.float64, "si")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ref, wall_cpu = run(torch.device("cpu"), slice(None, None, every),
                        torch.float64, "si")
    m32, wall32 = run(dev, slice(None), torch.float32, "mc")
    print(f"  {conf['n_e']} x {conf['n_a']} x n_lat {conf['n_lat']} x "
          f"n_grid {conf['n_grid']}: card float64 {wall:.3f} s (peak "
          f"{peak / 2**30:.2f} GiB allocated), float32 'mc' {wall32:.3f} s; "
          f"the port on the CPU {wall_cpu:.3f} s for every {every}th energy "
          f"row; on {card}; <D_aa> > 0 at "
          f"{int((m64['daa'] > 0).sum())} of {m64['daa'].size} points, "
          f"{int(m64['n_roots'].sum()):,} resonant roots", flush=True)

    def row_errs(got, want):
        """Relative errors where want is above 1e-6 of its row's maximum."""
        big = np.abs(want) > 1e-6 * np.abs(want).max(axis=1, keepdims=True)
        return (np.abs(got - want)
                / np.maximum(np.abs(want), 1e-300))[big]

    def row_err(got, want):
        e = row_errs(got, want)
        return float(e.max()) if e.size else 0.0

    errs = {k: row_err(m64[k][::every], ref[k])
            for k in ("daa", "dap", "dpp")}
    check(max(errs.values()) <= 1e-9
          and np.array_equal(m64["n_roots"][::every], ref["n_roots"]),
          f"every {every}th energy row against the port on the CPU: D within "
          "1e-9 where above 1e-6 of the row's maximum ("
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + "), root counts equal")
    s = M_E * C_LIGHT
    for k, unit in (("daa", 1.0), ("dap", s), ("dpp", s * s)):
        e = row_errs(m32[k] * unit, m64[k])
        print(f"  float32 'mc' against float64 (reported, not held), {k}: "
              f"median {np.median(e):.2e}, 99th percentile "
              f"{np.percentile(e, 99):.2e}, max {e.max():.2e}; "
              f"{int((e > 1e-3).sum())} of {e.size} points beyond 1e-3")
    print(f"  float32 root counts differ at "
          f"{int((m32['n_roots'] != m64['n_roots']).sum())} points, float32 "
          f"<D_aa> = 0 where float64's is not at "
          f"{int(((m32['daa'] == 0) & (m64['daa'] != 0)).sum())}")
    check(all(np.isfinite(v).all() for v in m32.values()),
          "the float32 map finite")


def two_belt_stage(dev, card):
    """Phase 29 (d): examples/two_belt_structure.py as it runs, on the card
    (precipitation_lifetime and evolve_radial through their CUDA graphs)
    after a cut warm-up and on the CPU, against TWO_BELT_PINS; the
    refilling's first 600 CN steps eagerly and through the graph, bit for
    bit, with the ms per step of the eager loop and of the chain's 6,000
    through the graph, and the inverse iteration's ms per iteration both
    ways."""
    import torch

    from raytrace_tpu_torch import diffusion, fokker_planck
    from raytrace_tpu_torch.models.medium import make_env_lat

    env = make_env_lat()
    warm = dict(TWO_BELT, l_probe=TWO_BELT["l_probe"][::8], n_steps=600,
                save_every=200)
    two_belt_chain(tiers_for(dev), env, conf=warm)
    sync(dev)
    t0 = time.perf_counter()
    out = two_belt_chain(tiers_for(dev), env)
    sync(dev)
    wall = time.perf_counter() - t0
    # the port on the CPU, its refilling cut to a tenth of the steps (the
    # eager CN step costs ~6 ms there)
    t0 = time.perf_counter()
    cpu = two_belt_chain(tiers_for(torch.device("cpu")), env,
                         conf=dict(TWO_BELT, n_steps=600, save_every=100))
    wall_cpu = time.perf_counter() - t0
    fin = np.isfinite(out["tau"])
    c = out["radial"]["args"][1]
    print(f"  tau(L) on {int(fin.sum())} of {fin.size} probe shells "
          f"(min {out['tau'][fin].min() / 86400:.3f} d), the slot's minimum "
          f"f_eq {out['f_eq'][(c > 1.8) & (c < env.lppi)].min():.3e}; wall "
          f"card {wall:.3f} s, the port on the CPU {wall_cpu:.3f} s with 600 "
          f"of the 6,000 CN steps, on {card}", flush=True)
    pins, every = TWO_BELT_PINS, TWO_BELT_EVERY
    tau_p = np.array(pins["tau"])
    check(np.array_equal(fin, np.isfinite(tau_p))
          and rel_err(out["tau"][fin], tau_p[fin]).max() <= 1e-8,
          f"tau(L) within 1e-8 of the JAX package's on a CPU "
          f"({rel_err(out['tau'][fin], tau_p[fin]).max():.2e})")
    errs = {k: float(rel_err(out[k][::every], np.array(pins[k])).max())
            for k in ("f_bnd", "f_src_unit", "f_free", "f_eq")}
    errs["s0"] = abs(out["s0"] - pins["s0"]) / pins["s0"]
    errs["snaps"] = float(rel_err(out["snaps"][:, ::every].ravel(),
                                  np.ravel(pins["snaps"])).max())
    check(max(errs.values()) <= 1e-9,
          "the equilibria and the snapshots within 1e-9 of the JAX "
          "package's (" + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + ")")
    print("  card against the port on the CPU: " + ", ".join(
        f"{k} {worst_rel(out[k], cpu[k]):.2e}"
        for k in ("tau", "f_bnd", "f_eq", "f_free")))

    # the refilling's first 600 steps (the eager step costs ~10 ms),
    # eagerly and through the graph; the graph's cost per step is the
    # chain's whole run's
    args, kw = out["radial"]["args"], out["radial"]["kw"]
    cut = dict(kw, n_steps=600, save_every=100)
    sync(dev)
    t0 = time.perf_counter()
    f_end, snaps = tiers_for(dev, graph=False).evolve_radial(*args, **cut)
    sync(dev)
    wall_eager, wall_graph = time.perf_counter() - t0, out["radial_s"]
    f_end_g, snaps_g = tiers_for(dev).evolve_radial(*args, **cut)
    same = (np.array_equal(f_end, f_end_g)
            and np.array_equal(snaps, snaps_g))
    n_steps = kw["n_steps"]
    print(f"  evolve_radial, CN steps of {len(args[1])} cells: eager "
          f"{wall_eager:.3f} s for {cut['n_steps']} "
          f"({wall_eager / cut['n_steps'] * 1e3:.4f} ms a step), CUDA graph "
          f"{wall_graph:.3f} s for {n_steps} "
          f"({wall_graph / n_steps * 1e3:.4f} ms a step, the capture "
          f"included), on {card}", flush=True)
    check(same, "evolve_radial through the CUDA graph equals the eager loop "
                "bit for bit over 600 steps (every snapshot and the final "
                "state)")

    # the inverse iteration both ways, on the shell L = 3
    import math

    l_shell = 3.0
    rl = 1.0 / l_shell
    a_lc = math.asin(math.sqrt(rl**3 / math.sqrt(4.0 - 3.0 * rl)))
    centers = fokker_planck.make_grid(a_lc, TWO_BELT["nc"], dev)[0]
    daa = diffusion.bounce_averaged(
        1000.0 * TWO_BELT["e_mev"], centers, l_shell, env,
        diffusion.WaveSpectrum(**TWO_BELT["spec"]), **TWO_BELT["ba"])["daa"]
    daa = torch.clamp(daa, min=1e-8 * float(daa.max()))
    per, taus = {}, {}
    for graph in (False, True):
        ts = []
        for n_iter in (64, 1024):
            sync(dev)
            t0 = time.perf_counter()
            taus[graph, n_iter] = float(fokker_planck.precipitation_lifetime(
                daa, a_lc, n_cells=TWO_BELT["nc"], n_iter=n_iter,
                graph=graph))
            sync(dev)
            ts.append(time.perf_counter() - t0)
        per[graph] = (ts[1] - ts[0]) / (1024 - 64)
    print(f"  precipitation_lifetime at L = 3 ({TWO_BELT['nc']} cells): "
          f"eager {per[False] * 1e3:.4f} ms an iteration, CUDA graph "
          f"{per[True] * 1e3:.4f} ms; tau {taus[True, 64]:.6e} s, on {card}")
    check(all(taus[False, n] == taus[True, n] for n in (64, 1024)),
          "precipitation_lifetime through the CUDA graph equals the eager "
          "loop bit for bit")


def cg_ops(op, half):
    """Operations of the CG loop on `op`, counted from the plain version
    (fokker_planck_2d._cg_bodies) on the CPU: every pointwise aten op adds
    its output's element count and every sum its input's, the masks'
    selects (torch.where) left out -- the kernel has none. Returns (ops of
    a step's set-up, ops of one iteration)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from raytrace_tpu_torch import fokker_planck_2d as fp2

    op = type(op)(**{f: (v.cpu() if isinstance(v, torch.Tensor) else v)
                     for f, v in vars(op).items()})
    setup, iterate = fp2._cg_bodies(op, half, 1.0 / (op.mass + half * op.diag),
                                    1e-10, 500, 1)
    x = torch.ones_like(op.mass)
    state = (x, x, x, x.sum(), x.sum(), torch.zeros((), dtype=torch.int64),
             torch.zeros((), dtype=torch.bool))

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.ops.aten.sum.default,
                        torch.ops.aten.sum.dim_IntList):
                Count.n += args[0].numel()
            elif (torch.Tag.pointwise in func.tags
                  and func is not torch.ops.aten.where.self):
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Count.n += sum(o.numel() for o in outs
                               if isinstance(o, torch.Tensor))
            return out

    counts = []
    for body in (setup, iterate):
        Count.n = 0
        with Count():
            body(state)
        counts.append(Count.n)
    return counts


def fp2d_stage(dev, card):
    """Phase 30: the 2D Fokker-Planck solver on the card, float64 unless
    it says otherwise. (a) The kernel of csrc/cn_pcg_2d.cu against its
    plain version through GraphLoop on chorus_acceleration's operator and
    seed, the first 180 CN steps (one snapshot interval), float64 and
    float32: the snapshot and each step's CG count, each timed per CN
    step beside the plain graph's and (4 steps) the plain eager loop's.
    (b) examples/chorus_acceleration.py and examples/belt_competition.py
    as they run, through the kernel: the tensors from the port's
    bounce_averaged (momentum_units='mc') on the card, the 1,440 steps
    with 8 snapshots of the chorus-only and the combined runs (the
    chorus-only run is both examples'), against FP2D_PINS; the same in
    float32 reported; gamma_oblique with harmonics -3..3 on the card
    against the CPU. Returns {dtype: (launches, max abs err, timing)} for
    the kernels' record."""
    import torch

    from raytrace_tpu_torch import fokker_planck_2d as fp2
    from raytrace_tpu_torch import growth
    from raytrace_tpu_torch.fp2d_examples import (
        CHORUS, fp2d_chain, fp2d_for, fp2d_grid, fp2d_tensors)
    from raytrace_tpu_torch.ops import cn_pcg_2d as cg

    conf = CHORUS
    t0 = time.perf_counter()
    cg.build()
    print(f"  cn_pcg_2d built and loaded in {time.perf_counter() - t0:.1f} s"
          f" (nvcc {cg.BUILD_SECONDS:.1f} s)")
    for line in cg.BUILD_LOG.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("   ", line.strip())
    k64 = fp2d_for(dev, torch.float64)
    grid, e_c, f0, chorus, emic = fp2d_grid(k64)
    sync(dev)
    t0 = time.perf_counter()
    t_ch, t_em = fp2d_tensors(k64, grid, e_c, chorus, emic)
    sync(dev)
    print(f"  the tensors on the {conf['n_a']} x {conf['n_p']} grid "
          f"(bounce_averaged, 'mc', chorus and EMIC): "
          f"{time.perf_counter() - t0:.3f} s on {card}", flush=True)

    # (a) the kernel against the plain version, the first snapshot interval
    every = conf["n_steps"] // conf["n_snaps"]
    dt = conf["dt"]
    tol_snap = {torch.float64: 1e-8, torch.float32: 1e-4}
    tol_count = {torch.float64: 1, torch.float32: 3}
    record = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        op = fp2.make_operator_2d(grid, *(torch.as_tensor(t, device=dev)
                                          .to(dtype) for t in t_ch))
        x0 = torch.as_tensor(f0, device=dev).to(dtype)
        tol = fp2.default_cg_tol(dtype)
        fp2.evolve_cn_2d(x0, op, dt, 2)                  # warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        got, snap_k, it_k = cg.cn_pcg_2d(x0, op, dt, every, every, tol, 500)
        end.record()
        sync(dev)
        ms_k = start.elapsed_time(end)
        lay = cg.cn_pcg_2d.last_layout
        # the same 180 steps at a second cluster size: 8 blocks (portable)
        # where the wrapper took 16, else 16
        other = 8 if lay.cluster == 16 else 16
        cg.cn_pcg_2d(x0, op, dt, 2, 0, tol, 500, other)
        start.record()
        _, snap_o, it_o = cg.cn_pcg_2d(x0, op, dt, every, every, tol, 500,
                                       other)
        end.record()
        sync(dev)
        ms_o = start.elapsed_time(end)
        lay_o = cg.cn_pcg_2d.last_layout
        t0 = time.perf_counter()
        ref, snap_p = fp2.evolve_cn_2d_reference(x0, op, dt, every, every)
        sync(dev)
        ms_p = (time.perf_counter() - t0) * 1e3
        it_p = fp2.evolve_cn_2d.cg_iterations.clone()
        t0 = time.perf_counter()
        eager = fp2.evolve_cn_2d_reference(x0, op, dt, 4, graph=False)
        sync(dev)
        ms_e = (time.perf_counter() - t0) * 1e3 / 4
        it_e = fp2.evolve_cn_2d.cg_iterations.clone()
        graph4 = fp2.evolve_cn_2d_reference(x0, op, dt, 4)
        sync(dev)
        same4 = (torch.equal(eager, graph4)
                 and torch.equal(fp2.evolve_cn_2d.cg_iterations, it_e))
        err = float((snap_k - snap_p).abs().max())
        scale = float(snap_p.abs().max())
        dcount = int((it_k.long() - it_p.long()).abs().max())
        n_it = int(it_k.long().sum())
        err_o = float((snap_o - snap_p).abs().max())
        dcount_o = int((it_o.long() - it_p.long()).abs().max())
        n_it_o = int(it_o.long().sum())
        # the latency floor: the layout's synchronisation skeleton alone,
        # us an iteration, times the launch's iterations
        floor_us = cg.floor_us(dtype, lay.cluster, lay.threads)
        floor_o = cg.floor_us(dtype, lay_o.cluster, lay_o.threads)
        setup_ops, iter_ops = cg_ops(op, 0.5 * dt)
        # the plain version takes the stop test (r.r) at both ends of an
        # iteration; the kernel once
        iter_ops -= 2 * conf["n_a"] * conf["n_p"]
        ops = setup_ops * every + iter_ops * n_it
        n = conf["n_a"] * conf["n_p"]
        itemsize = 8 if dtype == torch.float64 else 4
        # each input once (the kernel's five cell arrays ka, kp, r_x,
        # mass, m_inv, its three p-axis arrays, f0), each output once (the
        # state, the snapshot, the counts)
        nbytes = (8 * n + 3 * conf["n_p"]) * itemsize + 4 * every
        ops_ms = ops / PEAK_OPS[name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        print(f"  (a) {name}: kernel {ms_k:.3f} ms for {every} CN steps "
              f"({ms_k / every:.4f} ms a step, {n_it / every:.1f} CG "
              f"iterations a step, {ms_k / n_it * 1e3:.3f} us an "
              f"iteration); plain through GraphLoop {ms_p:.1f} ms "
              f"({ms_p / every:.3f} ms a step, the captures included), "
              f"eager {ms_e:.3f} ms a step (4 steps); bound "
              f"{max(ops_ms, bytes_ms):.4f} ms ({ops / n_it:.0f} operations "
              f"an iteration incl. set-ups, {nbytes} bytes), on {card}",
              flush=True)
        print(f"      snapshot: kernel against plain {err / scale:.2e} of "
              f"its max; CG counts per step {int(it_k.min())}-"
              f"{int(it_k.max())}, kernel against plain within {dcount} "
              f"({int((it_k != it_p).sum())} of {every} steps differ)")
        print(f"      layout: a cluster of {lay.cluster} blocks of "
              f"{lay.threads} threads (instance {lay.variant}: "
              f"{cg.VARIANTS[lay.variant]} cells a thread in registers), "
              f"{lay.smem} bytes of shared memory a block; latency floor "
              f"{floor_us:.3f} us an iteration, {floor_us * n_it / 1e3:.3f} "
              f"ms for the launch's {n_it} iterations")
        print(f"      a cluster of {lay_o.cluster} x {lay_o.threads}: "
              f"{ms_o:.3f} ms ({ms_o / n_it_o * 1e3:.3f} us an iteration, "
              f"floor {floor_o:.3f}); snapshot against plain "
              f"{err_o / scale:.2e}, CG counts within {dcount_o}")
        check(err <= tol_snap[dtype] * scale and dcount <= tol_count[dtype],
              f"{name}: the kernel's snapshot within {tol_snap[dtype]:g} of "
              f"the plain version's max and its CG counts within "
              f"{tol_count[dtype]}")
        check(err_o <= tol_snap[dtype] * scale
              and dcount_o <= tol_count[dtype],
              f"{name}: at a cluster of {lay_o.cluster} too")
        check(same4, f"{name}: the plain version through the CUDA graph "
                     "equals the eager loop bit for bit (4 steps)")
        record[name] = dict(err=err, timing=dict(
            ms=ms_k, plain_ms=ms_p, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            cluster=lay.cluster, threads=lay.threads,
            latency_floor_ms=floor_us * n_it / 1e3,
            latency_floor_us_per_iteration=floor_us,
            second_cluster=dict(cluster=lay_o.cluster, threads=lay_o.threads,
                                ms=ms_o, us_per_iteration=ms_o / n_it_o * 1e3,
                                max_abs_err=err_o),
            ms_per_cn_step=ms_k / every,
            cg_iterations_per_step=n_it / every,
            us_per_iteration=ms_k / n_it * 1e3,
            plain_graph_ms_per_step=ms_p / every,
            plain_eager_ms_per_step=ms_e, steps=every))

    # (b) the examples as they run, through the kernel
    pins = FP2D_PINS
    out = {}
    launches = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        k = fp2d_for(dev, dtype)
        cg.cn_pcg_2d.launches = 0
        out[name] = fp2d_chain(k, grid, e_c, f0, t_ch, t_em)
        launches[name] = cg.cn_pcg_2d.launches
        check(launches[name] == 2, f"{name}: the two evolutions took two "
                                   f"kernel launches ({launches[name]}, on "
                                   f"{cg.cn_pcg_2d.last_layout})")
    o64, o32 = out["float64"], out["float32"]
    print(f"  (b) chorus_acceleration: {conf['n_steps']:,} CN steps of "
          f"{dt:g} s, float64 {o64['walls']['chorus']:.3f} s, float32 "
          f"{o32['walls']['chorus']:.3f} s; belt_competition's combined "
          f"run {o64['walls']['sum']:.3f} / {o32['walls']['sum']:.3f} s "
          f"(its chorus-only run is the one above), on {card}", flush=True)
    for run in ("chorus", "sum"):
        g64, g32 = o64[run]["gain"], o32[run]["gain"]
        print(f"      {run}: PSD gain at 80 deg, 1 MeV {g64[0]:.6g}x "
              f"(float32 {g32[0]:.6g}x), 3 MeV {g64[1]:.6g}x (float32 "
              f"{g32[1]:.6g}x); trapped > 1 MeV at the end "
              f"{o64[run]['trapped'][-1]:.6e} (float32 "
              f"{o32[run]['trapped'][-1]:.6e})")
    ratio = o64["chorus"]["trapped"][-1] / o64["sum"]["trapped"][-1]
    print(f"      the EMIC loss channel cuts the trapped > 1 MeV content "
          f"{ratio:.3f}x")
    errs = {}
    for run in ("chorus", "sum"):
        o, p = o64[run], pins[run]
        rows = o["rows80"] if run == "chorus" else o["rows80"][-1:]
        errs[run + " gain"] = worst_rel(o["gain"], p["gain"])
        errs[run + " content"] = worst_rel(o["content"], p["content"])
        errs[run + " trapped"] = worst_rel(o["trapped"], p["trapped"])
        # the rows and profiles to their largest value: the tail's smallest
        # entries carry the CG's rounding relative to the row
        for key, got, want in (("rows80", rows, np.array(p["rows80"])),
                               ("prof3", o["prof3"], np.array(p["prof3"]))):
            errs[f"{run} {key}"] = float(
                (np.abs(got - want).max(axis=-1)
                 / np.abs(want).max(axis=-1)).max())
    check(max(errs.values()) <= FP2D_RTOL,
          f"both examples within {FP2D_RTOL:g} of the JAX package's float64 "
          f"numbers (" + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + ")")
    f32err = max(worst_rel(o32[r]["gain"], o64[r]["gain"])
                 for r in ("chorus", "sum"))
    print(f"      float32 gains against float64: {f32err:.2e}")
    check(f32err <= 1e-2, "float32 gains within 1e-2 of float64")

    # gamma_oblique at any harmonic, card against CPU (an L = 4 equator,
    # tests/test_growth.py's)
    from raytrace_tpu_torch.constants import FCE_E

    f = np.array([0.1, 0.22, 0.35]) * FCE_E * 3.12e-5 / 64.0
    psi = np.radians([10.0, 35.0, 60.0])
    hot = growth.HotElectrons(eta=1.0e-3, t_par_ev=50.0e3, anisotropy=1.0)
    args = (f[:, None], 3.12e-5 / 64.0, 1.0e9, hot, psi[None, :])
    got = growth.gamma_oblique(*args, harmonics=range(-3, 4), device=dev)
    want = growth.gamma_oblique(*args, harmonics=range(-3, 4), device="cpu")
    e = worst_rel(got.cpu().numpy(), want.numpy())
    check(e <= 1e-10, f"gamma_oblique with harmonics -3..3 on the card "
                      f"within 1e-10 of the CPU ({e:.2e})")
    return {name: (launches[name], record[name]["err"],
                   record[name]["timing"]) for name in record}



# ---- phases 31-33: processes, the rounds tracer's knobs, the plots ------

def rounds_kw(conf):
    """The rounds tracer's keywords for a preset, as run() and the
    --multihost path build them (the statistics need no carry)."""
    kw = dict(frame=conf.frame, cfg=conf.solver(), spec=conf.stop(),
              adaptive=conf.adaptive, stepper=conf.stepper,
              base_stepper=conf.base_stepper, max_steps=conf.max_steps,
              grad_mode=conf.grad_mode, root=conf.root, want_carry=False)
    if conf.round_steps:
        kw["round_steps"] = tuple(conf.round_steps)
    return kw


def launch_of(conf, dev):
    """(env, u0, f, valid) of a preset's launch, as run() builds it."""
    import torch

    from raytrace_tpu_torch.parallel.ensemble import pad_batch
    from raytrace_tpu_torch.run import _build_u0

    env = conf.medium.build()
    np_dt = np.float32 if conf.dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device(dev))
    return (env, *pad_batch(u0, f))


def mp_modes(conf):
    """Phase 31's two schedules: "default", the --multihost path as a user
    runs it (the preset's round schedule), and "one-round", the whole
    budget in one round (the schedule run() gives a batch of at most 64
    rays), where no round boundary depends on the batch."""
    return {"default": {}, "one-round": {"round_steps": (conf.max_steps,)}}


def rank_worker(port, nproc, rank):
    """One process of phase 31 (chip_smoke.py --rank-worker PORT N RANK):
    opens the gloo group, loads the step kernel the parent built (it
    never builds: a missing library is a failure), traces its slice of
    ensemble10k in float32 on cuda:0 through trace_ensemble_multihost in
    each MP_MODES mode, and prints per mode its slice, launches, wall,
    LOCAL stats row and GLOBAL stats as JSON lines."""
    import os

    import torch

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.parallel import distributed as dist
    from raytrace_tpu_torch.parallel.ensemble import ensemble_stats

    if not torch.cuda.is_available():
        print("rank worker: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.exists(sc.library_path()):
        print("rank worker: the step kernel is not built", file=sys.stderr)
        return 3
    sc.build()
    nproc, rank = int(nproc), int(rank)
    dist.ensure_initialized(f"localhost:{port}", nproc, rank)
    conf = preset("ensemble10k")
    env, u0, f, _ = launch_of(conf, "cuda:0")
    dist.trace_ensemble_multihost(env, u0, f, tracer_kw=rounds_kw(conf),
                                  device="cuda:0")        # warm-up
    for mode, over in mp_modes(conf).items():
        sc.step_chunk.launches = 0
        sc.step_chunk_reference.calls = 0
        t0 = time.perf_counter()
        res, v_l, glob = dist.trace_ensemble_multihost(
            env, u0, f, tracer_kw={**rounds_kw(conf), **over},
            device="cuda:0")
        wall = time.perf_counter() - t0
        local = ensemble_stats(res._replace(u=res.u.astype(np.float64)),
                               v_l)
        print("RANK " + json.dumps(dict(
            mode=mode, rank=rank, slice=dist.process_slice(u0.shape[0]),
            launches=sc.step_chunk.launches,
            plain_calls=sc.step_chunk_reference.calls, wall=wall,
            local={k: float(v) for k, v in local.items()}, glob=glob)),
            flush=True)
    torch.distributed.destroy_process_group()
    return 0


def multiprocess_phase(card):
    """Phase 31: two processes with a gloo group trace the halves of
    ensemble10k (float32) on the one card through
    trace_ensemble_multihost, against the single-process run of the same
    path: the slices cover the grid, both ranks print the same GLOBAL,
    which is combine_stat_rows of their LOCAL rows; every summed key
    equals the single-process run's exactly (each ray is one lane; in the
    one-round mode no round boundary depends on the batch, in the default
    mode each half's straggler tail merges at the round the whole batch's
    does), the means to 1e-12, and each median lies between the ranks'
    medians."""
    import os
    import socket

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.parallel import distributed as dist

    conf = preset("ensemble10k")
    env, u0, f, valid = launch_of(conf, "cuda")
    check(bool(valid.all()), "ensemble10k needs no pad rays")
    single = {}
    for mode, over in mp_modes(conf).items():
        dist.trace_ensemble_multihost(          # warm-up
            env, u0, f, tracer_kw={**rounds_kw(conf), **over}, device="cuda")
        sc.step_chunk.launches = 0
        t0 = time.perf_counter()
        _, _, single[mode] = dist.trace_ensemble_multihost(
            env, u0, f, tracer_kw={**rounds_kw(conf), **over}, device="cuda")
        wall = time.perf_counter() - t0
        print(f"  one process, {mode}: wall {wall:.4f} s, "
              f"{sc.step_chunk.launches} launches on {card}", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env_w = dict(os.environ, PYTHONPATH=here + os.pathsep
                 + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker",
         str(port), "2", str(r)], cwd=here, env=env_w,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                check(False, "a rank worker finished within 120 s")
            outs.append(out)
            if p.returncode != 0:
                print(out[-4000:], err[-4000:], sep="\n")
            check(p.returncode == 0, "the rank worker exited with 0")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"  two processes started, traced and gathered in "
          f"{time.perf_counter() - t0:.1f} s (start-up included)")
    # raw_decode: gloo's own lines may share a line with a record
    dec = json.JSONDecoder()
    recs = {}
    for out in outs:
        for line in out.splitlines():
            if "RANK {" in line:
                r = dec.raw_decode(line[line.index("RANK {") + 5:])[0]
                recs[r["mode"], r["rank"]] = r
    for mode in mp_modes(conf):
        r0, r1 = recs[mode, 0], recs[mode, 1]
        one = single[mode]
        print(f"  {mode}: rank 0 rays [{r0['slice'][0]}, {r0['slice'][1]}) "
              f"wall {r0['wall']:.4f} s, {r0['launches']} launches; rank 1 "
              f"[{r1['slice'][0]}, {r1['slice'][1]}) wall {r1['wall']:.4f} s, "
              f"{r1['launches']} launches (both on cuda:0 of {card})")
        check(r0["slice"] == [0, u0.shape[0] // 2]
              and r1["slice"] == [u0.shape[0] // 2, u0.shape[0]],
              f"{mode}: the two slices are the global grid")
        check(min(r0["launches"], r1["launches"]) > 0
              and r0["plain_calls"] == r1["plain_calls"] == 0,
              f"{mode}: each rank stepped through the kernel, never the "
              "plain version")
        check(r0["glob"] == r1["glob"], f"{mode}: both ranks print the same "
                                        "GLOBAL")
        check(r0["glob"] == dist.combine_stat_rows([r0["local"],
                                                    r1["local"]]),
              f"{mode}: GLOBAL is combine_stat_rows of the ranks' LOCAL rows")
        glob = r0["glob"]
        summed = [k for k in glob if not k.startswith(("mean_", "median_"))]
        differ = {k: (glob[k], float(one[k])) for k in summed
                  if glob[k] != float(one[k])}
        print(f"  {mode}: GLOBAL HIT_EARTH {glob['n_hit_earth']:.0f} / "
              f"MAX_PHASE_TIME {glob['n_max_phase_time']:.0f} / DT_UNDERFLOW "
              f"{glob['n_dt_underflow']:.0f} / MAX_STEPS "
              f"{glob['n_max_steps']:.0f}, {glob['total_accepted_steps']:.0f}"
              f" + {glob['total_rejected_steps']:.0f} steps; summed keys "
              f"that differ from one process: {differ or 'none'}")
        means = max(abs(glob[k] - float(one[k])) / abs(float(one[k]))
                    for k in glob if k.startswith("mean_"))
        print(f"  {mode}: mean_* against one process: worst relative "
              f"difference {means:.3e}; median landing L {glob['median_landing_l']:.9f}"
              f" (ranks {r0['local']['median_landing_l']:.9f}, "
              f"{r1['local']['median_landing_l']:.9f}; one process "
              f"{float(one['median_landing_l']):.9f})", flush=True)
        for k in glob:
            if k.startswith("median_"):
                lo, hi = sorted((r0["local"][k], r1["local"][k]))
                check(lo <= glob[k] <= hi,
                      f"{mode}: {k} lies between the ranks' medians")
        check(not differ, f"{mode}: every summed key equals the "
                          "single-process run's exactly")
        check(means <= 1e-12, f"{mode}: the means equal the single-process "
                              "run's to 1e-12")


def knob_run(conf, dev, **knobs):
    """One run of a preset's launch through make_rounds_tracer with
    run()'s keywords and `knobs`, the launch counts set to 0 just before:
    (result, tracer, wall, launches)."""
    import torch

    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.parallel.ensemble import make_rounds_tracer

    env, u0, f, valid = launch_of(conf, dev)
    dtype = torch.float32 if conf.dtype == "float32" else torch.float64
    tracer = make_rounds_tracer(env, device=dev, dtype=dtype,
                                **{**rounds_kw(conf), **knobs})
    sc.step_chunk.launches = 0
    sc.step_chunk_reference.calls = 0
    t0 = time.perf_counter()
    res = tracer(u0, f, valid)
    wall = time.perf_counter() - t0
    check(sc.step_chunk.launches > 0 and sc.step_chunk_reference.calls == 0,
          f"{knobs or 'default'}: stepped through the kernel "
          f"({sc.step_chunk.launches} launches), never the plain version")
    return res, tracer, wall, sc.step_chunk.launches


def knobs_phase(dev, card, out32, out64):
    """Phase 32: ensemble10k float32 at pipeline 2 and 3 against pipeline
    1, bit for bit, with the walls; ensemble10k float64 under
    tail_stepper="dopri5" and under order_switch_dt=0.12 against the JAX
    package's censuses on a CPU under the same knob (KNOB_PINS), with
    MAX_STEPS beside the default run's (phase 4); and float32 under
    tail_stepper="dopri5", whose tail merges."""
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.parallel.ensemble import ensemble_stats

    conf = preset("ensemble10k")
    knob_run(conf, dev)                             # warm-up
    runs, walls = {}, {1: [], 2: [], 3: []}
    for p in (1, 2, 3, 3, 2, 1):                    # turns, within one call
        runs[p] = knob_run(conf, dev, pipeline=p)
        walls[p].append(runs[p][2])
    for p in (1, 2, 3):
        res, tracer, wall, launches = runs[p]
        parts = [r["active"] for r in tracer.last_rounds[1:]]
        print(f"  float32 pipeline={p}: walls {walls[p][0]:.4f} and "
              f"{walls[p][1]:.4f} s, {launches} launches (rays a launch "
              f"after round 0: {parts}) on {card}")
    one = runs[1][0]
    for p in (2, 3):
        res = runs[p][0]
        same = all(np.array_equal(getattr(res, k), getattr(one, k))
                   for k in ("u", "t", "status", "n_accept", "n_reject"))
        check(same, f"pipeline={p}: every ray's u, t, status and counters "
                    "equal pipeline=1's bit for bit")
    census = {"default": out64["stats"]}
    for name, knob in (("tail_stepper", {"tail_stepper": "dopri5"}),
                       ("order_switch_dt", {"order_switch_dt": 0.12})):
        c64 = preset("ensemble10k", dtype="float64")
        res, tracer, wall, launches = knob_run(c64, dev, **knob)
        valid = np.ones(res.status.shape[0], bool)
        st = ensemble_stats(res, valid)
        census[name] = st
        pin = KNOB_PINS[name]
        steps = int(st["total_accepted_steps"] + st["total_rejected_steps"])
        used = sorted({r["stepper"] for r in tracer.last_rounds})
        print(f"  float64 {knob}: wall {wall:.4f} s, {launches} launches "
              f"(steppers {used}), HIT_EARTH {int(st['n_hit_earth'])} / MPT "
              f"{int(st['n_max_phase_time'])} / DTU "
              f"{int(st['n_dt_underflow'])} / MAX_STEPS "
              f"{int(st['n_max_steps'])}, {steps} steps, median landing L "
              f"{float(st['median_landing_l']):.12f} on {card}; JAX on a "
              f"CPU {pin['hit']} / {pin['mpt']} / {pin['dtu']} / "
              f"{pin['ms']}, {pin['steps']}, {pin['median_l']:.12f}",
              flush=True)
        # the census outside the rays the JAX package's own one-ulp nudge
        # moves (none for tail_stepper): the card's against JAX's
        nudge = pin.get("nudge_rays", {})
        idx = np.asarray(sorted(nudge), int)
        keys = (("hit", "HIT_EARTH"), ("mpt", "MAX_PHASE_TIME"),
                ("dtu", "DT_UNDERFLOW"), ("ms", "MAX_STEPS"))
        code = {k: events.STATUS_NAMES.index(v) for k, v in keys}
        outside = {k: int((res.status == code[k]).sum())
                   - int((res.status[idx] == code[k]).sum())
                   for k, _ in keys}
        outside_jax = {k: pin[k] - sum(v == name for v in nudge.values())
                       for k, name in keys}
        if nudge:
            print("  the JAX package's one-ulp-nudge rays on the card: "
                  + ", ".join(f"{i} {events.STATUS_NAMES[int(res.status[i])]}"
                              f" (JAX {nudge[i]})" for i in idx))
        check(outside == outside_jax,
              f"{name}: the census equals the JAX package's outside its "
              f"{len(idx)} one-ulp-nudge rays: {outside}")
        check(abs(steps - pin["steps"]) <= 0.01 * pin["steps"],
              f"{name}: attempted steps within 1% of the JAX package's")
        check(abs(float(st["median_landing_l"]) - pin["median_l"])
              <= 1e-9 * pin["median_l"],
              f"{name}: median landing L within 1e-9 of the JAX package's")
        if name == "order_switch_dt":
            check(bool(tracer.last_slow.any())
                  and "dopri5" in used, "rays took the dopri5 pool")
        else:
            check(used == ["bs3"], "no merged tail in float64: every launch "
                                   "ran the bs3 base, as in the JAX package")
    print("  MAX_STEPS, float64: " + ", ".join(
        f"{k} {int(v['n_max_steps'])}" for k, v in census.items())
        + f" on {card}")
    # float32 merges its tail: the tail stepper at work (the platforms'
    # float32 censuses differ by their rounding, so this one is reported)
    res, tracer, wall, launches = knob_run(conf, dev, tail_stepper="dopri5")
    tail = [r for r in tracer.last_rounds if r["stepper"] == "dopri5"]
    st = ensemble_stats(res, np.ones(res.status.shape[0], bool))
    print(f"  float32 tail_stepper='dopri5': wall {wall:.4f} s, {launches} "
          f"launches, the merged tail {tail[0]['active'] if tail else 0} "
          f"rays x {tail[0]['steps'] if tail else 0} attempts on dopri5; "
          f"HIT_EARTH {int(st['n_hit_earth'])}, MAX_STEPS "
          f"{int(st['n_max_steps'])} (default run, phase 4: "
          f"{int(out32['stats']['n_max_steps'])}) on {card}", flush=True)
    check(len(tail) == 1, "float32: the merged tail ran dopri5")


def plots_phase(card):
    """Phase 33: the plots' data on the card in float64 (the refractive
    surface at n_psi = 6,284, the environment maps at n = 400, the
    density profile) against the same helpers on the CPU to 1e-12; then,
    without matplotlib, --plots raises the named ImportError, and with it
    the five plots render."""
    import importlib.util
    import os
    import tempfile

    from raytrace_tpu_torch import viz
    from raytrace_tpu_torch.config import preset

    env = preset("ensemble10k").medium.build()
    helpers = (
        ("refractive surface", viz.refractive_surface_data,
         (2.0, 0.24, 5000.0, env), dict(n_psi=6284)),
        ("environment maps", viz.environment_data, (env,), dict(n=400)),
        ("density profile", viz.density_profile_data, (env,), {}),
    )
    for what, fn, args, kw in helpers:
        t0 = time.perf_counter()
        got = fn(*args, device="cuda", **kw)
        t_card = time.perf_counter() - t0
        ref = fn(*args, device="cpu", **kw)
        worst = 0.0
        for k, v in ref.items():
            a = np.asarray(got[k])
            check(np.array_equal(np.isnan(a), np.isnan(v)),
                  f"{what} {k}: NaN where the CPU's is")
            m = ~np.isnan(v) & np.isfinite(v)
            if m.any():
                worst = max(worst, float(np.max(
                    np.abs(a[m] - v[m]) / np.maximum(np.abs(v[m]), 1e-300))))
        print(f"  {what}: {sum(np.asarray(v).size for v in got.values()):,}"
              f" values, {t_card * 1e3:.1f} ms on the card, worst relative "
              f"difference from the CPU {worst:.3e}", flush=True)
        check(worst <= 1e-12, f"{what}: the card's data equal the CPU's to "
                              "1e-12")
    if importlib.util.find_spec("matplotlib") is None:
        from raytrace_tpu_torch.__main__ import main as cli

        try:
            cli(["ensemble10k", "--plots"])
            raised = ""
        except ImportError as e:
            raised = str(e)
        print(f"  no matplotlib here: --plots raised ImportError({raised!r})")
        check("matplotlib" in raised and "--plots" in raised,
              "--plots raises an ImportError naming matplotlib and --plots")
        return
    u = np.linspace(0.0, 1.0, 40)[:, None, None] * np.ones((1, 3, 4))
    u[..., 0] += 1.0
    with tempfile.TemporaryDirectory() as out:
        viz.plot_ray_paths(u, path=os.path.join(out, "rays.png"))
        viz.plot_refractive_surface(2.0, 0.24, 5000.0, env,
                                    path=os.path.join(out, "surface.png"))
        viz.plot_environment(env, path=os.path.join(out, "envmap.png"))
        viz.plot_density_profile(env, path=os.path.join(out, "profile.png"))
        viz.plot_diagnostics(np.arange(40.0), np.ones((40, 4)),
                             path=os.path.join(out, "diag.png"))
        sizes = [os.path.getsize(os.path.join(out, p)) for p in
                 ("rays.png", "surface.png", "envmap.png", "profile.png",
                  "diag.png")]
    print(f"  the five plots rendered: {sizes} bytes")
    check(min(sizes) > 5000, "each plot is a PNG of more than 5,000 bytes")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.constants import RE
    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import (
        RayCarry, SolverConfig, trace,
    )
    from raytrace_tpu_torch.models.medium import make_env_lat
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.run import _build_u0

    dev = torch.device("cuda")

    # ---- 1. card and build ------------------------------------------------
    phase("[1] card and build", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi)"
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # the two kernels' nvcc processes start together: the CN/CG kernel of
    # phase 30 builds in a thread beside the step kernel's eight parts
    from concurrent.futures import ThreadPoolExecutor

    from raytrace_tpu_torch.ops import cn_pcg_2d

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cg_build = pool.submit(cn_pcg_2d.build)
        sc.build()
        cg_build.result()
    print(f"  step kernel built and loaded in {time.perf_counter() - t0:.1f} s"
          f" (nvcc {sc.BUILD_SECONDS:.1f} s; the CN/CG kernel's beside it "
          f"{cn_pcg_2d.BUILD_SECONDS:.1f} s)")
    print("  nvcc wall of each part (seconds from the build's start): "
          + ", ".join(f"{k} {t:.1f}"
                      for k, t in enumerate(sc.BUILD_PART_SECONDS)))
    for line in sc.BUILD_LOG.splitlines():
        if any(w in line for w in ("Compiling entry", "Function properties",
                                   "registers", "spill")):
            print("   ", line.strip())
    for inst, use in sc.ptxas_usage(sc.BUILD_LOG).items():
        print(f"    {inst}: {use}")
    # the SASS census of the redesigned instances' attempt loops (their
    # sizes, read from phase 4 on) runs in a thread beside phases 2-4
    from raytrace_tpu_torch import sass_census

    census_pool = ThreadPoolExecutor(1)
    census_job = census_pool.submit(
        sass_census.run_census, sc.library_path(),
        {"float bs3 2d_lat axi", "float bs3 2d_colat axi",
         "float bs3 3d full tilted", "float bs3 3d full igrf",
         "float bs3 2d_lat ad", "float bs3 3d ad tilted",
         "double bs3 2d_lat ad", "double bs3 3d ad"},
        sass_census.entry_names(sc.BUILD_LOG))

    # ---- 2. kernel vs plain PyTorch on the card ---------------------------
    phase("[2] step kernel vs plain PyTorch", flush=True)
    carry, f, env, cfg, spec, kw = start("ensemble10k", "float64", dev,
                                            every=10)
    hold_to_plain(carry, f, env, cfg, spec, kw, "2D")
    carry, f, env, cfg, spec, kw = start("ensemble10k", "float32", dev)
    hold_to_plain_f32(carry, f, env, cfg, spec, kw, "2D")

    # the main path's first launch: all 10,240 rays x 2,048 steps, float32
    # bs3. The kernel rounds as its plain version does (no FMA
    # contraction, quotients by constants as reciprocal products, the
    # error norm summed in component order), so every field must agree
    # bit for bit
    # The plain version runs it as 512 attempts, timed (the plain time of
    # the timing below, at the main path's width), then 1,536 more from
    # that carry: its step loop carries nothing else between attempts, so
    # the two legs give the 2,048-attempt run's values
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3",
                        n_steps=2048, **kw)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper="bs3",
                                  n_steps=512, **kw)
    e1.record()
    ref = sc.step_chunk_reference(ref, f, env, cfg, spec, stepper="bs3",
                                  n_steps=1536, **kw)
    torch.cuda.synchronize()
    plain_2d_ms = e0.elapsed_time(e1)
    got, ref = ({k: getattr(c, k).cpu().numpy() for k in RayCarry._fields}
                for c in (got, ref))
    n_diff = n_differ(got, ref)
    err_2d = max_abs(got, ref)
    print(f"  float32 bs3, 10,240 rays x 2,048 steps (the first round's "
          f"launch): {int((got['status'] != 0).sum())} rays stopped, "
          f"{n_diff} values differ, max abs err {err_2d:.3e}")
    check(n_diff == 0, "main-path launch: kernel and plain version agree bit "
                       "for bit in every field")
    # the redesigned instances at the edges of the tail layout
    chain_layouts("2d_lat", dev, card)
    # a trace's end and start inside the launch (finish, fresh), where the
    # fan's rays land: the whole fan in float32, every 10th ray in float64,
    # and with the equator stop on (HIT_EQUATOR)
    finish_fresh("2D", "ensemble10k", "float32", "bs3", dev, 1984, 64)
    finish_fresh("2D", "ensemble10k", "float64", "bs3", dev, 1248, 64,
                 every=10)
    finish_fresh("2D, equator stop", "ensemble10k", "float64", "dopri5", dev,
                 560, 64, every=10, stop=dict(stop_at_equator=1.0))

    # timing at the main path's width: 10,240 rays x 512 steps, f32, bs3
    t_2d = time_instance("ensemble10k", "float32", "bs3", dev,
                         plain_ms=plain_2d_ms)
    print_timing("float32 bs3", t_2d, card)
    flags_cost("2D", "ensemble10k", dev, card)

    # ---- 3. canonical ray through the kernel, float64 ---------------------
    phase("[3] canonical RayTrace_lat ray, float64, dopri5", flush=True)
    n0 = sc.step_chunk.launches
    u0 = torch.tensor([[(RE + 1.0e6) / RE, np.pi / 4, 0.0, 0.0]],
                      dtype=torch.float64, device=dev)
    res = trace(make_env_lat(), u0,
                torch.tensor([1000.0], dtype=torch.float64, device=dev),
                cfg=SolverConfig(rtol=1e-7, atol=1e-12, dt0=1e-4),
                spec=StopSpec(r_floor=1.0, t_max=5e9 / RE),
                stepper="dopri5", max_steps=40000)
    st = int(res.status[0])
    u = res.u[0].cpu().numpy()
    lat_deg = float(np.degrees(u[1]))
    n_acc = int(res.n_accept[0])
    print(f"  {events.STATUS_NAMES[st]}, r = {u[0]:.15f}, landing lat "
          f"{lat_deg:.4f} deg, T = {u[3]:.5f} s, {n_acc} accepted, "
          f"{int(res.n_reject[0])} rejected")
    check(sc.step_chunk.launches == n0 + 1, "stepped by one kernel launch")
    check(st == events.HIT_EARTH, "HIT_EARTH")
    check(abs(u[0] - 1.0) <= 1e-12, "r = 1 within 1e-12")
    check(abs(lat_deg - 2.747) <= 0.01, "landing lat 2.747 +- 0.01 deg")
    check(abs(u[3] - 3.1251) <= 0.001, "T = 3.1251 +- 0.001 s")
    check(abs(n_acc - 4135) <= 0.02 * 4135, "accepted steps 4135 +- 2%")

    # ---- 4. the ensemble10k slice ----------------------------------------
    phase("[4] ensemble10k through raytrace_tpu_torch.run.run, float32",
          flush=True)
    ens = preset("ensemble10k")
    drive(ens, "warm-up", card)
    out, wall, launches_2d, ref_calls = drive(ens, "float32", card)
    out4, wall4 = out, wall
    stats = out["stats"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    med_l = float(stats["median_landing_l"])
    print("  (the TPU record expects 0 rays on the stiff pool, "
          "perf_r03l.json)")
    check(launches_2d > 0, "the slice stepped through the kernel")
    check(ref_calls == 0, "the plain version was not called")
    body(launches_2d, "ensemble10k float32", team=False)
    finished_on_card(ens, "ensemble10k float32", card)
    tails = {"2d": tail_timing("ensemble10k float32", card)}
    t0 = time.perf_counter()
    census = census_job.result()
    census_pool.shutdown()
    print(f"  SASS census of {len(census)} instance bodies (sass_census), "
          f"waited {time.perf_counter() - t0:.1f} s for it", flush=True)
    floors = {"2d": tail_layouts("ensemble10k float32", ens, card, census)}
    check(abs(n_hit - REC_HIT_EARTH) <= 0.01 * REC_HIT_EARTH,
          f"HIT_EARTH {n_hit} within 1% of the TPU record {REC_HIT_EARTH}")
    check(abs(steps - REC_STEPS) <= 0.05 * REC_STEPS,
          f"attempted steps {steps} within 5% of the TPU record {REC_STEPS}")
    check(abs(med_l - REC_MEDIAN_L) <= REC_MEDIAN_L_RTOL * REC_MEDIAN_L,
          f"median landing L {med_l:.6f} within {REC_MEDIAN_L_RTOL:g} of the "
          f"TPU record {REC_MEDIAN_L}")

    phase("[4] ensemble10k, float64", flush=True)
    out64, _, _, _ = drive(preset("ensemble10k", dtype="float64"), "float64",
                           card)
    st64 = out64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    check(int(st64["n_hit_earth"]) == F64_HIT_EARTH
          and int(st64["n_max_phase_time"]) == F64_MAX_PHASE_TIME,
          f"HIT_EARTH and MAX_PHASE_TIME equal the JAX package's float64 "
          f"{F64_HIT_EARTH} and {F64_MAX_PHASE_TIME}")
    check(abs(steps64 - F64_STEPS) <= 0.01 * F64_STEPS,
          f"attempted steps within 1% of the JAX package's float64 "
          f"{F64_STEPS}")
    check(abs(med64 - F64_MEDIAN_L) <= 1e-9 * F64_MEDIAN_L,
          f"median landing L within 1e-9 of the JAX package's float64 "
          f"{F64_MEDIAN_L}")
    match, med_rel, n_m = landing_agreement(
        out, out64, lambda u: u[:, 0] / np.cos(u[:, 1]) ** 2)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, "
          f"median relative landing-L error {med_rel:.3e} over {n_m} "
          "matched HIT_EARTH rays")
    check(match >= F32_F64_STATUS_MATCH,
          f"statuses match on >= {F32_F64_STATUS_MATCH:.0%} of rays")
    check(med_rel < F32_F64_MEDIAN_DL,
          f"median relative landing-L error < {F32_F64_MEDIAN_DL:g} (the JAX "
          "package's own: 2.18e-4)")

    # ---- 5. the 3D kernel and the arc ceiling vs plain PyTorch -----------
    phase("[5] 3D step kernel (rhs_3d, ds_max) vs plain PyTorch", flush=True)
    carry, f, env, cfg, spec, kw = start("ensemble10k_3d", "float64", dev,
                                            every=10)
    hold_to_plain(carry, f, env, cfg, spec, kw, "3D")
    carry, f, env, cfg, spec, kw = start("ensemble10k_3d", "float32", dev)
    hold_to_plain_f32(carry, f, env, cfg, spec, kw, "3D")

    # the 3D path's first launch: 10,240 rays, float32 bs3 (schedule
    # (512, 1024, 2048)); rsqrt is the card's own in both (the note in
    # csrc/step_chunk.cu), so every field must agree bit for bit
    got, ref, plain_3d_ms = both(carry, f, env, cfg, spec, "bs3", SIDE_N,
                                 kw)
    n_diff = n_differ(got, ref)
    err_3d = max_abs(got, ref)
    print(f"  3D float32 bs3, 10,240 rays x {SIDE_N} steps (the first "
          f"round's launch): {int((got['status'] != 0).sum())} rays stopped, "
          f"{n_diff} values differ, max abs err {err_3d:.3e} (plain version "
          f"{plain_3d_ms:.1f} ms)")
    check(n_diff == 0, "3D first launch: kernel and plain version agree bit "
                       "for bit in every field")
    finish_fresh("3D", "ensemble10k_3d", "float32", "bs3", dev, 192, 64)
    finish_fresh("3D", "ensemble10k_3d", "float64", "bs3", dev, 160, 64,
                 every=10)

    carry, f, env, cfg, spec, kw = start("ensemble10k_production",
                                            "float32", dev)
    got, ref, plain_prod_ms = both(carry, f, env, cfg, spec, "bs3", SIDE_N,
                                   kw)
    n_diff = n_differ(got, ref)
    err_prod = max_abs(got, ref)
    print(f"  2D ds_max float32 bs3, 10,240 rays x {SIDE_N} steps: "
          f"{int((got['status'] != 0).sum())} rays stopped, {n_diff} values "
          f"differ, max abs err {err_prod:.3e}")
    check(n_diff == 0, "ensemble10k_production launch (ds_max on): kernel "
                       "and plain version agree bit for bit in every field")

    # every instance at 10,240 rays x 512 steps beside its plain version
    # (the float32 bs3 launches' plain runs are the two just held bit for
    # bit, SIDE_N attempts: their times are taken from there)
    timings = {}
    plain_f32 = {"ensemble10k_3d": plain_3d_ms,
                 "ensemble10k_production": plain_prod_ms}
    for name, dt_name, stepper in (
        ("ensemble10k_3d", "float32", "bs3"),
        ("ensemble10k_production", "float32", "bs3"),
        ("ensemble10k", "float32", "dopri5"),
        ("ensemble10k_3d", "float32", "dopri5"),
        ("ensemble10k", "float64", "bs3"),
        ("ensemble10k_3d", "float64", "bs3"),
        ("ensemble10k", "float64", "dopri5"),
        ("ensemble10k_3d", "float64", "dopri5"),
    ):
        f32_bs3 = (dt_name, stepper) == ("float32", "bs3")
        t = time_instance(name, dt_name, stepper, dev, plain_full=f32_bs3,
                          plain_ms=plain_f32[name] if f32_bs3 else None,
                          plain_n=SIDE_N)
        timings[name, dt_name, stepper] = t
        print_timing(f"{name} {dt_name} {stepper}", t, card)
    # the axisymmetric medium runs through the whole density chain with
    # every feature flag off; the 3D launch must stay within 10% of the
    # kernel that held the axisymmetric chain alone
    t3 = timings["ensemble10k_3d", "float32", "bs3"]["ms"]
    check(abs(t3 - AXI_3D_MS) <= 0.1 * AXI_3D_MS,
          f"ensemble10k_3d float32 bs3 {t3:.3f} ms within 10% of "
          f"{AXI_3D_MS} ms")
    flags_cost("3D", "ensemble10k_3d", dev, card)

    # ---- 6. the ensemble10k_3d slice -------------------------------------
    phase("[6] ensemble10k_3d through raytrace_tpu_torch.run.run, float32",
          flush=True)
    e3 = preset("ensemble10k_3d")
    drive(e3, "warm-up", card)
    out3, _, launches_3d, ref_calls = drive(e3, "float32", card)
    stats = out3["stats"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    med_l = float(stats["median_landing_l"])
    check(launches_3d > 0, "the 3D slice stepped through the kernel")
    check(ref_calls == 0, "the plain version was not called")
    finished_on_card(e3, "ensemble10k_3d float32", card)
    check(abs(n_hit - REC3_HIT_EARTH) <= REC3_HIT_RTOL * REC3_HIT_EARTH,
          f"HIT_EARTH {n_hit} within {REC3_HIT_RTOL:.0%} of the TPU record "
          f"{REC3_HIT_EARTH}")
    check(abs(steps - REC3_STEPS) <= 0.05 * REC3_STEPS,
          f"attempted steps {steps} within 5% of the TPU record {REC3_STEPS}")
    check(abs(med_l - REC3_MEDIAN_L) <= REC3_MEDIAN_L_ATOL,
          f"median landing L {med_l:.6f} within {REC3_MEDIAN_L_ATOL:g} of the "
          f"TPU record {REC3_MEDIAN_L}")

    phase("[6] ensemble10k_3d, float64", flush=True)
    out3_64, _, launches, ref_calls = drive(
        preset("ensemble10k_3d", dtype="float64"), "float64", card)
    st64 = out3_64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    check(launches > 0 and ref_calls == 0,
          "float64 stepped through the kernel, never the plain version")
    check(int(st64["n_hit_earth"]) == F64_3D_HIT_EARTH
          and int(st64["n_max_phase_time"]) == F64_3D_MAX_PHASE_TIME,
          f"HIT_EARTH and MAX_PHASE_TIME equal the JAX package's float64 "
          f"{F64_3D_HIT_EARTH} and {F64_3D_MAX_PHASE_TIME}")
    check(abs(steps64 - F64_3D_STEPS) <= 0.01 * F64_3D_STEPS,
          f"attempted steps {steps64} within 1% of the JAX package's float64 "
          f"{F64_3D_STEPS}")
    check(abs(med64 - F64_3D_MEDIAN_L) <= 1e-9 * F64_3D_MEDIAN_L,
          f"median landing L within 1e-9 of the JAX package's float64 "
          f"{F64_3D_MEDIAN_L}")
    # the 3D frame carries the colatitude: landing L = r / sin^2(theta)
    match, med_rel, n_m = landing_agreement(
        out3, out3_64, lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, "
          f"median relative landing-L error {med_rel:.3e} over {n_m} "
          "matched HIT_EARTH rays")
    check(match >= F32_F64_3D_STATUS_MATCH,
          f"statuses match on >= {F32_F64_3D_STATUS_MATCH:.2%} of rays (the "
          "JAX package's own: 95.30%)")
    check(med_rel < F32_F64_3D_MEDIAN_DL,
          f"median relative landing-L error < {F32_F64_3D_MEDIAN_DL:g} (the "
          "JAX package's own: 1.55e-6)")

    # ---- 7. the ensemble10k_production slice (2D, ds_max) ----------------
    phase("[7] ensemble10k_production through run.run, float32", flush=True)
    prod = preset("ensemble10k_production")
    drive(prod, "warm-up", card)
    outp, _, launches_prod, ref_calls = drive(prod, "float32", card)
    stats = outp["stats"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    med_l = float(stats["median_landing_l"])
    check(launches_prod > 0, "the slice stepped through the kernel")
    check(ref_calls == 0, "the plain version was not called")
    body(launches_prod, "ensemble10k_production float32", team=False)
    tails["prod"] = tail_timing("ensemble10k_production float32", card)
    check(abs(n_hit - RECP_HIT_EARTH) <= 0.01 * RECP_HIT_EARTH,
          f"HIT_EARTH {n_hit} within 1% of the TPU record {RECP_HIT_EARTH}")
    check(abs(steps - RECP_STEPS) <= 0.05 * RECP_STEPS,
          f"attempted steps {steps} within 5% of the TPU record {RECP_STEPS}")
    check(abs(med_l - RECP_MEDIAN_L) <= REC_MEDIAN_L_RTOL * RECP_MEDIAN_L,
          f"median landing L {med_l:.6f} within {REC_MEDIAN_L_RTOL:g} of the "
          f"TPU record {RECP_MEDIAN_L}")

    # ---- 8. the full-medium kernel vs plain PyTorch ---------------------
    from raytrace_tpu_torch.config import MediumConfig
    from raytrace_tpu_torch.constants import B0_2D, B0_3D

    phase("[8] full density chain (MLT-resolved 3D, GCPM, every 2D gate) "
          "vs plain PyTorch", flush=True)
    # the plume path's first launch: 10,240 rays, float32 bs3
    err_plume, plain_plume_ms = bit_for_bit(
        "plume (the first round's launch)", "ensemble10k_plume", "float32",
        "bs3", dev, SIDE_N)
    for stepper in ("bs3", "dopri5"):
        bit_for_bit("plume", "ensemble10k_plume", "float64", stepper, dev,
                    CUT_N, every=10)
    # the team body's epilogue and prologue: warp 0 posts u_prev (and u)
    # to the helpers as for any stage
    finish_fresh("plume (team body)", "ensemble10k_plume", "float32", "bs3",
                 dev, 192, 64, team=True)
    finish_fresh("plume (team body)", "ensemble10k_plume", "float64",
                 "dopri5", dev, 160, 32, every=10, team=True)
    # mr_fan_3d's launch: 2,048 low-altitude rays near f_LHR
    err_mr, plain_mr_ms = bit_for_bit("mr_fan_3d", "mr_fan_3d", "float32",
                                      "bs3", dev, SIDE_N)
    gcpm = MediumConfig(b0=B0_3D, ps_mlt=True, ps_model="gcpm")
    for dt_name, stepper, every, n in (("float32", "bs3", 1, SIDE_N),
                                       ("float64", "dopri5", 10, CUT_N)):
        bit_for_bit("plume fan over the MLT GCPM", "ensemble10k_plume",
                    dt_name, stepper, dev, n, every=every, medium=gcpm)
    for label, kw in FULL_2D.items():
        med = MediumConfig(b0=B0_2D, **kw)
        for dt_name, stepper in (("float32", "bs3"), ("float64", "dopri5")):
            bit_for_bit(f"2D knee fan over {label}", "knee", dt_name,
                        stepper, dev, SIDE_N, medium=med)
    # the team body's density pieces over every other gate of the chain
    for label, kw in TEAM_MEDIA.items():
        med = MediumConfig(b0=B0_3D, **kw)
        for dt_name, stepper in (("float32", "bs3"), ("float64", "dopri5")):
            bit_for_bit(f"plume fan over {label}", "ensemble10k_plume",
                        dt_name, stepper, dev, CUT_N, every=10, medium=med)

    # the full chain with every feature flag off performs the axisymmetric
    # chain's operations in the same order, so it must agree with the
    # axisymmetric instances bit for bit; it is timed beside them, which
    # is why the axisymmetric medium keeps instances of its own
    for name in ("ensemble10k", "ensemble10k_3d"):
        for dt_name, stepper in (("float32", "bs3"), ("float32", "dopri5"),
                                 ("float64", "bs3"), ("float64", "dopri5")):
            ms, n_diff = full_chain_off(name, dt_name, stepper, dev)
            ratio = sum(ms["full"]) / sum(ms["axi"])
            print(f"  {name} {dt_name} {stepper}, 10,240 rays x 512 steps: "
                  f"axisymmetric instance {ms['axi'][0]:.3f} / "
                  f"{ms['axi'][1]:.3f} ms, full chain with every flag off "
                  f"{ms['full'][0]:.3f} / {ms['full'][1]:.3f} ms "
                  f"({ratio:.3f}x), {n_diff} values differ on {card}",
                  flush=True)
            check(n_diff == 0, f"{name} {dt_name} {stepper}: the full chain "
                               "with its flags off agrees with the "
                               "axisymmetric instance bit for bit")

    # the new paths at 10,240 rays x 512 steps (the plume's float32 bs3
    # launch and mr_fan_3d's beside the plain runs held bit for bit above)
    full_2d = MediumConfig(b0=B0_2D, **FULL_2D["gcpm+iono_mlt+duct"])
    t_full = {}
    for label, name, med, dt_name, stepper in (
        ("plume", "ensemble10k_plume", None, "float32", "bs3"),
        ("plume MLT GCPM", "ensemble10k_plume", gcpm, "float32", "bs3"),
        ("2D full (ensemble10k fan, gcpm+iono_mlt+duct)", "ensemble10k",
         full_2d, "float32", "bs3"),
        ("plume", "ensemble10k_plume", None, "float32", "dopri5"),
        ("plume", "ensemble10k_plume", None, "float64", "bs3"),
        ("plume", "ensemble10k_plume", None, "float64", "dopri5"),
        ("2D full (ensemble10k fan, gcpm+iono_mlt+duct)", "ensemble10k",
         full_2d, "float32", "dopri5"),
        ("2D full (ensemble10k fan, gcpm+iono_mlt+duct)", "ensemble10k",
         full_2d, "float64", "bs3"),
        ("2D full (ensemble10k fan, gcpm+iono_mlt+duct)", "ensemble10k",
         full_2d, "float64", "dopri5"),
    ):
        first = (label, dt_name, stepper) == ("plume", "float32", "bs3")
        t = time_instance(name, dt_name, stepper, dev, medium=med,
                          plain_full=first,
                          plain_ms=plain_plume_ms if first else None,
                          plain_n=SIDE_N)
        t_full[label, dt_name, stepper] = t
        print_timing(f"{label} {dt_name} {stepper}", t, card)
    # mr_fan_3d's launch width: its 2,048 rays x 512 attempts
    t_mr = time_instance("mr_fan_3d", "float32", "bs3", dev,
                         plain_ms=plain_mr_ms, plain_n=SIDE_N)
    print_timing("mr_fan_3d float32 bs3", t_mr, card)

    # ---- 9. the ensemble10k_plume slice ----------------------------------
    phase("[9] ensemble10k_plume through raytrace_tpu_torch.run.run, float32",
          flush=True)
    plume = preset("ensemble10k_plume")
    drive(plume, "warm-up", card)
    outm, _, launches_plume, ref_calls = drive(plume, "float32", card)
    stats = outm["stats"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    check(launches_plume > 0, "the plume slice stepped through the kernel")
    check(ref_calls == 0, "the plain version was not called")
    body(launches_plume, "ensemble10k_plume float32", team=True)
    tails["plume"] = tail_timing("ensemble10k_plume float32", card)
    check(abs(n_hit - RECM_HIT_EARTH) <= RECM_HIT_RTOL * RECM_HIT_EARTH,
          f"HIT_EARTH {n_hit} within {RECM_HIT_RTOL:.0%} of the TPU record "
          f"{RECM_HIT_EARTH}")
    check(abs(steps - RECM_STEPS) <= 0.05 * RECM_STEPS,
          f"attempted steps {steps} within 5% of the TPU record {RECM_STEPS}")
    # the fan drifted in longitude: d mu/d phi steered it
    u_m = outm["result"].u[outm["valid"]]
    u0_m, _ = _build_u0(plume, plume.medium.build(), np.float32, dev)
    drift = float(np.abs(u_m[:, 2] - u0_m[:, 2]).max())
    print(f"  largest longitude drift of a ray: {drift:.3e} rad")

    phase("[9] ensemble10k_plume, float64", flush=True)
    outm64, _, launches, ref_calls = drive(
        preset("ensemble10k_plume", dtype="float64"), "float64", card)
    st64 = outm64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    check(launches > 0 and ref_calls == 0,
          "float64 stepped through the kernel, never the plain version")
    check(int(st64["n_hit_earth"]) == F64_M_HIT_EARTH
          and int(st64["n_max_phase_time"]) == F64_M_MAX_PHASE_TIME,
          f"HIT_EARTH and MAX_PHASE_TIME equal the JAX package's float64 "
          f"{F64_M_HIT_EARTH} and {F64_M_MAX_PHASE_TIME}")
    check(abs(steps64 - F64_M_STEPS) <= 0.01 * F64_M_STEPS,
          f"attempted steps {steps64} within 1% of the JAX package's float64 "
          f"{F64_M_STEPS}")
    check(abs(med64 - F64_M_MEDIAN_L) <= 1e-9 * F64_M_MEDIAN_L,
          f"median landing L within 1e-9 of the JAX package's float64 "
          f"{F64_M_MEDIAN_L}")
    match, med_rel, n_m = landing_agreement(
        outm, outm64, lambda u: u[:, 0] / np.sin(u[:, 1]) ** 2)
    print(f"  float32 vs float64: {match * 100:.2f}% statuses match, "
          f"median relative landing-L error {med_rel:.3e} over {n_m} "
          "matched HIT_EARTH rays")
    check(match >= F32_F64_M_STATUS_MATCH,
          f"statuses match on >= {F32_F64_M_STATUS_MATCH:.2%} of rays (the "
          "JAX package's own: 95.91%)")
    check(med_rel < F32_F64_M_MEDIAN_DL,
          f"median relative landing-L error < {F32_F64_M_MEDIAN_DL:g} (the "
          "JAX package's own: 1.17e-6)")

    # ---- 10. the mr_fan_3d slice -----------------------------------------
    phase("[10] mr_fan_3d through raytrace_tpu_torch.run.run, float32",
          flush=True)
    mr = preset("mr_fan_3d")
    drive(mr, "warm-up", card)
    outr, _, launches_mr, ref_calls = drive(mr, "float32", card)
    stats = outr["stats"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    check(launches_mr > 0, "the mr_fan_3d slice stepped through the kernel")
    check(ref_calls == 0, "the plain version was not called")
    body(launches_mr, "mr_fan_3d float32", team=True)
    tails["mr"] = tail_timing("mr_fan_3d float32", card)
    check(abs(n_hit - CPU_F32_R_HIT_EARTH)
          <= CPU_F32_R_HIT_RTOL * CPU_F32_R_HIT_EARTH,
          f"HIT_EARTH {n_hit} within {CPU_F32_R_HIT_RTOL:.0%} of the JAX "
          f"package's float32 census on a CPU {CPU_F32_R_HIT_EARTH}")
    print(f"  HIT_EARTH {n_hit} is {n_hit / RECR_HIT_EARTH - 1:+.2%} from the "
          f"TPU record {RECR_HIT_EARTH} (the JAX package on a CPU: "
          f"{CPU_F32_R_HIT_EARTH / RECR_HIT_EARTH - 1:+.2%})")
    check(abs(steps - RECR_STEPS) <= 0.05 * RECR_STEPS,
          f"attempted steps {steps} within 5% of the TPU record {RECR_STEPS}")
    phase("[10] mr_fan_3d, float64", flush=True)
    outr64, _, launches, ref_calls = drive(
        preset("mr_fan_3d", dtype="float64"), "float64", card)
    st64 = outr64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    check(launches > 0 and ref_calls == 0,
          "float64 stepped through the kernel, never the plain version")
    status = np.asarray(outr64["result"].status)[outr64["valid"]]
    rest = np.ones(status.size, bool)
    rest[list(F64_R_WEDGE_RAYS)] = False
    n_hit_rest = int((status[rest] == events.HIT_EARTH).sum())
    n_uf_rest = int((status[rest] == events.DT_UNDERFLOW).sum())
    check(n_hit_rest == F64_R_HIT_EARTH_REST
          and n_uf_rest == F64_R_DT_UNDERFLOW_REST,
          f"over the {int(rest.sum())} rays besides {F64_R_WEDGE_RAYS}: "
          f"HIT_EARTH {n_hit_rest} and DT_UNDERFLOW {n_uf_rest} equal the "
          f"JAX package's float64 {F64_R_HIT_EARTH_REST} and "
          f"{F64_R_DT_UNDERFLOW_REST}")
    rays_alone("mr_fan_3d", F64_R_WEDGE_RAYS, outr64)
    check(int(st64["n_max_steps"]) == F64_R_MAX_STEPS,
          f"MAX_STEPS {int(st64['n_max_steps'])} equals the JAX package's "
          f"float64 {F64_R_MAX_STEPS}")
    check(abs(steps64 - F64_R_STEPS) <= 0.01 * F64_R_STEPS,
          f"attempted steps {steps64} within 1% of the JAX package's float64 "
          f"{F64_R_STEPS}")

    # ---- 11. the general-field kernel vs plain PyTorch ------------------
    phase("[11] general-field instances (tilted dipole, IGRF) vs plain "
          "PyTorch", flush=True)
    general = general_field_kernels(dev, card)

    # ---- 12, 13. the non-axial-field slices ------------------------------
    phase("[12] ensemble10k_tilted", flush=True)
    launches_tilted, tails["tilted"], floors["tilted"] = field_slice(
        "ensemble10k_tilted", card, census)
    phase("[13] ensemble10k_igrf", flush=True)
    launches_igrf, tails["igrf"], floors["igrf"] = field_slice(
        "ensemble10k_igrf", card, census)

    # ---- 14-18. the last variants: ds_local, colatitude, multi-ion, rk4 --
    phase("[14] instances of the local arc ceiling, the colatitude frame, "
          "the multi-ion medium and rk4 vs plain PyTorch", flush=True)
    variants = variant_kernels(dev, card)
    phase("[15] ensemble10k_local through raytrace_tpu_torch.run.run, "
          "float32", flush=True)
    launches_local = local_slice(card)
    phase("[16] raymain and the ensemble10k fan in the colatitude frame",
          flush=True)
    launches_colat, tails["colat"], floors["colat"] = colat_slices(
        dev, card, census)
    phase("[17] emic_heband", flush=True)
    launches_emic = emic_slice(card)
    phase("[18] the ensemble10k fan with fixed-step rk4", flush=True)
    launches_rk4, tails["rk4"] = rk4_slice(card)
    phase("[19] the stop branches ESCAPED and EVANESCENT vs plain PyTorch",
          flush=True)
    stop_branches(dev)

    # ---- 20-24. the reference scripts' modes ----------------------------
    phase("[20] the ALT instances (grad_mode=\"reference\", "
          "legacy_freq_state) vs plain PyTorch")
    ref = ref_kernels(dev, card)
    phase("[21] ensemble10k with grad_mode=\"reference\" through run.run")
    launches_ref2d, tails["ref2d"] = ref_slice("ensemble10k", card)
    phase("[22] ensemble10k_3d with grad_mode=\"reference\" through "
          "run.run")
    launches_ref3d, tails["ref3d"] = ref_slice("ensemble10k_3d", card)
    phase("[23] the golden rays, float64, reference + legacy")
    launches_gold, err_gold, t_gold = golden_rays(dev, card)
    phase("[24] mr_fan_3d float64 with continue_until_done")
    launches_cont, tails["cont"], cont = mr_continuation(dev, card)

    # ---- 25. the trajectory channel -------------------------------------
    phase("[25] the trajectory channel: trace(save_every) through the "
          "kernel vs plain PyTorch, ensemble10k with save_every=32")
    err_traj, _ = trajectory_kernel("ensemble10k (2D lat, one-thread)",
                                    "ensemble10k", dev, every=10, n_outer=16,
                                    team=False)
    trajectory_kernel("ensemble10k_plume (3D full, team)",
                      "ensemble10k_plume", dev, every=10, n_outer=8,
                      team=True)
    launches_traj, traj25, f25, env25 = trajectory_slice(
        dev, card, out4, wall4, launches_2d)
    t_blk = time_instance("ensemble10k", "float32", "bs3", dev, n=32,
                          reps=20)
    print_timing("float32 bs3, one trajectory block", t_blk, card)

    # ---- 26-28. the modes over the full and extended media, sensitivity --
    phase("[26] the ALTX instances (the modes over the full and extended "
          "media) vs plain PyTorch")
    altx = altx_kernels(dev, card)
    phase("[27] the modes over the full and extended media through run.run:"
          " ensemble10k_plume and ensemble10k_local with grad_mode="
          "\"reference\", emic_heband with legacy_freq_state")
    launches_altx, tails_altx = {}, {}
    for k, name in (("plume", "ensemble10k_plume"),
                    ("local", "ensemble10k_local"), ("emic", "emic_heband")):
        launches_altx[k], tails_altx[k] = altx_slice(name, card)
    phase("[28] landing sensitivity: the canonical ray and run("
          "sensitivity_rays=4)")
    sensitivity_phase(dev, card)

    # ---- 29. the wave-particle chain -------------------------------------
    phase("[29] the wave-particle chain: growth along rays, quasi-linear "
          "diffusion, pitch-angle Fokker-Planck, radial transport")
    print("  (a) examples/lightning_to_lifetimes.py", flush=True)
    launches_fan, err_fan, t_fan = lightning_stage(dev, card)
    print("  (b) growth along the ensemble10k trajectory of phase 25",
          flush=True)
    trajectory_gain_stage(dev, card, traj25, f25, env25)
    del traj25
    print("  (c) the diffusion map of examples/diffusion_map.py", flush=True)
    diffusion_map_stage(dev, card)
    print("  (d) examples/two_belt_structure.py", flush=True)
    two_belt_stage(dev, card)

    # ---- 30. the 2D Fokker-Planck solver ----------------------------------
    phase("[30] the 2D pitch-angle x momentum Fokker-Planck solver: the "
          "CN/CG kernel against its plain version, chorus_acceleration and "
          "belt_competition")
    fp2d = fp2d_stage(dev, card)

    # ---- 31-33. processes, the rounds tracer's knobs, the plots ----------
    phase("[31] two processes on the card: ensemble10k float32 through "
          "trace_ensemble_multihost over a gloo group")
    multiprocess_phase(card)
    phase("[32] the rounds tracer's knobs: pipeline, tail_stepper, "
          "order_switch_dt")
    knobs_phase(dev, card, out4, out64)
    phase("[33] the plots' data on the card, and --plots")
    plots_phase(card)

    # ---- 34. the autodiff gradient set ----------------------------------
    phase("[34] the AD instances (grad_mode=\"autodiff\") vs plain PyTorch, "
          "and the slice's paths through run.run")
    ad = ad_kernels(dev, card)
    ad_runs = ad_slices(card, {"ensemble10k": out4, "ensemble10k_3d": out3})
    ad_tails = ad_group_tails(card, {run: ad_runs[run][2]
                                     for run in GROUP_RUNS}, census)
    ad_cli(card)

    # ---- 35. every medium and step ceiling of the JAX package -------------
    phase("[35] the media and ceilings the kernel once refused (fractional "
          "weights, any harmonic and shell count, AD at 0 harmonics) vs "
          "plain PyTorch, and their paths at full width")
    anym = any_medium_kernels(dev, card)
    any_runs = any_medium_paths(card)
    phase("[done]")

    def entry(name, launches, err, t, tail=None, team=False, floor=None,
              group=None):
        # the body of the instance (team "tail": the team body in the tail
        # layout, the one-thread body in wider launches); with the time of
        # the run's last launch, the merged tail where the run has one;
        # with floor, tail_layouts' times in cycles an attempt; with group,
        # ad_group_tails' record of the merged tail in each body
        more = {"body": {True: "team4", False: "one-thread",
                         "tail": "team4 in the tail layout, else "
                                 "one-thread"}[team]}
        if group is not None:
            more["body"] = ("group body up to GROUP_MAX_RAYS "
                            f"{sc.GROUP_MAX_RAYS} rays (by the instance's "
                            "dtype, stepper, frame, medium, field), else "
                            "one-thread")
            more["group_tail"] = group
        if tail is not None:
            more.update(tail_ms=tail["ms"], tail_rays=tail["rays"],
                        tail_bucket=tail["bucket"],
                        tail_attempts=tail["attempts"])
        if floor is not None:
            more["latency"] = {
                k: {x: floor[k][x] for x in ("ms", "mhz", "longest",
                                             "cycles_per_attempt")}
                for k in "abcde"}
        return {
            "name": name,
            "route": "cuda",
            "source": "raytrace_tpu_torch/csrc/step_chunk.cu",
            "replaces": "raytrace_tpu/ops/pallas_stepper.py:107",
            "launches": launches,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            # no single PyTorch call computes a multi-step adaptive chunk
            "library_ms": None,
            # ms: t["rays"] rays x t["n"] attempts; plain_ms: these
            "plain_rays": t["plain_rays"],
            "plain_steps": t["plain_n"],
            **more,
        }

    def cg_entry(name, launches, err, t):
        # not the port of a TPU kernel: the JAX package runs this loop
        # through XLA outside Pallas. ms, plain_ms, bound_ms and
        # latency_floor_ms: one launch of 180 CN steps (phase 30 (a)), on
        # `cluster` blocks; launches: the examples' run
        more = {k: v for k, v in t.items()
                if k not in ("ms", "plain_ms", "bound_ms", "bound_by")}
        return {
            "name": f"cn_pcg_2d[{name}]",
            "route": "cuda",
            "source": "raytrace_tpu_torch/csrc/cn_pcg_2d.cu",
            "replaces": "raytrace_tpu/fokker_planck_2d.py:337",
            "kind": "kernel for a non-Pallas loop (evolve_cn_2d's scan "
                    "around the while_loop of _pcg, :304-332)",
            "launches": launches,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            # no single PyTorch call runs a preconditioned CG evolution
            "library_ms": None,
            **more,
        }

    def ad_entry(name, dt_name, row):
        # entry's arguments for an AD instance: the run's launches, the
        # instance's (a) record, its run's last launch replayed and, on a
        # run of GROUP_RUNS, its tail in each body
        launches, tail, _ = ad_runs[name, dt_name]
        return (launches, *ad[row, "bs3", dt_name], tail,
                False, None, ad_tails.get((name, dt_name)))

    print(json.dumps({"kernels": [
        entry("step_chunk[2d_lat,float32,bs3]", launches_2d, err_2d, t_2d,
              tails["2d"], floor=floors["2d"]),
        entry("step_chunk[3d,float32,bs3]", launches_3d, err_3d,
              timings["ensemble10k_3d", "float32", "bs3"]),
        entry("step_chunk[2d_lat+ds_max,float32,bs3]", launches_prod,
              err_prod, timings["ensemble10k_production", "float32", "bs3"],
              tails["prod"]),
        entry("step_chunk[3d+full_medium(mlt),float32,bs3]", launches_plume,
              err_plume, t_full["plume", "float32", "bs3"], tails["plume"],
              team=True),
        entry("step_chunk[3d+full_medium(mlt),float32,bs3](mr_fan_3d)",
              launches_mr, err_mr, t_mr, tails["mr"], team=True),
        entry("step_chunk[3d+full_medium(mlt)+tilted_field,float32,bs3]",
              launches_tilted, *general["tilted"], tails["tilted"],
              floor=floors["tilted"], team="tail"),
        entry("step_chunk[3d+full_medium(mlt)+igrf_field,float32,bs3]",
              launches_igrf, *general["igrf"], tails["igrf"],
              floor=floors["igrf"], team="tail"),
        entry("step_chunk[2d_lat+ds_local,float32,bs3]", launches_local,
              *variants["local"]),
        entry("step_chunk[2d_colat,float32,bs3]", launches_colat,
              *variants["colat"], tails["colat"], floor=floors["colat"]),
        entry("step_chunk[2d_lat+multi_ion,float32,dopri5]", launches_emic,
              *variants["multi_ion"]),
        entry("step_chunk[2d_lat,float64,rk4]", launches_rk4,
              *variants["rk4"], tails["rk4"]),
        entry("step_chunk[2d_lat+reference+legacy,float32,bs3]",
              launches_ref2d, *ref["2d_lat", "float32"], tails["ref2d"]),
        entry("step_chunk[3d+reference,float32,bs3]", launches_ref3d,
              *ref["3d", "float32"], tails["ref3d"]),
        entry("step_chunk[2d_colat+reference+legacy,float64,dopri5](golden)",
              launches_gold["2d_colat"], err_gold["2d_colat"],
              t_gold["2d_colat"]),
        entry("step_chunk[2d_lat+reference+legacy,float64,dopri5](golden)",
              launches_gold["2d_lat"], err_gold["2d_lat"],
              t_gold["2d_lat"]),
        entry("step_chunk[3d+full_medium(mlt),float64,dopri5]"
              "(mr_fan_3d continuation)", launches_cont, *cont,
              tails["cont"], team=True),
        entry("step_chunk[2d_lat,float32,bs3](trajectory block, 32 "
              "attempts)", launches_traj, err_traj, t_blk),
        entry("step_chunk[3d+full_medium(mlt)+reference,float32,bs3]",
              launches_altx["plume"], *altx["plume"], tails_altx["plume"]),
        entry("step_chunk[2d_lat+ds_local+reference,float32,bs3]",
              launches_altx["local"], *altx["local"], tails_altx["local"]),
        entry("step_chunk[2d_lat+multi_ion+legacy,float32,dopri5]",
              launches_altx["emic"], *altx["emic"], tails_altx["emic"]),
        entry("step_chunk[2d_lat,float64,dopri5](trajectory block, 25 "
              "attempts, the lightning fan)", launches_fan, err_fan, t_fan),
        *(cg_entry(name, *fp2d[name]) for name in ("float64", "float32")),
        entry("step_chunk[2d_lat+autodiff,float32,bs3]",
              *ad_entry("ensemble10k", "float32", "2d_lat")),
        entry("step_chunk[2d_lat+ds_local+autodiff,float32,bs3]",
              *ad_entry("ensemble10k_local", "float32", "2d_lat")),
        entry("step_chunk[3d+autodiff,float32,bs3]",
              *ad_entry("ensemble10k_3d", "float32",
                        "3d over the MLT plume")),
        entry("step_chunk[3d+autodiff+tilted_field,float32,bs3]",
              *ad_entry("ensemble10k_tilted", "float32", "3d tilted")),
        entry("step_chunk[2d_lat+autodiff,float64,bs3]",
              *ad_entry("ensemble10k", "float64", "2d_lat")),
        entry("step_chunk[3d+autodiff,float64,bs3]",
              *ad_entry("ensemble10k_3d", "float64",
                        "3d over the MLT plume")),
        *(entry(f"step_chunk[{label},float32,bs3]", any_runs[key][0],
                *anym[key], any_runs[key][1])
          for key, label in (
              ("3d 12 harmonics", "3d+any_medium(mlt, 12 harmonics)"),
              ("2d weights", "2d_lat+any_medium(ps_weight 0.5, de_weight "
                             "0.5)"),
              ("3d weights", "3d+any_medium(mlt, ps_weight 0.5, de_weight "
                             "0.5)"),
              ("3d weights tilted", "3d+any_medium(mlt, ps_weight 0.5, "
                                    "de_weight 0.5)+tilted_field"),
              ("2d six shells", "2d_lat+any_medium(ds_local, 6 shells)"),
              ("2d reference ps_weight", "2d_lat+any_medium(reference, "
                                         "ps_weight 0.5)"),
              ("3d autodiff 12 harmonics", "3d+autodiff_any(mlt, 12 "
                                           "harmonics)"),
              ("2d autodiff six shells", "2d_lat+autodiff_any(ds_local, 6 "
                                         "shells)"),
              ("3d autodiff 0 harmonics", "3d+autodiff(mlt, 0 harmonics)"),
          )),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(*sys.argv[2:5]))
    sys.exit(main())
