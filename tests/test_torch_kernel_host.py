"""The step kernel's two bodies against each other, and its instances of
the reference scripts' modes against the plain version, on the CPU.

There is no CUDA compiler here, but csrc/step_chunk.cu compiles as C++
with stand-ins for the CUDA keywords. This test builds it twice into one
host program -- as it stands, and with every instance on the one-thread
body (kTeamWarps = 0) -- and runs a launch through each: a block runs as
one OS thread per CUDA thread, with a std::barrier for __syncthreads and
a per-warp barrier for __any_sync, so the team body's warp roles, its
shared-memory exchange and its barriers run as written. On the same
carry, made by the port's plain path on the CPU, the two bodies must give
every field bit for bit (the host's libm stands in for the card's math on
both sides). The ALT and ALTX instances (grad_mode="reference",
legacy_freq_state) and the AD instances (grad_mode="autodiff") are held to
the plain PyTorch version on the CPU instead: statuses and counters equal,
states within the bands of two math libraries (the host's libm against
torch's). Needs g++ with C++20.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.config import MediumConfig, preset
from raytrace_tpu_torch.constants import B0_2D, B0_3D, RE
from raytrace_tpu_torch.integrate.solve import init_carry
from raytrace_tpu_torch.ops import rhs as rhs_mod
from raytrace_tpu_torch.ops import step_chunk as sc
from raytrace_tpu_torch.run import _build_u0

STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __shared__
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))
struct dim3_ { unsigned x, y, z; };
inline thread_local dim3_ threadIdx, blockIdx;
namespace emu {
inline std::barrier<>* bar = nullptr;
inline std::barrier<>* wbar[8];
inline std::atomic<int> wor[8];
}
inline void __syncthreads() { emu::bar->arrive_and_wait(); }
inline int __any_sync(unsigned, int p) {
  const int w = threadIdx.x / 32;
  emu::wbar[w]->arrive_and_wait();
  if (threadIdx.x % 32 == 0) emu::wor[w] = 0;
  emu::wbar[w]->arrive_and_wait();
  if (p) emu::wor[w] = 1;
  emu::wbar[w]->arrive_and_wait();
  return emu::wor[w].load();
}
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::isfinite; using std::min; using std::max;
inline void emu_launch(unsigned blocks, int threads,
                       const std::function<void()>& body) {
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> br(threads);
    emu::bar = &br;
    std::vector<std::unique_ptr<std::barrier<>>> wb;
    for (int w = 0; w < threads / 32; ++w) {
      wb.emplace_back(new std::barrier<>(32));
      emu::wbar[w] = wb.back().get();
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        threadIdx = {(unsigned)t, 0, 0};
        body();
      });
    for (auto& th : ts) th.join();
  }
}
"""

MAIN = r"""
#include "stub.h"
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cstdlib>
namespace team_ns {
#include "team.inc"
}
namespace thread_ns {
#include "thread.inc"
}
int main(int argc, char** argv) {
  FILE* fh = fopen(argv[1], "rb");
  int32_t dtype, n, codes[4], n_steps;
  int64_t B;
  fread(&dtype, 4, 1, fh); fread(&n, 4, 1, fh); fread(&B, 8, 1, fh);
  fread(codes, 4, 4, fh); fread(&n_steps, 4, 1, fh);
  const int it = dtype ? 8 : 4;
  std::vector<std::vector<char>> in;
  for (int k = 0; k < 15; ++k) {
    size_t sz = k < 4 ? (size_t)n * B * it
                      : (k < 8 || k == 14 ? (size_t)B * it : (size_t)B * 4);
    in.emplace_back(sz);
    fread(in.back().data(), 1, sz, fh);
  }
  char hp[sizeof(team_ns::StepParams)];
  fread(hp, 1, sizeof hp, fh);
  fclose(fh);
  auto run = [&](bool team) {
    auto bufs = in;
    void* ptrs[15];
    for (int k = 0; k < 15; ++k) ptrs[k] = bufs[k].data();
    int rc = team
      ? team_ns::step_chunk_launch_team(dtype, codes[0], codes[1], codes[2],
            codes[3], ptrs, B, n_steps, (const team_ns::StepParams*)hp, 0)
      : thread_ns::step_chunk_launch_thread(dtype, codes[0], codes[1],
            codes[2], codes[3], ptrs, B, n_steps,
            (const thread_ns::StepParams*)hp, 0);
    if (rc) exit(2);
    return bufs;
  };
  auto a = run(false), b = run(true);
  if (argc > 2) {  // the one-thread body's output, in the input's order
    FILE* out = fopen(argv[2], "wb");
    for (int k = 0; k < 15; ++k) fwrite(a[k].data(), 1, a[k].size(), out);
    fclose(out);
  }
  long differ = 0;
  for (int k = 0; k < 15; ++k) {
    size_t w = (k < 8 || k == 14) ? it : 4;
    for (size_t o = 0; o < a[k].size(); o += w)
      differ += memcmp(&a[k][o], &b[k][o], w) != 0;
  }
  long stopped = 0, attempts = 0;
  const int* st = (const int*)b[8].data();
  for (long long i = 0; i < B; ++i) {
    stopped += st[i] != 0;
    attempts += ((const int*)b[9].data())[i] + ((const int*)b[10].data())[i]
                - ((const int*)in[9].data())[i] - ((const int*)in[10].data())[i];
  }
  printf("team_warps %d thread_warps %d differ %ld stopped %ld attempts %ld\n",
         team_ns::step_chunk_team_warps_team(dtype, codes[0], codes[1],
                                             codes[2], codes[3]),
         thread_ns::step_chunk_team_warps_thread(dtype, codes[0], codes[1],
                                                 codes[2], codes[3]),
         differ, stopped, attempts);
  return 0;
}
"""


def _host_source(src, tag, team):
    s = src.replace("#include <cuda_runtime.h>", "")
    s = s.replace("#include <math.h>", "")
    s = s.replace(
        "extern __shared__ __align__(16) unsigned char team_xch[];",
        "static unsigned char team_xch[65536] "
        "__attribute__((aligned(16)));")
    s = re.sub(r"(step_chunk_kernel<[^>]*>)\s*<<<(.*?), (.*?), (?:[^,]*), "
               r"stream>>>\((.*?)\);",
               lambda m: f"emu_launch({m[2]}, {m[3]}, [&]{{ "
                         f"{m[1]}({m[4]}); }});", s, flags=re.S)
    s = s.replace('extern "C" int step_chunk_launch',
                  f"int step_chunk_launch_{tag}")
    s = s.replace('extern "C" int step_chunk_team_warps',
                  f"int step_chunk_team_warps_{tag}")
    if not team:
        s, n = re.subn(r"constexpr int kTeamWarps = \d+;",
                       "constexpr int kTeamWarps = 0;", s)
        assert n == 1
    return s


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx is not None, "the host check of the kernel needs g++"
    d = tmp_path_factory.mktemp("kernel_host")
    src = open(sc.SOURCE).read()
    (d / "stub.h").write_text(STUB)
    (d / "team.inc").write_text(_host_source(src, "team", True))
    (d / "thread.inc").write_text(_host_source(src, "thread", False))
    (d / "main.cpp").write_text(MAIN)
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-w", "-o",
                           str(d / "kernel_host"), str(d / "main.cpp")],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d


# the media of the team body's density pieces beside the plume's
# (ne_head, ne_lterms, ne_tail against ne_and_grads_full): GCPM and the
# smoothed plasmapause with the per-L trough refill, each with the day/night
# ionosphere and the duct, without and with the MLT-resolved plasmapause;
# a constant refill with the DE factor; no plasmasphere
_DUCT = dict(iono_mlt=True, duct_amp=0.5, duct_l0=3.0, duct_w=0.1)
MEDIA = {
    "gcpm": dict(ps_model="gcpm", **_DUCT),
    "gcpm_mlt": dict(ps_model="gcpm", ps_mlt=True, **_DUCT),
    "smooth": dict(ps_smooth=0.05, ps_refill=0.5, ps_refill_q=4.0, **_DUCT),
    "smooth_mlt": dict(ps_smooth=0.05, ps_refill=0.5, ps_refill_q=4.0,
                       ps_mlt=True, **_DUCT),
    "refill_de": dict(ps_refill=0.5, de_correction=True, ps_mlt=True),
    "no_ps": dict(plasmasphere=False, iono_mlt=True),
}

# (preset, dtype, stepper, every, edge, medium): the team instances (the
# 3D full chain over the dipole) against the one-thread body; edges as on
# the card (B not a multiple of 32, rays stopped at entry, rays retiring by
# ESCAPED and EVANESCENT, n_steps = 0); the medium is the preset's or one
# of MEDIA
CASES = {
    "3d_full_f32_bs3_stops": ("ensemble10k_plume", "float32", "bs3", 100,
                              "stops", None),
    "3d_full_f64_dopri5_odd": ("ensemble10k_plume", "float64", "dopri5",
                               200, "odd", None),
    "3d_full_f64_dopri5_stopped": ("ensemble10k_plume", "float64", "dopri5",
                                   200, "stopped", None),
    "3d_full_f32_rk4": ("ensemble10k_plume", "float32", "rk4", 100, "",
                        None),
    "3d_full_f64_bs3_zero": ("ensemble10k_plume", "float64", "bs3", 100,
                             "zero", None),
    **{f"3d_{m}_f32_bs3": ("ensemble10k_plume", "float32", "bs3", 100, "",
                           m) for m in MEDIA},
    **{f"3d_{m}_f64_dopri5": ("ensemble10k_plume", "float64", "dopri5", 200,
                              "", m) for m in MEDIA},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_team_body_matches_one_thread_body_on_the_host(host_kernel, case):
    name, dtype, stepper, every, edge, medium = CASES[case]
    over = dict(adaptive=False, dt0=1.0e6 / RE) if stepper == "rk4" else {}
    if medium is not None:
        over["medium"] = MediumConfig(b0=B0_3D, **MEDIA[medium])
    conf = preset(name, dtype=dtype, **over)
    env = conf.medium.build()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::every]), torch.as_tensor(f[::every])
    if edge == "odd":
        u0, f = u0[:45], f[:45]
    cfg, spec = conf.solver(), conf.stop()
    carry = init_carry(rhs_mod.frame_rhs(conf.frame, env)[0], u0, f, cfg)
    if edge == "stopped":
        status = carry.status.clone()
        status[::7] = 1
        carry = carry._replace(status=status)
    if edge == "stops":
        spec = spec._replace(r_ceil=float(u0[:, 0].max()) * 1.02,
                             stop_retrograde=1.0)
        u = carry.u.clone()
        u[::3, -1] = -1.0e-3
        carry = carry._replace(u=u)
    n_steps = {"zero": 0}.get(edge, 48)
    codes = [sc._STEPPER_CODE[stepper if conf.adaptive else "rk4"],
             sc._FRAME_CODE[conf.frame][0], sc.medium_code(env, cfg),
             sc.field_code(env)]
    path = host_kernel / f"{case}.bin"
    with open(path, "wb") as fh:
        fh.write(np.int32(0 if dtype == "float32" else 1).tobytes())
        fh.write(np.int32(carry.u.shape[1]).tobytes())
        fh.write(np.int64(f.shape[0]).tobytes())
        fh.write(np.asarray(codes + [n_steps], np.int32).tobytes())
        # the kernel's order (ops/step_chunk.py): the vectors field-major
        for k in (*sc._VEC, "t", "dt", "errold", "dt_prev", *sc._INT):
            x = getattr(carry, k).numpy()
            fh.write(np.ascontiguousarray(x.T if x.ndim == 2 else x)
                     .tobytes())
        fh.write(np.ascontiguousarray(f.numpy()).tobytes())
        fh.write(bytes(sc._params(env, cfg, spec, conf.root)))
    proc = subprocess.run([str(host_kernel / "kernel_host"), str(path)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    got = dict(zip(proc.stdout.split()[::2],
                   map(int, proc.stdout.split()[1::2])))
    assert got["team_warps"] == 4 and got["thread_warps"] == 0
    assert got["differ"] == 0
    live = int((carry.status == 0).sum())
    if edge == "zero":
        assert got["attempts"] == 0
    else:   # every live ray made attempts, the stopped ones none
        assert got["attempts"] >= live * 10
    if edge == "stops":
        assert got["stopped"] > 0


# (preset, dtype, stepper, every, grad_mode, legacy, overrides): the ALT
# instances over the 2D frames with both modes or either, the 3D frame
# with the reference set, the ionosphere-only medium (raymain) and the
# DE factor
ALT_CASES = {
    "lat_ref_legacy_f64_bs3": ("ensemble10k", "bs3", 100, "reference",
                               True, {}),
    "lat_ref_f64_dopri5": ("ensemble10k", "dopri5", 100, "reference",
                           False, {}),
    "lat_legacy_f64_rk4": ("ensemble10k", "rk4", 100, "fused", True,
                           dict(adaptive=False, dt0=1.0e6 / RE)),
    "colat_ref_legacy_f64_dopri5": ("ensemble10k", "dopri5", 100,
                                    "reference", True,
                                    dict(frame="2d_colat")),
    "de_ref_legacy_f64_bs3": ("ensemble10k", "bs3", 100, "reference", True,
                              dict(medium=MediumConfig(
                                  b0=3.0696381e-5, de_correction=True))),
    "raymain_ref_legacy_f64_dopri5": ("raymain", "dopri5", 1, "reference",
                                      True, {}),
    "3d_ref_f64_bs3": ("ensemble10k_3d", "bs3", 100, "reference", False,
                       {}),
    "3d_ref_f64_dopri5": ("ensemble10k_3d", "dopri5", 100, "reference",
                          False, {}),
}


def _host_launch(host_kernel, case, carry, f, codes, n_steps, params):
    """One launch of the host build; returns the one-thread body's output
    carry as {field: numpy array}."""
    order = (*sc._VEC, "t", "dt", "errold", "dt_prev", *sc._INT)
    path = host_kernel / f"{case}_{n_steps}.bin"
    with open(path, "wb") as fh:
        fh.write(np.int32(1 if f.dtype == torch.float64 else 0).tobytes())
        fh.write(np.int32(carry.u.shape[1]).tobytes())
        fh.write(np.int64(f.shape[0]).tobytes())
        fh.write(np.asarray(codes + [n_steps], np.int32).tobytes())
        for k in order:
            x = getattr(carry, k).numpy()
            fh.write(np.ascontiguousarray(x.T if x.ndim == 2 else x)
                     .tobytes())
        fh.write(np.ascontiguousarray(f.numpy()).tobytes())
        fh.write(bytes(params))
    out_path = host_kernel / f"{case}_{n_steps}.out"
    proc = subprocess.run([str(host_kernel / "kernel_host"), str(path),
                           str(out_path)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    raw = out_path.read_bytes()
    b, n = f.shape[0], carry.u.shape[1]
    fdt = np.float64 if f.dtype == torch.float64 else np.float32
    got, o = {}, 0
    for k in order:
        dt, cnt = (np.int32, b) if k in sc._INT else (
            fdt, n * b if k in sc._VEC else b)
        x = np.frombuffer(raw, dt, cnt, o)
        got[k] = x.reshape(n, b).T if k in sc._VEC else x
        o += x.nbytes
    return got


# the ALTX instances (the extended chain under the modes): the MLT plume
# in 3D with the reference set (its closed form over the density without
# longitude) at both steppers and fixed-step rk4, and over GCPM; the 2D
# frames over GCPM with the duct and the day/night ionosphere, the
# smoothed plasmapause with the trough refill, the local arc ceiling under
# the reference set, and legacy_freq_state over He+ and O+ (emic_heband)
_GCPM_2D = MediumConfig(b0=B0_2D, ps_model="gcpm", **_DUCT)
ALTX_CASES = {
    "plume_ref_f64_bs3": ("ensemble10k_plume", "bs3", 100, "reference",
                          False, {}),
    "plume_ref_f64_dopri5": ("ensemble10k_plume", "dopri5", 100,
                             "reference", False, {}),
    "plume_ref_f64_rk4": ("ensemble10k_plume", "rk4", 100, "reference",
                          False, dict(adaptive=False, dt0=1.0e-3)),
    "plume_gcpm_ref_f64_dopri5": ("ensemble10k_plume", "dopri5", 100,
                                  "reference", False, dict(medium=MediumConfig(
                                   b0=B0_3D, ps_model="gcpm", ps_mlt=True,
                                   **_DUCT))),
    "lat_gcpm_ref_legacy_f64_bs3": ("ensemble10k", "bs3", 100, "reference",
                                    True, dict(medium=_GCPM_2D)),
    "colat_smooth_ref_legacy_f64_dopri5": (
        "ensemble10k", "dopri5", 100, "reference", True,
        dict(frame="2d_colat", medium=MediumConfig(
            b0=B0_2D, ps_smooth=0.05, ps_refill=0.5, ps_refill_q=4.0))),
    "local_ref_f64_bs3": ("ensemble10k_local", "bs3", 100, "reference",
                          False, {}),
    "emic_legacy_f64_dopri5": ("emic_heband", "dopri5", 1, "fused", True,
                               {}),
}


def _hold_to_plain(host_kernel, case, case_spec, code):
    """One case of ALT_CASES or ALTX_CASES (case_spec) through the host build,
    whose medium code must be `code`, against the plain version."""
    name, stepper, every, grad_mode, legacy, over = case_spec
    conf = preset(name, dtype="float64", **over)
    env = conf.medium.build()
    u0, f = _build_u0(conf, env, np.float64, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::every]), torch.as_tensor(f[::every])
    cfg, spec = conf.solver(), conf.stop()
    kw = dict(frame=conf.frame, root=conf.root, adaptive=conf.adaptive,
              grad_mode=grad_mode, legacy_freq_state=legacy)
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env, conf.root, grad_mode,
                               legacy)[0]
    carry = init_carry(rhs_fn, u0, f, cfg)
    codes = [sc._STEPPER_CODE[stepper if conf.adaptive else "rk4"],
             sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg, grad_mode, legacy), sc.field_code(env)]
    assert codes[2] == code
    params = sc._params(env, cfg, spec, conf.root, grad_mode, legacy)
    nudged = sc.step_chunk_reference(
        init_carry(rhs_fn, torch.nextafter(u0, torch.full_like(u0, np.inf)),
                   f, cfg), f, env, cfg, spec, stepper=stepper, n_steps=8,
        **kw)
    for n_steps, rtol in ((1, 1e-13), (8, 1e-6)):
        got = _host_launch(host_kernel, case, carry, f, codes, n_steps,
                           params)
        ref = sc.step_chunk_reference(carry, f, env, cfg, spec,
                                      stepper=stepper, n_steps=n_steps,
                                      **kw)
        for k in ("status", "n_accept", "n_reject"):
            np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(),
                                          err_msg=f"{k} after {n_steps}")
        assert int((got["n_accept"] + got["n_reject"]).sum()) == (
            n_steps * f.shape[0])
        for k in ("u", "t", "dt", "k1"):
            want = getattr(ref, k).numpy()
            scale = np.maximum(np.abs(want).max(axis=0), 1e-300)
            err = float(np.max(np.abs(got[k] - want) / scale))
            band = rtol
            if n_steps == 8:
                spread = np.abs(getattr(nudged, k).numpy() - want) / scale
                band = max(rtol, float(np.max(spread)))
            assert err <= band, (k, n_steps, err, band)


# the AD instances (the autodiff set, the value chain on dual numbers):
# the 2D latitude frame (with legacy_freq_state), the colatitude frame over
# GCPM with the duct and the day/night ionosphere, the smoothed
# plasmapause with the trough refill under the local ceiling, the 3D frame
# over the MLT plume (and fixed-step rk4 over the MLT GCPM), the tilted
# dipole and IGRF, and He+ and O+ at the EMIC root (emic_heband)
AD_CASES = {
    "lat_f64_bs3": ("ensemble10k", "bs3", 100, "autodiff", False, {}),
    "lat_legacy_f64_dopri5": ("ensemble10k", "dopri5", 100, "autodiff",
                              True, {}),
    "colat_gcpm_f64_dopri5": ("ensemble10k", "dopri5", 100, "autodiff",
                              False, dict(frame="2d_colat",
                                          medium=_GCPM_2D)),
    "local_smooth_f64_bs3": ("ensemble10k_local", "bs3", 100, "autodiff",
                             False, dict(medium=MediumConfig(
                                 b0=B0_2D, ps_smooth=0.05, ps_refill=0.5,
                                 ps_refill_q=4.0, **_DUCT))),
    "plume_f64_bs3": ("ensemble10k_plume", "bs3", 100, "autodiff", False,
                      {}),
    "plume_gcpm_f64_rk4": ("ensemble10k_plume", "rk4", 100, "autodiff",
                           False, dict(adaptive=False, dt0=1.0e-3,
                                       medium=MediumConfig(
                                           b0=B0_3D, ps_model="gcpm",
                                           ps_mlt=True, **_DUCT))),
    "tilted_f64_dopri5": ("ensemble10k_tilted", "dopri5", 100, "autodiff",
                          False, {}),
    "igrf_f64_bs3": ("ensemble10k_igrf", "bs3", 100, "autodiff", False, {}),
    "emic_f64_dopri5": ("emic_heband", "dopri5", 1, "autodiff", False, {}),
}


@pytest.mark.parametrize("case", sorted(ALT_CASES))
def test_alt_instances_match_plain_version_on_the_host(host_kernel, case):
    """An ALT instance (one-thread body) against step_chunk_reference on
    the same float64 carry: after 1 attempt every field within rtol 1e-13
    of its component's largest magnitude (the right-hand side with the
    closed form and the Kimura chain, computed by the two math libraries,
    the host's libm and torch's), after 8 attempts statuses and counters
    equal and u, t, dt, k1 within 1e-6 (dt0 = 1e-4, ROADMAP C: the
    axisymmetric instance shows 6e-7 in t at the 3D launch), or within the
    plain version's own spread where that is larger: the plain version
    from the same launch with every state component one ulp up, after the
    same 8 attempts (the 3D dopri5 launch: 6e-5 in t, where the two math
    libraries' launches differ by ~1e-6). Over more attempts the reference
    set's wedges turn that noise into other accept/reject paths (48
    attempts: ~5% of the rays), as bs3 does at any launch."""
    _hold_to_plain(host_kernel, case, ALT_CASES[case], sc.ALT)


@pytest.mark.parametrize("case", sorted(ALTX_CASES))
def test_altx_instances_match_plain_version_on_the_host(host_kernel, case):
    """An ALTX instance against step_chunk_reference, as the ALT instances
    are held: the modes over the full density chain, the ion species and
    the local ceiling; in 3D over the MLT-resolved medium the closed form
    over the chain's density at the base parameters (a negative control,
    the chain's MLT density in the closed form, misses the plain version
    by far more than this band: tests/test_torch_reference_full.py)."""
    _hold_to_plain(host_kernel, case, ALTX_CASES[case], sc.ALTX)


@pytest.mark.parametrize("case", sorted(AD_CASES))
def test_ad_instances_match_plain_version_on_the_host(host_kernel, case):
    """An AD instance (the autodiff set: the value chain on dual numbers,
    every tangent by torch's forward-mode rule) against step_chunk_reference
    (ops/dual.py's rules on tensors), as the ALTX instances are held: after
    1 attempt every field within 1e-13 of its component's scale (the two
    math libraries, the host's libm and torch's), after 8 statuses and
    counters equal, states within 1e-6 or the plain version's own one-ulp
    spread. A mutated tangent rule or a wrong constant of the chain misses
    by orders of magnitude more (a wrong IGRF coefficient: 1.0)."""
    _hold_to_plain(host_kernel, case, AD_CASES[case], sc.AD)
