"""The step kernel's two bodies against each other, and its instances of
the reference scripts' modes against the plain version, on the CPU.

There is no CUDA compiler here, but csrc/step_chunk.cu compiles as C++
with stand-ins for the CUDA keywords. This test builds it twice into one
host program -- as it stands, and with every instance on the one-thread
body (kTeamWarps = 0) with its stages unrolled in the dense layout (no
stage loop, no tail layout: chain_instance false) -- and runs a launch
through each: a block runs as
one OS thread per CUDA thread, with a std::barrier for __syncthreads and
a per-warp barrier for __any_sync and __shfl_sync, so the team body's
warp roles, its shared-memory exchange and its barriers, and the group
body's shuffles, run as written (the second build has no group body:
group_instance false). On the same
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
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.solve import (
    RayCarry, init_carry, refine_events,
)
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
#include <cstring>
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
inline unsigned long long wval[8][32];
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
// each lane posts its value, the warp's barrier, each reads its source
// lane in its segment of `width` lanes, the barrier again; a lane that has
// left has dropped out of its warp's barrier (emu_launch)
template <typename V>
inline V __shfl_sync(unsigned, V v, int src, int width = 32) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::memcpy(&emu::wval[w][lane], &v, sizeof v);
  emu::wbar[w]->arrive_and_wait();
  V out;
  std::memcpy(&out, &emu::wval[w][(lane & ~(width - 1)) + src % width],
              sizeof out);
  emu::wbar[w]->arrive_and_wait();
  return out;
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
        emu::wbar[t / 32]->arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}
"""

MAIN = r"""
#include "stub.h"
#include <cstddef>
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
  if (argc > 1 && strcmp(argv[1], "--group-lanes") == 0) {
    // the group body's lanes a ray of every instance: dtype stepper frame
    // medium field lanes, one line each
    for (int d = 0; d < 2; ++d)
      for (int st = 0; st < 3; ++st)
        for (int fr = 0; fr < 3; ++fr)
          for (int m = 0; m < 8; ++m)
            for (int fd = 0; fd < 3; ++fd)
              printf("%d %d %d %d %d %d\n", d, st, fr, m, fd,
                     team_ns::step_chunk_group_lanes_team(d, st, fr, m, fd));
    return 0;
  }
  FILE* fh = fopen(argv[1], "rb");
  int32_t dtype, n, codes[4], n_steps, flags;
  int64_t B;
  fread(&dtype, 4, 1, fh); fread(&n, 4, 1, fh); fread(&B, 8, 1, fh);
  fread(codes, 4, 4, fh); fread(&n_steps, 4, 1, fh);
  fread(&flags, 4, 1, fh);
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
  // the MLT coefficients and the shells past the parameters' (a count,
  // then the values in the run dtype): their pointers into hp
  std::vector<char> ext[2];
  const size_t at[2] = {offsetof(team_ns::StepParams, mlt_ext),
                        offsetof(team_ns::StepParams, shell_ext)};
  for (int e = 0; e < 2; ++e) {
    int64_t cnt;
    fread(&cnt, 8, 1, fh);
    ext[e].resize(cnt * it);
    fread(ext[e].data(), 1, ext[e].size(), fh);
    const void* ptr = cnt ? ext[e].data() : nullptr;
    memcpy(hp + at[e], &ptr, sizeof ptr);
  }
  fclose(fh);
  auto run = [&](bool team) {
    auto bufs = in;
    void* ptrs[15];
    for (int k = 0; k < 15; ++k) ptrs[k] = bufs[k].data();
    int rc = team
      ? team_ns::step_chunk_launch_team(dtype, codes[0], codes[1], codes[2],
            codes[3], ptrs, B, n_steps, flags,
            (const team_ns::StepParams*)hp, 0)
      : thread_ns::step_chunk_launch_thread(dtype, codes[0], codes[1],
            codes[2], codes[3], ptrs, B, n_steps, flags,
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
  printf("team_warps %d thread_warps %d tail_layout %d group_lanes %d "
         "thread_group_lanes %d differ %ld stopped %ld attempts %ld\n",
         team_ns::step_chunk_team_warps_team(dtype, codes[0], codes[1],
                                             codes[2], codes[3]),
         thread_ns::step_chunk_team_warps_thread(dtype, codes[0], codes[1],
                                                 codes[2], codes[3]),
         team_ns::step_chunk_tail_layout_team(dtype, codes[0], codes[1],
                                              codes[2], codes[3]),
         team_ns::step_chunk_group_lanes_team(dtype, codes[0], codes[1],
                                              codes[2], codes[3]),
         thread_ns::step_chunk_group_lanes_thread(dtype, codes[0], codes[1],
                                                  codes[2], codes[3]),
         differ, stopped, attempts);
  return 0;
}
"""


def _host_source(src, tag, as_is):
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
    s = s.replace('extern "C" int step_chunk_tail_layout',
                  f"int step_chunk_tail_layout_{tag}")
    s = s.replace('extern "C" int step_chunk_group_lanes',
                  f"int step_chunk_group_lanes_{tag}")
    if not as_is:
        # every instance on the one-thread body (no team, no group body),
        # its stages unrolled, in the dense layout
        s, n = re.subn(r"constexpr int kTeamWarps = \d+;",
                       "constexpr int kTeamWarps = 0;", s)
        assert n == 1
        s, n = re.subn(r"(constexpr bool chain_instance\([^)]*\) \{\n)"
                       r"  return [^;]*;", r"\1  return false;", s)
        assert n == 1
        s, n = re.subn(r"(constexpr bool group_instance\([^)]*\) \{\n)"
                       r"  return [^;]*;", r"\1  return false;", s)
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

# the fields of the general-field presets, kept where a case's medium is
# one of MEDIA
_FIELDS = {"ensemble10k_tilted": dict(b_model="tilted", b_tilt=0.2,
                                      b_tilt_phi=0.5),
           "ensemble10k_igrf": dict(b_model="igrf")}
# the media of the general-field team body beside its presets': the MLT
# GCPM and the smoothed MLT plasmapause, no plasmasphere, the DE factor with
# the refill, and the axisymmetric CA1992 (ps_mlt off: the chain rule
# through the magnetic latitude alone)
_GENERAL_MEDIA = ("gcpm_mlt", "smooth_mlt", "no_ps", "refill_de", "gcpm",
                  "ca1992")

# (preset, dtype, stepper, every, edge, medium): the team instances (the
# 3D full chain over the dipole, and the float32 bs3 one over each
# non-axial field) against the one-thread body; edges as on the card (B
# not a multiple of 32, rays stopped at entry, rays retiring by ESCAPED and
# EVANESCENT, n_steps = 0, a launch with finish where rays land);
# the medium is the preset's or one of MEDIA
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
    **{f"{g}_f32_bs3_{e or 'preset'}": (f"ensemble10k_{g}", "float32",
                                        "bs3", 100, e, None)
       for g in ("tilted", "igrf")
       for e in ("", "stops", "odd", "stopped", "zero", "finish")},
    **{f"{g}_{m}_f32_bs3": (f"ensemble10k_{g}", "float32", "bs3", 100, "",
                            m)
       for g in ("tilted", "igrf") for m in _GENERAL_MEDIA},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_team_body_matches_one_thread_body_on_the_host(host_kernel, case):
    name, dtype, stepper, every, edge, medium = CASES[case]
    over = dict(adaptive=False, dt0=1.0e6 / RE) if stepper == "rk4" else {}
    if medium is not None:
        over["medium"] = MediumConfig(b0=B0_3D, **_FIELDS.get(name, {}),
                                      **MEDIA.get(medium, {}))
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
    params = sc._params(env, cfg, spec, conf.root)
    assert codes[2] == sc.FULL and codes[3] == (name in _FIELDS) + (
        name == "ensemble10k_igrf")
    # over the non-axial fields the team body runs the launches in the
    # tail layout (flag bit 4), the others the one-thread body
    flags = 4 if name in _FIELDS else 0
    if edge == "finish":
        # 160 attempts first, then a launch of 48 with finish: rays refined
        # at entry and rays that land inside it (fresh there would form k1
        # at the wedge rays too, NaN, whose sign the host's arithmetic does
        # not canonicalize as the card's does; the fresh test below holds
        # fresh through both bodies at the launch carry)
        carry = _carry_of(_host_run(host_kernel, case, carry, f, codes, 160,
                                    params)[0])
        flags |= 1
    out, got = _host_run(host_kernel, case, carry, f, codes, n_steps, params,
                         flags=flags, out=edge == "finish")
    assert got["team_warps"] == 4 and got["thread_warps"] == 0
    assert got["tail_layout"] == (name in _FIELDS)
    assert got["differ"] == 0
    live = int((carry.status == 0).sum())
    if edge == "zero":
        assert got["attempts"] == 0
    else:   # every live ray made attempts, the stopped ones none
        assert got["attempts"] >= live * 10
    if edge == "stops":
        assert got["stopped"] > 0
    if edge == "finish":
        hit = out["status"] == events.HIT_EARTH
        before = carry.status.numpy() == events.HIT_EARTH
        assert before.any() and (hit & ~before).any()


# (dtype, stepper) of the general-field instances over FULL: the float32 bs3
# one takes the team body in the tail layout (ensemble10k_tilted's and
# ensemble10k_igrf's), its double, dopri5 and rk4 siblings keep the
# one-thread body
_SIBLINGS = [("float32", "bs3", 4), ("float64", "bs3", 0),
             ("float32", "dopri5", 0), ("float32", "rk4", 0),
             ("float64", "dopri5", 0), ("float64", "rk4", 0)]


@pytest.mark.parametrize("name", sorted(_FIELDS))
@pytest.mark.parametrize("dtype,stepper,want", _SIBLINGS)
def test_team_body_takes_the_general_field_float_bs3_instance(
        host_kernel, name, dtype, stepper, want):
    """team_warps is 4 for the float32 bs3 instance of each non-axial field
    over the full chain, which takes the tail layout, and 0 for its
    siblings, which do not; a launch of 0 attempts through each, in the
    tail layout where it has it, leaves the carry as it was in both
    builds."""
    conf = preset(name, dtype=dtype)
    env = conf.medium.build()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::1000]), torch.as_tensor(f[::1000])
    cfg, spec = conf.solver(), conf.stop()
    carry = init_carry(rhs_mod.frame_rhs(conf.frame, env)[0], u0, f, cfg)
    codes = [sc._STEPPER_CODE[stepper], sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg), sc.field_code(env)]
    got, stats = _host_run(host_kernel, f"siblings_{name}_{dtype}_{stepper}",
                           carry, f, codes, 0,
                           sc._params(env, cfg, spec, conf.root), flags=4)
    assert (stats["team_warps"], stats["thread_warps"]) == (want, 0)
    assert stats["tail_layout"] == (want > 0)
    assert stats["differ"] == 0 and stats["attempts"] == 0
    for k in _ORDER:
        np.testing.assert_array_equal(
            got[k], getattr(carry, k).numpy(), err_msg=k)


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


# the kernel's order of the carry's fields (ops/step_chunk.py)
_ORDER = (*sc._VEC, "t", "dt", "errold", "dt_prev", *sc._INT)


def _host_run(host_kernel, case, carry, f, codes, n_steps, params, flags=0,
              out=True, ext=(None, None)):
    """One launch of the host build, through both bodies: flags 1 =
    finish, 2 = fresh; ext: the MLT coefficients and shells past the
    parameters' (step_chunk._overflow on the CPU). Returns (the one-thread
    body's output carry as
    {field: numpy array}, or None without `out`; the program's counts:
    team_warps, thread_warps, differ (values the two bodies' outputs
    differ in), stopped, attempts)."""
    path = host_kernel / f"{case}_{n_steps}_{flags}.bin"
    with open(path, "wb") as fh:
        fh.write(np.int32(1 if f.dtype == torch.float64 else 0).tobytes())
        fh.write(np.int32(carry.u.shape[1]).tobytes())
        fh.write(np.int64(f.shape[0]).tobytes())
        fh.write(np.asarray(codes + [n_steps, flags], np.int32).tobytes())
        # the vectors field-major
        for k in _ORDER:
            x = getattr(carry, k).numpy()
            fh.write(np.ascontiguousarray(x.T if x.ndim == 2 else x)
                     .tobytes())
        fh.write(np.ascontiguousarray(f.numpy()).tobytes())
        fh.write(bytes(params))
        for x in ext:
            fh.write(np.int64(0 if x is None else x.numel()).tobytes())
            if x is not None:
                fh.write(x.numpy().tobytes())
    out_path = host_kernel / f"{case}_{n_steps}_{flags}.out"
    proc = subprocess.run([str(host_kernel / "kernel_host"), str(path)]
                          + ([str(out_path)] if out else []),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    stats = dict(zip(proc.stdout.split()[::2],
                     map(int, proc.stdout.split()[1::2])))
    if not out:
        return None, stats
    raw = out_path.read_bytes()
    b, n = f.shape[0], carry.u.shape[1]
    fdt = np.float64 if f.dtype == torch.float64 else np.float32
    got, o = {}, 0
    for k in _ORDER:
        dt, cnt = (np.int32, b) if k in sc._INT else (
            fdt, n * b if k in sc._VEC else b)
        x = np.frombuffer(raw, dt, cnt, o)
        got[k] = x.reshape(n, b).T if k in sc._VEC else x
        o += x.nbytes
    return got, stats


def _host_launch(host_kernel, case, carry, f, codes, n_steps, params,
                 ext=(None, None)):
    """One launch of the host build; returns the one-thread body's output
    carry as {field: numpy array}."""
    return _host_run(host_kernel, case, carry, f, codes, n_steps, params,
                     ext=ext)[0]


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
    whose medium code must be `code`, against the plain version. A case
    spec may end in two more dicts: fields of the built env and of the
    SolverConfig to replace."""
    name, stepper, every, grad_mode, legacy, over, *more = case_spec
    env_over, cfg_over = (*more, {}, {})[:2]
    conf = preset(name, dtype="float64", **over)
    env = conf.medium.build()._replace(**env_over)
    u0, f = _build_u0(conf, env, np.float64, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::every]), torch.as_tensor(f[::every])
    cfg, spec = conf.solver()._replace(**cfg_over), conf.stop()
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
    ext = sc._overflow(env, cfg, f.dtype, "cpu")
    nudged = sc.step_chunk_reference(
        init_carry(rhs_fn, torch.nextafter(u0, torch.full_like(u0, np.inf)),
                   f, cfg), f, env, cfg, spec, stepper=stepper, n_steps=8,
        **kw)
    for n_steps, rtol in ((1, 1e-13), (8, 1e-6)):
        got = _host_launch(host_kernel, case, carry, f, codes, n_steps,
                           params, ext)
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


# The media and step ceilings the kernel once refused: fractional
# plasmasphere and DE weights, MLT shapes of 0 and 12 harmonics (the
# coefficients past the parameters' eight from their buffer), six
# local-ceiling shells (four in the parameters, two from the buffer). Over
# (medium fields, env fields) of the plume: at 12 harmonics and at the
# weights the launch takes the ANY instance, on the one-thread body in
# both builds; MLT GCPM at 0 harmonics keeps the FULL instance, whose team
# body must match the one-thread body bit for bit
_PLUME_MLT = dict(b0=B0_3D, ps_mlt=True)
ANY_MEDIA = {
    "h12": (dict(_PLUME_MLT, ps_mlt_harmonics=12), {}),
    "gcpm_h0": (dict(_PLUME_MLT, ps_mlt_harmonics=0, ps_model="gcpm"), {}),
    "weights": (dict(_PLUME_MLT, de_correction=True, ps_smooth=0.05),
                dict(ps_weight=0.5, de_weight=0.5)),
}


@pytest.mark.parametrize("dtype,stepper", [("float32", "bs3"),
                                           ("float64", "dopri5")])
@pytest.mark.parametrize("medium", sorted(ANY_MEDIA))
def test_team_body_takes_any_medium_on_the_host(host_kernel, medium, dtype,
                                                stepper):
    med, env_over = ANY_MEDIA[medium]
    conf = preset("ensemble10k_plume", dtype=dtype,
                  medium=MediumConfig(**med))
    env = conf.medium.build()._replace(**env_over)
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::160]), torch.as_tensor(f[::160])
    cfg, spec = conf.solver(), conf.stop()
    codes = [sc._STEPPER_CODE[stepper], sc._FRAME_CODE["3d"][0],
             sc.medium_code(env, cfg), sc.field_code(env)]
    team = medium == "gcpm_h0"
    assert codes[2] == (sc.FULL if team else sc.ANY)
    carry = init_carry(rhs_mod.frame_rhs("3d", env)[0], u0, f, cfg)
    _, got = _host_run(host_kernel, f"any_{medium}_{dtype}", carry, f, codes,
                       32, sc._params(env, cfg, spec, conf.root), out=False,
                       ext=sc._overflow(env, cfg, f.dtype, "cpu"))
    assert got["team_warps"] == (4 if team else 0) and got["differ"] == 0
    assert got["attempts"] == 32 * f.shape[0]


# ... and each instance against the plain version, as the ALTX instances
# are held (the last two dicts: env fields and SolverConfig fields to
# replace): ANY in 2D at ps_weight 0.5 and in the colatitude frame at
# de_weight 0.5, in 3D at 12 harmonics, over the tilted dipole at both
# weights, with six shells, and under the reference set at ps_weight 0.5;
# AD in 3D at 0 harmonics and in 2D at both weights; AD_ANY in 3D at 12
# harmonics and in 2D with six shells (the six shells at a hundredth of
# the ceiling, which then sets every step, so that the shells past the
# parameters' four bind on the fan's high-latitude rays)
_SIX_SHELLS = dict(ds_local_shells=((2.5, 0.05), (3.0, 0.1), (3.5, 0.1),
                                    (5.0, 0.2), (6.0, 0.3)))
_H12 = MediumConfig(**ANY_MEDIA["h12"][0])
_H0 = MediumConfig(b0=B0_3D, ps_mlt=True, ps_mlt_harmonics=0)
_DE_2D = MediumConfig(b0=B0_2D, de_correction=True)
_HALF = dict(ps_weight=0.5, de_weight=0.5)
_DE_TILTED = MediumConfig(b0=B0_3D, b_model="tilted", b_tilt=0.2,
                          de_correction=True)
_SIX_LOCAL = dict(_SIX_SHELLS, ds_local_frac=0.01)
ANY_CASES = {
    "lat_ps_half_f64_bs3": (sc.ANY, ("ensemble10k", "bs3", 100, "fused",
                                     False, {}, dict(ps_weight=0.5))),
    "colat_de_half_f64_dopri5": (sc.ANY, (
        "ensemble10k", "dopri5", 100, "fused", False,
        dict(frame="2d_colat", medium=_DE_2D), dict(de_weight=0.5))),
    "plume_h12_f64_bs3": (sc.ANY, ("ensemble10k_plume", "bs3", 100, "fused",
                                   False, dict(medium=_H12))),
    "tilted_half_f64_rk4": (sc.ANY, (
        "ensemble10k_tilted", "bs3", 100, "fused", False,
        dict(medium=_DE_TILTED, adaptive=False, dt0=1.0e-3), _HALF)),
    "local_six_shells_f64_bs3": (sc.ANY, ("ensemble10k_local", "bs3", 100,
                                          "fused", False, {}, {},
                                          _SIX_LOCAL)),
    "plume_ps_half_ref_f64_bs3": (sc.ANY, (
        "ensemble10k_plume", "bs3", 100, "reference", False, {},
        dict(ps_weight=0.5))),
    "ad_plume_h0_f64_bs3": (sc.AD, ("ensemble10k_plume", "bs3", 100,
                                    "autodiff", False, dict(medium=_H0))),
    "ad_plume_h12_f64_dopri5": (sc.AD_ANY, (
        "ensemble10k_plume", "dopri5", 100, "autodiff", False,
        dict(medium=_H12))),
    "ad_lat_half_f64_bs3": (sc.AD, ("ensemble10k", "bs3", 100, "autodiff",
                                    False, dict(medium=_DE_2D), _HALF)),
    "ad_local_six_shells_f64_bs3": (sc.AD_ANY, (
        "ensemble10k_local", "bs3", 100, "autodiff", False, {}, {},
        _SIX_LOCAL)),
}


@pytest.mark.parametrize("case", sorted(ANY_CASES))
def test_instances_take_any_medium_on_the_host(host_kernel, case):
    """The ANY, AD and AD_ANY instances over the media and ceilings above
    against step_chunk_reference, as the ALTX instances are held."""
    code, spec = ANY_CASES[case]
    _hold_to_plain(host_kernel, case, spec, code)


# The trace's end inside the launch (finish: refine_events after the loop;
# fresh: init_carry's right-hand side before it). (preset, stepper, every,
# m, n, grad_mode, legacy, overrides, stop overrides): the host build steps
# the launch's carry m attempts (flags off), then a launch of n attempts
# with both flags on, whose rays include ones that retired before it (and
# are refined all the same) and ones that land inside it. The 2D latitude
# frame with HIT_EARTH and with the equator stop (HIT_EQUATOR), the
# colatitude and 3D frames, the team body (the plume), an AD instance and
# an ALTX one (the reference set over the MLT plume, 8 attempts: its wedges
# make longer launches chaotic, as the ALTX cases above are held); m and n
# put the launch where some of every 100th ray of the fan land (the host
# build's census of each fan: 2D lat 13 rays in [1248, 1312), the equator
# stop 12 at the equator in [560, 624), colat 4 in [1080, 1160), 3D and
# the plume ~10 in [160, 192), the reference plume 1 in [40, 48) after 2)
FINISH_CASES = {
    "lat_f64_bs3": ("ensemble10k", "bs3", 100, 1248, 64, "fused", False,
                    {}, {}),
    "lat_equator_f64_dopri5": ("ensemble10k", "dopri5", 100, 560, 64,
                               "fused", False, {},
                               dict(stop_at_equator=1.0)),
    "colat_f64_bs3": ("ensemble10k", "bs3", 100, 1080, 80, "fused", False,
                      dict(frame="2d_colat"), {}),
    "3d_f64_bs3": ("ensemble10k_3d", "bs3", 100, 160, 32, "fused", False,
                   {}, {}),
    "plume_team_f64_dopri5": ("ensemble10k_plume", "dopri5", 100, 160, 32,
                              "fused", False, {}, {}),
    "ad_lat_f64_bs3": ("ensemble10k", "bs3", 100, 1248, 64, "autodiff",
                       False, {}, {}),
    "altx_plume_ref_f64_bs3": ("ensemble10k_plume", "bs3", 100, 40, 8,
                               "reference", False, {}, {}),
}


def _carry_of(got):
    """A RayCarry of the host build's output fields."""
    return RayCarry(**{k: torch.from_numpy(np.array(got[k]))
                       for k in RayCarry._fields})


@pytest.mark.parametrize("case", sorted(FINISH_CASES))
def test_finish_and_fresh_match_plain_version_on_the_host(host_kernel,
                                                          case):
    """A launch with finish and fresh (the one-thread body, and for the
    plume the team body against it bit for bit) on a carry that the host
    build stepped m attempts, checked twice:

    - the epilogue alone: against the same launch with fresh only, every
      field but u and t of the refined rays bit for bit, and u and t equal
      to refine_events on that launch's carry within 1e-9 of their
      components' scale (the two math libraries, the host's libm and
      torch's, reach ~1e-13 in k0 = rhs(u_prev), and a refined state may
      take the last of its 32 bisections the other way: 2^-32 of its
      step), r = r_floor (or the latitude 0) to 1e-9 at the crossing;
    - the whole launch against the plain path that trace ran before
      (k1 = rhs(u), init_carry's; step_chunk_reference; refine_events):
      statuses and counters equal, and the refined rays' u and t, as the
      ALT cases above hold states after 8 attempts, within 1e-6 or the
      plain version's own spread from the same carry with every state
      component one ulp up (the rays that go on stepping are the step
      loop's, held above: over n attempts the two math libraries alone
      move a colatitude ray 1e-5 and its dt 4e-3, flags or none).

    Every fan has rays refined at entry and rays that land inside the
    launch."""
    (name, stepper, every, m, n, grad_mode, legacy, over,
     stop) = FINISH_CASES[case]
    conf = preset(name, dtype="float64", **over)
    env = conf.medium.build()
    u0, f = _build_u0(conf, env, np.float64, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::every]), torch.as_tensor(f[::every])
    cfg, spec = conf.solver(), conf.stop()._replace(**stop)
    kw = dict(frame=conf.frame, root=conf.root, adaptive=conf.adaptive,
              grad_mode=grad_mode, legacy_freq_state=legacy)
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env, conf.root, grad_mode,
                               legacy)[0]
    codes = [sc._STEPPER_CODE[stepper], sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg, grad_mode, legacy), sc.field_code(env)]
    params = sc._params(env, cfg, spec, conf.root, grad_mode, legacy)
    mid, _ = _host_run(host_kernel, case, init_carry(rhs_fn, u0, f, cfg), f,
                       codes, m, params)
    mid = _carry_of(mid)
    blank = mid._replace(k1=torch.full_like(mid.k1, np.nan))
    got, stats = _host_run(host_kernel, case, blank, f, codes, n, params,
                           flags=3)
    assert stats["differ"] == 0
    assert stats["team_warps"] == (4 if "team" in case else 0)
    event = events.HIT_EQUATOR if stop else events.HIT_EARTH
    before = mid.status.numpy() == event
    assert before.any() and ((got["status"] == event) & ~before).any()
    # the rays the epilogue refines (HIT_EARTH also under the equator stop)
    after = (got["status"] == events.HIT_EARTH) | (
        (got["status"] == events.HIT_EQUATOR) & bool(stop))

    # the epilogue against refine_events on the launch's own carry
    unref, stats = _host_run(host_kernel, case, blank, f, codes, n, params,
                             flags=2)
    assert stats["differ"] == 0
    for k in _ORDER:
        if k not in ("u", "t"):
            np.testing.assert_array_equal(got[k], unref[k], err_msg=k)
    np.testing.assert_array_equal(got["u"][~after], unref["u"][~after])
    np.testing.assert_array_equal(got["t"][~after], unref["t"][~after])
    want = refine_events(rhs_fn, _carry_of(unref), f, spec)
    for k in ("u", "t"):
        w = getattr(want, k).numpy()
        scale = np.maximum(np.abs(w).max(axis=0), 1e-300)
        assert float(np.max(np.abs(got[k] - w) / scale)) <= 1e-9, k
    hit = got["status"] == events.HIT_EARTH
    np.testing.assert_allclose(got["u"][hit, 0], spec.r_floor, atol=1e-9)
    eq = got["status"] == events.HIT_EQUATOR
    lat = spec.lat_sign * got["u"][eq, 1] + spec.lat_offset
    np.testing.assert_allclose(lat, 0.0, atol=1e-9)

    # the whole launch against the plain path
    def plain(carry):
        carry = sc.step_chunk_reference(carry._replace(
            k1=rhs_fn(carry.u, f)), f, env, cfg, spec, stepper=stepper,
            n_steps=n, **kw)
        return refine_events(rhs_fn, carry, f, spec)

    ref = plain(mid)
    nudged = plain(mid._replace(
        u=torch.nextafter(mid.u, torch.full_like(mid.u, np.inf))))
    for k in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(),
                                      err_msg=k)
    for k in ("u", "t"):
        w = getattr(ref, k).numpy()
        scale = np.maximum(np.abs(w).max(axis=0), 1e-300)
        spread = np.abs(getattr(nudged, k).numpy() - w)[after] / scale
        err = float(np.max(np.abs(got[k] - w)[after] / scale))
        assert err <= max(1e-6, float(np.max(spread))), (k, err)


@pytest.mark.parametrize("case", ["lat_f64", "3d_f64", "plume_team_f64",
                                  "plume_team_f32", "tilted_team_f32",
                                  "igrf_team_f32"])
def test_fresh_forms_init_carry_k1_on_the_host(host_kernel, case):
    """A launch of 0 attempts with fresh: k1 = rhs(u) for every ray, the
    team body bit for bit with the one-thread body, and every field within
    1e-13 of init_carry's carry (float64: the two math libraries in one
    right-hand side) or 1e-5 (float32)."""
    name = {"lat": "ensemble10k", "3d": "ensemble10k_3d",
            "plume": "ensemble10k_plume", "tilted": "ensemble10k_tilted",
            "igrf": "ensemble10k_igrf"}[case.split("_")[0]]
    dtype = "float32" if case.endswith("f32") else "float64"
    conf = preset(name, dtype=dtype)
    env = conf.medium.build()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::97]), torch.as_tensor(f[::97])
    cfg, spec = conf.solver(), conf.stop()
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env, conf.root)[0]
    codes = [sc._STEPPER_CODE["bs3"], sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg), sc.field_code(env)]
    want = init_carry(rhs_fn, u0, f, cfg)
    # over the non-axial fields the team body in the tail layout (flag 4)
    layout = 4 if case.startswith(("tilted", "igrf")) else 0
    got, stats = _host_run(host_kernel, case, init_carry(None, u0, f, cfg),
                           f, codes, 0, sc._params(env, cfg, spec, conf.root),
                           flags=2 | layout)
    assert stats["differ"] == 0 and stats["attempts"] == 0
    assert stats["team_warps"] == (4 if "team" in case else 0)
    tol = 1e-5 if dtype == "float32" else 1e-13
    for k in RayCarry._fields:
        w = getattr(want, k).numpy()
        if k != "k1":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            w = w.astype(np.float64)
            scale = np.maximum(np.abs(w).max(axis=0), 1e-300)
            assert float(np.max(np.abs(got[k] - w) / scale)) <= tol


# The main path's float32 bs3 instances of the 2D frames (the kernel's
# chain_instance: the stage loop and the tail layout) against the
# reference build, where every instance runs the unrolled stages in the
# dense layout: (preset overrides, every k-th ray, m, n) --
# m attempts from the launch carry with fresh, then n with finish and
# fresh, where some of the rays land (the host build's census of every
# 40th ray of the float32 fans: lat 11 land in [840, 904) after 13
# before, colat 3 in [1344, 1408) after 8)
CHAIN_CASES = {
    "lat": ({}, 40, 840, 64),
    "colat": (dict(frame="2d_colat"), 40, 1344, 64),
}


@pytest.mark.parametrize("layout", ["dense", "tail"])
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_redesigned_chain_matches_the_unrolled_body_on_the_host(host_kernel,
                                                               case, layout):
    """bs3's three stages through one inlined right-hand side (the stage
    loop) and the tail layout (one ray a warp, flag bit 4) give every
    field bit for bit what the unrolled stages give in the dense layout, on float32 carries of the
    port's CPU path in the latitude and colatitude frames: a launch of m
    attempts with fresh, then one of n with finish and fresh, in which
    rays land and are refined. The double sibling keeps the dense layout."""
    over, every, m, n = CHAIN_CASES[case]
    conf = preset("ensemble10k", **over)
    env = conf.medium.build()
    u0, f = _build_u0(conf, env, np.float32, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::every]), torch.as_tensor(f[::every])
    cfg, spec = conf.solver(), conf.stop()
    codes = [sc._STEPPER_CODE["bs3"], sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg), sc.field_code(env)]
    params = sc._params(env, cfg, spec, conf.root)
    tail = sc.launch_flags(f.shape[0], layout=layout == "tail")
    assert tail == (4 if layout == "tail" else 0)
    mid, stats = _host_run(host_kernel, f"chain_{case}_{layout}",
                           init_carry(None, u0, f, cfg), f, codes, m, params,
                           flags=2 | tail)
    assert stats["differ"] == 0 and stats["tail_layout"] == 1
    assert stats["attempts"] > m * f.shape[0] // 2
    mid = _carry_of(mid)
    got, stats = _host_run(host_kernel, f"chain_{case}_{layout}", mid, f,
                           codes, n, params, flags=3 | tail)
    assert stats["differ"] == 0
    landed = (got["status"] == events.HIT_EARTH) & (
        mid.status.numpy() == events.ACTIVE)
    assert landed.any()
    np.testing.assert_allclose(got["u"][landed, 0], spec.r_floor, atol=1e-5)
    _, stats = _host_run(host_kernel, f"chain_{case}_{layout}_f64",
                         init_carry(None, u0.double(), f.double(), cfg),
                         f.double(), codes, 8, params, flags=2 | tail,
                         out=False)
    assert stats["differ"] == 0 and stats["tail_layout"] == 0


# The group body of the bs3 AD instances (csrc/step_chunk.cu,
# group_instance: G lanes a ray, each lane with its tangent rows of the dual
# chain, the rows exchanged by __shfl_sync) against the second build's
# one-thread AD body: (preset, legacy_freq_state, dtype). ensemble10k (with
# and without the 2D frequency read as f + T) and ensemble10k_local (the
# local ceiling) take the 2D latitude instance (G = 4) in float32 and
# float64, ensemble10k_tilted the tilted dipole's (float32, G = 8, the
# eighth lane seeding no input) and ensemble10k_3d the 3D dipole's
# (float64, G = group_lanes)
GROUP_CASES = {
    "lat": ("ensemble10k", False, "float32"),
    "lat_legacy": ("ensemble10k", True, "float32"),
    "local": ("ensemble10k_local", False, "float32"),
    "tilted": ("ensemble10k_tilted", False, "float32"),
    "lat_f64": ("ensemble10k", False, "float64"),
    "local_f64": ("ensemble10k_local", False, "float64"),
    "3d_f64": ("ensemble10k_3d", False, "float64"),
}
# the instances with a group body, by their codes (dtype, stepper, frame,
# medium, field), and the group's lanes a ray
_GROUP_INSTANCES = {
    (0, 0, 0, sc.AD, 0): 4,   # float32 bs3 2d_lat AD
    (0, 0, 1, sc.AD, 1): 8,   # float32 bs3 3d AD, tilted dipole
    (1, 0, 0, sc.AD, 0): 4,   # float64 bs3 2d_lat AD
    (1, 0, 1, sc.AD, 0): 8,   # float64 bs3 3d AD, dipole
}


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_body_matches_the_one_thread_ad_body_on_the_host(
        host_kernel, case, fresh):
    """45 rays spread over the fan (not a multiple of the group's lanes or
    of 32: the last warp and block are partly filled; every 7th ray
    stopped at entry, which with fresh forms its k1 and no attempt and
    without it leaves at once) x 96 attempts, with fresh (k1 = rhs(u)
    first, through the group body's right-hand side too) or from
    init_carry's carry, through the group body (flag bit 8) of the build
    as it stands and the one-thread AD body of the second build: every
    field bit for bit, in float32 and float64."""
    name, legacy, dtype = GROUP_CASES[case]
    conf = preset(name, grad_mode="autodiff", dtype=dtype)
    env = conf.medium.build()
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = _build_u0(conf, env, np_dt, torch.device("cpu"))
    u0, f = torch.as_tensor(u0[::230]), torch.as_tensor(f[::230])
    assert f.shape[0] == 45
    cfg, spec = conf.solver(), conf.stop()
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env, conf.root, "autodiff",
                               legacy)[0]
    carry = init_carry(None if fresh else rhs_fn, u0, f, cfg)
    status = carry.status.clone()
    status[::7] = events.MAX_PHASE_TIME
    carry = carry._replace(status=status)
    codes = [sc._STEPPER_CODE["bs3"], sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg, "autodiff", legacy), sc.field_code(env)]
    assert codes[2] == sc.AD
    key = (int(dtype == "float64"), *codes)
    params = sc._params(env, cfg, spec, conf.root, "autodiff", legacy)
    flags = sc.launch_flags(f.shape[0], fresh=fresh, group=key)
    assert flags == 2 * fresh | 8
    got, stats = _host_run(host_kernel, f"group_{case}_{fresh}", carry, f,
                           codes, 96, params, flags=flags)
    assert stats["group_lanes"] == _GROUP_INSTANCES[key]
    assert stats["thread_group_lanes"] == 0 and stats["team_warps"] == 0
    assert stats["differ"] == 0
    live = int((carry.status == 0).sum())
    assert 48 * live <= stats["attempts"] <= 96 * live
    assert np.isfinite(got["k1"]).all() and np.isfinite(got["u"]).all()


def test_wrapper_takes_the_group_body_for_exactly_its_instances(
        host_kernel, monkeypatch):
    """step_chunk_group_lanes names exactly the four instances (the bs3 AD
    ones of the 2D latitude frame in float32 and float64 and of the 3D
    frame over the tilted dipole in float32 and over the dipole in
    float64), with their lanes a ray, and launch_flags sets the group
    body's bit 8 only on them, up to GROUP_MAX_RAYS rays for each
    instance's codes: every float32 2D launch, up to one wave of 6,336
    rays over the tilted dipole, up to 8,448 rays in float64 (one wave in
    2D, two in 3D); never the tail layout's bit 4; finish and fresh keep
    bits 1 and 2."""
    out = subprocess.run([str(host_kernel / "kernel_host"), "--group-lanes"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    rows = [tuple(map(int, line.split())) for line in out.stdout.split("\n")
            if line]
    assert len(rows) == 2 * 3 * 3 * 8 * 3
    named = {r[:5]: r[5] for r in rows if r[5]}
    lat = (0, sc._STEPPER_CODE["bs3"], sc._FRAME_CODE["2d_lat"][0], sc.AD,
           sc._FIELD_CODE["dipole"])
    tilted = (0, sc._STEPPER_CODE["bs3"], sc._FRAME_CODE["3d"][0], sc.AD,
              sc._FIELD_CODE["tilted"])
    lat64 = (1, *lat[1:])
    dipole64 = (1, sc._STEPPER_CODE["bs3"], sc._FRAME_CODE["3d"][0], sc.AD,
                sc._FIELD_CODE["dipole"])
    assert named == _GROUP_INSTANCES
    assert set(named) == {lat, tilted, lat64, dipole64}
    top, top64 = 6336, 8448
    assert sc.GROUP_MAX_RAYS == {lat: 2 ** 31 - 1, tilted: top,
                                 lat64: top64, dipole64: top64}
    for b in (1, 45, 256, 2112, top, top + 1, top64, top64 + 1, 10240):
        for key, limit in sc.GROUP_MAX_RAYS.items():
            want = 8 * (b <= limit)
            assert sc.launch_flags(b, group=key) == want, (b, key)
            assert sc.launch_flags(b, finish=True, fresh=True,
                                   group=key) == 3 | want
            # layout and limit are the other instances' (tail_layout)
            assert sc.launch_flags(b, layout=True, limit=10 ** 9,
                                   group=key) == want
        assert sc.launch_flags(b) & 8 == 0
        assert sc.launch_flags(b, layout=True) & 8 == 0
    assert sc.launch_flags(0, group=lat) == 0
    monkeypatch.setattr(sc, "GROUP_MAX_RAYS",
                        {k: 0 for k in sc.GROUP_MAX_RAYS})
    for key in _GROUP_INSTANCES:
        assert sc.launch_flags(45, group=key) == 0
