#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (raytrace_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it runs; any failed check exits non-zero:
  1. the card (nvidia-smi name and power limit), CUDA version, and the
     build of the step kernel (csrc/step_chunk.cu) from the checkout;
  2. the kernel against its plain PyTorch version on the same carries:
     every 10th ray of the ensemble10k launch, float64 (1 and 256 steps)
     and float32 (1 step, all 10,240 rays), bs3 and dopri5; then both
     timed at 10,240 rays x 512 steps (float32, bs3);
  3. the canonical RayTrace_lat ray in float64 through the kernel;
  4. the ensemble10k slice through raytrace_tpu_torch.run.run on the
     card, float32, checked against the float32 physics record of the JAX
     package (benchmarks/perf_r03b.json, auto_bs3_1x, measured on a TPU);
     then in float64, checked against the JAX package's float64 result on
     a CPU, and float32 against float64.
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. It imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

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


def check(ok, what):
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        sys.exit(1)


def rel_err(a, b):
    """Relative error of a against b: elementwise for per-ray scalars,
    and for (B, 4) state vectors per component against the component's
    largest magnitude over the batch (a component that cancels to near
    zero, e.g. dchi/dt at a turning point, has no meaningful elementwise
    relative error). Returns the per-ray worst value."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tiny = np.finfo(np.float64).tiny
    if a.ndim == 1:
        return np.abs(a - b) / np.maximum(np.abs(b), tiny)
    scale = np.maximum(np.abs(b).max(axis=0, initial=0.0), tiny)
    return (np.abs(a - b) / scale).max(axis=1)


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
        RayCarry, SolverConfig, init_carry, trace,
    )
    from raytrace_tpu_torch.models.medium import make_env_lat
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.parallel.ensemble import build_launch
    from raytrace_tpu_torch.run import run, summarize

    dev = torch.device("cuda")

    # ---- 1. card and build ------------------------------------------------
    print("[1] card and build", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi)"
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sc.build()
    print(f"  step kernel built and loaded in {time.perf_counter() - t0:.1f} s"
          f" (nvcc {sc.BUILD_SECONDS:.1f} s)")
    for line in sc.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())

    # ---- 2. kernel vs plain PyTorch on the card ---------------------------
    print("[2] step kernel vs plain PyTorch", flush=True)
    env = make_env_lat()
    rhs_fn = lambda u, ff: rhs_mod.rhs_2d_lat(u, ff, env)  # noqa: E731
    ens = preset("ensemble10k")
    spec = ens.stop()

    def start(dtype_name, every=1):
        cfg = preset("ensemble10k", dtype=dtype_name).solver()
        np_dt = np.float32 if dtype_name == "float32" else np.float64
        u0, f = build_launch(ens.launch(), np_dt)
        u0 = torch.as_tensor(u0[::every]).to(dev)
        f = torch.as_tensor(f[::every]).to(dev)
        return init_carry(rhs_fn, u0, f, cfg), f, cfg

    def both(carry, f, cfg, stepper, n):
        got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper,
                            n_steps=n)
        ref = sc.step_chunk_reference(carry, f, env, cfg, spec,
                                      stepper=stepper, n_steps=n)
        torch.cuda.synchronize()
        host = lambda c: {k: getattr(c, k).cpu().numpy()  # noqa: E731
                          for k in RayCarry._fields}
        return host(got), host(ref)

    max_abs_err = 0.0
    for stepper in ("bs3", "dopri5"):
        carry, f, cfg = start("float64", every=10)
        got, ref = both(carry, f, cfg, stepper, 1)
        ints = [k for k in RayCarry._fields if got[k].dtype.kind == "i"]
        check(all(np.array_equal(got[k], ref[k]) for k in ints),
              f"float64 {stepper} 1 step, {f.shape[0]} rays: "
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
              f"float64 {stepper} 1 step: every field within rtol 1e-12")

        # a ray agrees when its status and step counters are identical and
        # its u, t, dt are within rtol 1e-9; rays that take a borderline
        # accept/reject the other way, or whose trajectory amplifies the
        # last-ulp differences (the cancelling error estimate feeds them
        # into dt), are counted, not failed, as the JAX package's own
        # on-chip Pallas check records (benchmarks/pallas_on_chip.py)
        got, ref = both(carry, f, cfg, stepper, 256)
        same = np.ones(f.shape[0], bool)
        for name in ("status", "n_accept", "n_reject"):
            same &= got[name] == ref[name]
        err = np.max([rel_err(got[k], ref[k]) for k in ("u", "t", "dt")],
                     axis=0)
        agree = same & (err <= 1e-9)
        print(f"  float64 {stepper} 256 steps, {f.shape[0]} rays: "
              f"{int((~same).sum())} took another accept/reject path, "
              f"{int((same & ~agree).sum())} more differ by > 1e-9; median "
              f"rel err of the rest {float(np.median(err[agree])):.2e}")
        check(agree.mean() >= 0.99,
              f"float64 {stepper} 256 steps: >= 99% of rays identical in "
              "status/n_accept/n_reject and within rtol 1e-9 in u, t, dt")

        carry, f, cfg = start("float32")
        got, ref = both(carry, f, cfg, stepper, 1)
        check(all(np.array_equal(got[k], ref[k])
                  for k in ("status", "n_accept", "n_reject")),
              f"float32 {stepper} 1 step, {f.shape[0]} rays: statuses and "
              "counters identical")
        worst = max(float(rel_err(got[k], ref[k]).max())
                    for k in ("u", "t", "dt", "k1"))
        check(worst <= 1e-5, f"float32 {stepper} 1 step: u, t, dt, k1 within "
                             f"rtol 1e-5 ({worst:.3e})")

    # the main path's first launch: all 10,240 rays x 2,048 steps, float32
    # bs3. The kernel rounds as its plain version does (no FMA
    # contraction, quotients by constants as reciprocal products, the
    # error norm summed in component order), so every field must agree
    # bit for bit
    carry, f, cfg = start("float32")
    got, ref = both(carry, f, cfg, "bs3", 2048)
    n_diff = sum(int((~np.equal(got[k], ref[k])
                      & ~(np.isnan(got[k]) & np.isnan(ref[k]))).sum())
                 for k in RayCarry._fields)
    max_abs_err = max(float(np.nanmax(np.abs(got[k].astype(np.float64)
                                             - ref[k])))
                      for k in RayCarry._fields)
    print(f"  float32 bs3, 10,240 rays x 2,048 steps (the first round's "
          f"launch): {int((got['status'] != 0).sum())} rays stopped, "
          f"{n_diff} values differ, max abs err {max_abs_err:.3e}")
    check(n_diff == 0, "main-path launch: kernel and plain version agree bit "
                       "for bit in every field")

    # timing at the main path's width: 10,240 rays x 512 steps, f32, bs3
    carry, f, cfg = start("float32")
    n_t = 512
    sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3", n_steps=n_t)
    torch.cuda.synchronize()
    reps = 5
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        sc.step_chunk(carry, f, env, cfg, spec, stepper="bs3", n_steps=n_t)
    e1.record()
    torch.cuda.synchronize()
    kernel_ms = e0.elapsed_time(e1) / reps
    e0.record()
    sc.step_chunk_reference(carry, f, env, cfg, spec, stepper="bs3",
                            n_steps=n_t)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    print(f"  10,240 rays x {n_t} steps, float32 bs3: kernel "
          f"{kernel_ms:.3f} ms, plain PyTorch {plain_ms:.1f} ms "
          f"({plain_ms / kernel_ms:.1f}x) on {card}")

    # ---- 3. canonical ray through the kernel, float64 ---------------------
    print("[3] canonical RayTrace_lat ray, float64, dopri5", flush=True)
    n0 = sc.step_chunk.launches
    u0 = torch.tensor([[(RE + 1.0e6) / RE, np.pi / 4, 0.0, 0.0]],
                      dtype=torch.float64, device=dev)
    res = trace(env, u0, torch.tensor([1000.0], dtype=torch.float64,
                                      device=dev),
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
    print("[4] ensemble10k through raytrace_tpu_torch.run.run, float32",
          flush=True)
    run(ens, device="cuda")                         # warm-up
    sc.step_chunk.launches = 0
    sc.step_chunk_reference.calls = 0
    t0 = time.perf_counter()
    out = run(ens, device="cuda")
    wall = time.perf_counter() - t0
    launches = sc.step_chunk.launches
    ref_calls = sc.step_chunk_reference.calls
    stats, valid = out["stats"], out["valid"]
    steps = int(stats["total_accepted_steps"] + stats["total_rejected_steps"])
    n_hit = int(stats["n_hit_earth"])
    med_l = float(stats["median_landing_l"])
    n_stiff = int(np.asarray(out["stiff"])[valid].sum())
    print(f"  {summarize(out['result'], valid)}")
    for r in out["rounds"]:
        print(f"   round: {r['stepper']:6s} active {r['active']:5d} bucket "
              f"{r['bucket']:5d} steps {r['steps']:5d} attempted "
              f"{r['attempted']:9d} wall {r['wall_s'] * 1e3:8.1f} ms")
    print(f"  step kernel launches {launches}, plain-version calls "
          f"{ref_calls}, rays on the stiff pool {n_stiff} (the TPU record "
          "expects 0, perf_r03l.json)")
    print(f"  float32: wall {wall:.4f} s, {steps} attempted ray-steps, "
          f"{steps / wall / 1e6:.2f}M ray-steps/s on {card}")
    check(launches > 0, "the slice stepped through the kernel")
    check(ref_calls == 0, "the plain version was not called")
    check(abs(n_hit - REC_HIT_EARTH) <= 0.01 * REC_HIT_EARTH,
          f"HIT_EARTH {n_hit} within 1% of the TPU record {REC_HIT_EARTH}")
    check(abs(steps - REC_STEPS) <= 0.05 * REC_STEPS,
          f"attempted steps {steps} within 5% of the TPU record {REC_STEPS}")
    check(abs(med_l - REC_MEDIAN_L) <= REC_MEDIAN_L_RTOL * REC_MEDIAN_L,
          f"median landing L {med_l:.6f} within {REC_MEDIAN_L_RTOL:g} of the "
          f"TPU record {REC_MEDIAN_L}")

    print("[4] ensemble10k, float64", flush=True)
    t0 = time.perf_counter()
    out64 = run(preset("ensemble10k", dtype="float64"), device="cuda")
    wall64 = time.perf_counter() - t0
    st64 = out64["stats"]
    steps64 = int(st64["total_accepted_steps"] + st64["total_rejected_steps"])
    med64 = float(st64["median_landing_l"])
    print(f"  {summarize(out64['result'], valid)}, median landing L "
          f"{med64:.15f}")
    print(f"  float64: wall {wall64:.4f} s, {steps64} attempted ray-steps, "
          f"{steps64 / wall64 / 1e6:.2f}M ray-steps/s on {card}")
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
    s32 = out["result"].status[valid]
    s64 = out64["result"].status[valid]
    match = s32 == s64
    hit = match & (s64 == events.HIT_EARTH)
    u32 = out["result"].u[valid].astype(np.float64)
    u64 = out64["result"].u[valid]
    L32 = u32[hit, 0] / np.cos(u32[hit, 1]) ** 2
    L64 = u64[hit, 0] / np.cos(u64[hit, 1]) ** 2
    med_rel = float(np.median(np.abs(L32 - L64) / L64))
    print(f"  float32 vs float64: {match.mean() * 100:.2f}% statuses match, "
          f"median relative landing-L error {med_rel:.3e} over "
          f"{int(hit.sum())} matched HIT_EARTH rays")
    check(match.mean() >= F32_F64_STATUS_MATCH,
          f"statuses match on >= {F32_F64_STATUS_MATCH:.0%} of rays")
    check(med_rel < F32_F64_MEDIAN_DL,
          f"median relative landing-L error < {F32_F64_MEDIAN_DL:g} (the JAX "
          "package's own: 2.18e-4)")

    print(json.dumps({"kernels": [{
        "name": "step_chunk",
        "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/step_chunk.cu",
        "replaces": "raytrace_tpu/ops/pallas_stepper.py:107",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
