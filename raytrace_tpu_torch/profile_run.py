"""Where the time of one run goes on the card.

    python -m raytrace_tpu_torch.profile_run <preset> [--float64] [--runs N]
        [--set field=value ...] [--against DIR]

Runs the preset once to warm up, then N times unprofiled (host clock
around each `run.run`, which ends with the results on the host), then
once under `torch.profiler` with CUDA activity. Prints the unprofiled
walls, the step kernel's device time per launch, the other device work
(count of kernels and their time), the device's busy time (the union of
all kernel intervals) and its idle share of the profiled wall, and the
card's name and power limit. --set overrides a field of the preset with
a Python literal or a bare word (e.g. --set frame=2d_colat, --set
adaptive=False). --against DIR (the root of another checkout, e.g. a
parent commit unpacked with `git archive` into a directory that
.gitignore lists) runs the same profile in turns, other / this / this /
other, one process each with that checkout's package on the path (each
builds its own kernel library into its own _build/ at first use).
Needs a CUDA device; it never runs on the CPU.
"""

import argparse
import ast
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_run(config, runs=5):
    """Returns dict(walls, profiled_wall, kernels, ...) of `config` run on
    the card (times in seconds and microseconds)."""
    from .run import run

    run(config, device="cuda")
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run(config, device="cuda")
        walls.append(time.perf_counter() - t0)
    return dict(walls=walls, **profiled(config))


def profiled(config):
    """One run of `config` on the card under torch.profiler with CUDA
    activity: dict(profiled_wall (s), step_us (each step-kernel launch),
    other_n and other_us (the other kernels), busy_us (the union of all
    kernel intervals))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .run import run

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(config, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    step = [e for e in kernels if "step_chunk_kernel" in e.name]
    other = [e for e in kernels if "step_chunk_kernel" not in e.name]
    span = lambda e: (e.time_range.start, e.time_range.end)  # noqa: E731
    return dict(
        profiled_wall=wall,
        step_us=[e.time_range.elapsed_us() for e in step],
        other_n=len(other),
        other_us=sum(e.time_range.elapsed_us() for e in other),
        busy_us=busy_us([span(e) for e in kernels]),
    )


def _literal(text):
    """A Python literal, or the text itself (a bare word is a string)."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raytrace_tpu_torch.profile_run")
    p.add_argument("preset")
    p.add_argument("--float64", action="store_true")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--set", action="append", default=[],
                   help="field=value: override a field of the preset (a "
                        "Python literal, or a bare word for a string)")
    p.add_argument("--against", help="root of another checkout: profile "
                                     "both in turns")
    args = p.parse_args(argv)
    if args.against:
        return _turns(args)

    import torch

    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    from .config import preset

    config = preset(args.preset, **{
        k: _literal(v) for k, v in (item.split("=", 1) for item in args.set)})
    if args.float64:
        config.dtype = "float64"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    r = profile_run(config, args.runs)
    step_ms = sum(r["step_us"]) / 1e3
    print(f"{args.preset} {' '.join(args.set)} {config.dtype} on {smi}")
    print("  unprofiled walls (s): "
          + ", ".join(f"{w:.4f}" for w in r["walls"]))
    print(f"  profiled wall {r['profiled_wall']:.4f} s")
    print(f"  step kernel: {len(r['step_us'])} launches, {step_ms:.2f} ms "
          "(" + ", ".join(f"{u / 1e3:.2f}" for u in r["step_us"]) + " ms)")
    print(f"  other device work: {r['other_n']} kernels, "
          f"{r['other_us'] / 1e3:.2f} ms")
    busy = r["busy_us"] / 1e6
    print(f"  device busy {busy * 1e3:.2f} ms, idle "
          f"{1 - busy / r['profiled_wall']:.1%} of the profiled wall")
    return 0


def _turns(args):
    """The profile of this checkout and of args.against in turns, other /
    this / this / other, each a process of its own from its root."""
    rest = [args.preset, "--runs", str(args.runs)]
    rest += ["--float64"] if args.float64 else []
    for item in args.set:
        rest += ["--set", item]
    roots = {"this": _ROOT, "other": os.path.abspath(args.against)}
    rc = 0
    for k in ("other", "this", "this", "other"):
        env = dict(os.environ, PYTHONPATH=roots[k])
        print(f"[{k}: {roots[k]}]", flush=True)
        rc |= subprocess.run(
            [sys.executable, "-m", "raytrace_tpu_torch.profile_run", *rest],
            cwd=roots[k], env=env).returncode
        sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
