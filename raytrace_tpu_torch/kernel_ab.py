"""The step kernel of this checkout against another checkout's, on one card.

    python -m raytrace_tpu_torch.kernel_ab --against DIR [--n 512] [--reps 20]
        [--presets ensemble10k,ensemble10k_3d]

DIR is the root of another checkout of the repository (for example an
earlier commit unpacked with `git archive` into a directory that
.gitignore lists). Each checkout builds its own csrc/step_chunk.cu (both
builds at once, each cached in its checkout's _build/); then the two are
timed in turns, other / this / this / other, one process per turn, over
the launches of `--presets`, all rays x n attempts, float32 and float64,
bs3 and dopri5. The default is the axisymmetric launches that every
checkout of the port serves, ensemble10k (2D) and ensemble10k_3d (3D):
the eight instances that serve the axisymmetric medium; any preset that
both checkouts serve can be named (ensemble10k_plume, ensemble10k_tilted,
...). A time is the mean of `reps` launches between two CUDA events
after a warm-up launch. Prints each checkout's registers and spills
(-Xptxas -v), one line per instance with the two turns of each side and
the ratio of the means, and a JSON record as the last line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

DEFAULT_PRESETS = "ensemble10k,ensemble10k_3d"
_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(_HERE))


def _instances(presets):
    return [(name, dt, st) for name in presets.split(",")
            for dt in ("float32", "float64") for st in ("bs3", "dopri5")]


def _child(root, mode, n, reps, presets):
    """Runs in a process of its own with `root`'s package on the path (and
    not this file's directory, which Python put first)."""
    here = os.path.dirname(_HERE)
    sys.path[:] = [root] + [q for q in sys.path
                            if os.path.abspath(q or ".") != here]
    import numpy as np
    import torch

    import raytrace_tpu_torch
    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate.solve import init_carry
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.run import _build_u0

    assert raytrace_tpu_torch.__file__.startswith(root), \
        raytrace_tpu_torch.__file__
    if mode == "build":
        sc.build()
        print(json.dumps({"build_s": sc.BUILD_SECONDS, "log": sc.BUILD_LOG}))
        return
    dev = torch.device("cuda")
    times = {}
    for name, dt, st in _instances(presets):
        conf = preset(name, dtype=dt)
        env = conf.medium.build()
        np_dt = np.float32 if dt == "float32" else np.float64
        u0, f = _build_u0(conf, env, np_dt, dev)
        u0, f = torch.as_tensor(u0).to(dev), torch.as_tensor(f).to(dev)
        rhs_fn, _ = rhs_mod.frame_rhs(conf.frame, env)
        cfg, spec = conf.solver(), conf.stop()
        carry = init_carry(rhs_fn, u0, f, cfg)

        def launch():
            return sc.step_chunk(carry, f, env, cfg, spec, stepper=st,
                                 n_steps=n, frame=conf.frame)

        launch()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            launch()
        e1.record()
        torch.cuda.synchronize()
        times[" ".join((name, dt, st))] = e0.elapsed_time(e1) / reps
    print(json.dumps({"ms": times}))


def _run(root, mode, args, wait=True):
    proc = subprocess.Popen(
        [sys.executable, _HERE, "--child", root, "--mode", mode,
         "--n", str(args.n), "--reps", str(args.reps),
         "--presets", args.presets],
        stdout=subprocess.PIPE, text=True)
    if not wait:
        return proc
    return _result(proc, root)


def _result(proc, root):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the child for {root} failed "
                           f"(rc {proc.returncode}):\n{out}")
    return json.loads(out.strip().splitlines()[-1])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--against", help="root of the other checkout")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--presets", default=DEFAULT_PRESETS,
                   help="comma-separated presets that both checkouts serve")
    p.add_argument("--child", help=argparse.SUPPRESS)
    p.add_argument("--mode", default="time", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        _child(os.path.abspath(args.child), args.mode, args.n, args.reps,
               args.presets)
        return 0
    if not args.against:
        p.error("--against DIR is required")
    from .ops.step_chunk import ptxas_usage

    roots = {"this": _ROOT, "other": os.path.abspath(args.against)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi} (nvidia-smi)", flush=True)
    t0 = time.perf_counter()
    procs = {k: _run(r, "build", args, wait=False) for k, r in roots.items()}
    builds = {k: _result(procs[k], roots[k]) for k in roots}
    print(f"both built in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, b in builds.items():
        b["registers"] = ptxas_usage(b.pop("log"))
        print(f"{k} ({roots[k]}): nvcc {b['build_s']:.1f} s")
        for inst, use in b["registers"].items():
            print(f"  {inst}: {use}")
    turns = {"this": [], "other": []}
    for k in ("other", "this", "this", "other"):
        turns[k].append(_run(roots[k], "time", args)["ms"])
        print(f"turn {len(turns['this']) + len(turns['other'])} ({k}) done",
              flush=True)
    record = {}
    print(f"{args.n} attempts over each preset's rays, mean of {args.reps} "
          f"launches; turns in order other, this, this, other; {smi}")
    for inst in (" ".join(i) for i in _instances(args.presets)):
        a = [t[inst] for t in turns["this"]]
        b = [t[inst] for t in turns["other"]]
        ratio = (sum(a) / 2) / (sum(b) / 2)
        record[inst] = {"this_ms": a, "other_ms": b, "ratio": ratio}
        print(f"  {inst:32s} this {a[0]:8.3f} {a[1]:8.3f}  other "
              f"{b[0]:8.3f} {b[1]:8.3f}  this/other {ratio:.4f}")
    print(json.dumps({"card": smi, "n": args.n, "reps": args.reps,
                      "registers": {k: b["registers"]
                                    for k, b in builds.items()},
                      "instances": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
