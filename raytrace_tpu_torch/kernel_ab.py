"""The step kernel of this checkout against another checkout's, on one card.

    python -m raytrace_tpu_torch.kernel_ab --against DIR [--n 512] [--reps 20]
        [--presets ensemble10k,ensemble10k_3d]
        [--tails mr_fan_3d,ensemble10k_plume:float64,...]
        [--grad-mode autodiff]

DIR is the root of another checkout of the repository (for example an
earlier commit unpacked with `git archive` into a directory that
.gitignore lists). Each checkout builds its own csrc/step_chunk.cu (both
builds at once, each cached in its checkout's _build/); then the two are
timed in turns, other / this / this / other, one process per turn, over
the launches of `--presets`, all rays x n attempts, float32 and float64,
bs3, dopri5 and rk4 (the preset at fixed steps of its dt0). The default is the axisymmetric launches that every
checkout of the port serves, ensemble10k (2D) and ensemble10k_3d (3D):
the twelve instances that serve the axisymmetric medium; any preset that
both checkouts serve can be named (ensemble10k_plume, ensemble10k_tilted,
...; "none" names none). A time is the mean of `reps` launches between
two CUDA events after a warm-up launch. `--grad-mode` ("fused" by
default, "reference" or "autodiff") is the gradient set of every launch,
the presets' and the tails': "autodiff" times the AD instances.

Tail mode (`--tails`): each named preset's merged-tail launch, the carry
that the rounds tracer hands its last round (a few rays padded to the
bucket it runs at, most of a long-tailed run's wall), is captured once on
the card by this checkout's run.run and replayed by both checkouts in the
same turns, `--tail-reps` launches each. Prints each checkout's registers
and spills (-Xptxas -v), one line per launch with the two turns of each
side and the ratio of the means, and a JSON record as the last line.
"""

import contextlib
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

DEFAULT_PRESETS = "ensemble10k,ensemble10k_3d"
_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(_HERE))


def _instances(presets):
    if presets in ("", "none"):
        return []
    return [(name, dt, st) for name in presets.split(",")
            for dt in ("float32", "float64")
            for st in ("bs3", "dopri5", "rk4")]


@contextlib.contextmanager
def recording_launches():
    """Within the block every step_chunk call (from trace, the rounds
    tracer, run.run) is recorded as (carry, f, env, cfg, spec, kw) in the
    list it yields, in call order; the launch counts go on as before."""
    from raytrace_tpu_torch.ops import step_chunk as sc

    orig, seen = sc.step_chunk, []

    def record(carry, f, env, cfg, spec, **kw):
        seen.append((carry, f, env, cfg, spec, kw))
        return orig(carry, f, env, cfg, spec, **kw)

    # orig counts its launches on the module's `step_chunk`: this wrapper
    # while it stands in
    record.launches = orig.launches
    record.team_launches = orig.team_launches
    sc.step_chunk = record
    try:
        yield seen
    finally:
        sc.step_chunk = orig
        orig.launches = record.launches
        orig.team_launches = record.team_launches


def capture_tail(name, path=None, grad_mode="fused"):
    """Run preset `name` ("preset" or "preset:float64"; float32 by
    default) through run.run on the card and return its last launch, the
    merged tail, as a dict: the carry's fields and f (on the card), the
    launch's keywords, cfg and spec as dicts, and the last round's record
    (active rays, bucket, attempts); saved with torch.save to `path` when
    given."""
    import torch

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.run import run

    base, _, dtype = name.partition(":")
    with recording_launches() as seen:
        out = run(preset(base, dtype=dtype or "float32",
                         grad_mode=grad_mode), device="cuda")
    carry, f, _env, cfg, spec, kw = seen[-1]
    # the keywords of the reference scripts' modes only where they are on,
    # so that a checkout from before them replays the tail too
    kw = {k: v for k, v in kw.items()
          if (k, v) not in (("grad_mode", "fused"),
                            ("legacy_freq_state", False))}
    tail = dict(name=base, carry=carry._asdict(), f=f, kw=kw,
                cfg=cfg._asdict(), spec=spec._asdict(),
                round=dict(out["rounds"][-1]))
    if path:
        torch.save(tail, path)
    return tail


def replay_tail(tail, reps, env=None):
    """Mean ms of `reps` launches of a captured tail (CUDA events, after a
    warm-up launch), over `env` or its preset's medium, with the attempts
    the warm-up made over its real rays and its carry."""
    import torch

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import RayCarry, SolverConfig
    from raytrace_tpu_torch.ops import step_chunk as sc

    if env is None:
        env = preset(tail["name"]).medium.build()
    carry = RayCarry(**tail["carry"])
    cfg, spec = SolverConfig(**tail["cfg"]), StopSpec(**tail["spec"])
    f, kw = tail["f"], tail["kw"]
    out = sc.step_chunk(carry, f, env, cfg, spec, **kw)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        sc.step_chunk(carry, f, env, cfg, spec, **kw)
    e1.record()
    torch.cuda.synchronize()
    real = tail["round"]["active"]
    made = ((out.n_accept + out.n_reject)
            - (carry.n_accept + carry.n_reject))[:real]
    return dict(ms=e0.elapsed_time(e1) / reps, rays=real,
                bucket=int(f.shape[0]), attempts=int(made.sum()),
                longest=int(made.max()), out=out)


def _child(root, mode, n, reps, presets, tails=None, tail_reps=3,
           grad_mode="fused"):
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
    if mode == "capture":
        meta = {}
        for name, path in tails.items():
            tail = capture_tail(name, path, grad_mode)
            meta[name] = dict(tail["round"], kw=tail["kw"])
        print(json.dumps(meta))
        return
    dev = torch.device("cuda")
    times = {}
    for name, path in (tails or {}).items():
        tail = torch.load(path, weights_only=False)
        t = replay_tail(tail, tail_reps)
        times[f"{name} tail"] = t["ms"]
        times[f"{name} tail attempts"] = [t["rays"], t["bucket"],
                                          t["attempts"], t["longest"]]
    for name, dt, st in _instances(presets):
        # rk4: the preset at fixed steps (adaptive=False) of its dt0
        conf = preset(name, dtype=dt,
                      **({"adaptive": False} if st == "rk4" else {}))
        env = conf.medium.build()
        np_dt = np.float32 if dt == "float32" else np.float64
        u0, f = _build_u0(conf, env, np_dt, dev)
        u0, f = torch.as_tensor(u0).to(dev), torch.as_tensor(f).to(dev)
        # the gradient set only where it is not the default, so that a
        # checkout from before it times the presets too
        modes = {} if grad_mode == "fused" else {"grad_mode": grad_mode}
        rhs_fn, _ = rhs_mod.frame_rhs(conf.frame, env, conf.root, **modes)
        cfg, spec = conf.solver(), conf.stop()
        carry = init_carry(rhs_fn, u0, f, cfg)

        def launch():
            return sc.step_chunk(carry, f, env, cfg, spec,
                                 stepper="bs3" if st == "rk4" else st,
                                 n_steps=n, frame=conf.frame,
                                 adaptive=conf.adaptive, root=conf.root,
                                 **modes)

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
         "--presets", args.presets, "--tail-reps", str(args.tail_reps),
         "--tail-dir", args.tail_dir, "--tails", args.tails,
         "--grad-mode", args.grad_mode],
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
    p.add_argument("--tails", default="",
                   help="comma-separated presets whose merged tail is "
                        "replayed")
    p.add_argument("--tail-reps", type=int, default=3)
    p.add_argument("--grad-mode", default="fused",
                   choices=("fused", "reference", "autodiff"),
                   help="the gradient set of every launch")
    p.add_argument("--child", help=argparse.SUPPRESS)
    p.add_argument("--mode", default="time", help=argparse.SUPPRESS)
    p.add_argument("--tail-dir", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    tails = [t for t in args.tails.split(",") if t]
    if args.child:
        _child(os.path.abspath(args.child), args.mode, args.n, args.reps,
               args.presets,
               {t: os.path.join(args.tail_dir, f"{t}.pt") for t in tails},
               args.tail_reps, args.grad_mode)
        return 0
    if not args.against:
        p.error("--against DIR is required")
    from .ops.step_chunk import ptxas_usage

    args.tail_dir = tempfile.mkdtemp(prefix="kernel_ab_tails_")

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
    tail_meta = _run(roots["this"], "capture", args) if tails else {}
    for name, meta in tail_meta.items():
        print(f"{name} tail: {meta['active']} rays in a bucket of "
              f"{meta['bucket']}, {meta['steps']} steps, {meta['attempted']} "
              f"attempts made", flush=True)
    turns = {"this": [], "other": []}
    for k in ("other", "this", "this", "other"):
        turns[k].append(_run(roots[k], "time", args)["ms"])
        print(f"turn {len(turns['this']) + len(turns['other'])} ({k}) done",
              flush=True)
    record = {}
    print(f"{args.n} attempts over each preset's rays, mean of {args.reps} "
          f"launches, grad_mode {args.grad_mode}; turns in order other, "
          f"this, this, other; {smi}")
    for inst in ([f"{t} tail" for t in tails]
                 + [" ".join(i) for i in _instances(args.presets)]):
        a = [t[inst] for t in turns["this"]]
        b = [t[inst] for t in turns["other"]]
        ratio = (sum(a) / 2) / (sum(b) / 2)
        record[inst] = {"this_ms": a, "other_ms": b, "ratio": ratio}
        print(f"  {inst:32s} this {a[0]:8.3f} {a[1]:8.3f}  other "
              f"{b[0]:8.3f} {b[1]:8.3f}  this/other {ratio:.4f}")
    shutil.rmtree(args.tail_dir, ignore_errors=True)
    print(json.dumps({"card": smi, "n": args.n, "reps": args.reps,
                      "grad_mode": args.grad_mode,
                      "registers": {k: b["registers"]
                                    for k, b in builds.items()},
                      "tails": {t: dict(tail_meta[t], replay=turns["this"][0][
                          f"{t} tail attempts"]) for t in tails},
                      "instances": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
