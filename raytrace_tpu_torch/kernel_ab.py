"""The step kernel of this checkout against another checkout's, on one card.

    python -m raytrace_tpu_torch.kernel_ab --against DIR [--n 512] [--reps 20]
        [--presets ensemble10k,ensemble10k_3d]
        [--tails mr_fan_3d,ensemble10k_plume:float64,
                 ensemble10k:frame=2d_colat,...]
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
same turns, `--tail-reps` launches each. A tail is named
"preset[:dtype][:field=value...]": the preset in float32 (or the dtype
named), with each field=value an override of the preset, as
profile_run's --set takes it (ensemble10k:frame=2d_colat is the
colatitude fan). Prints each checkout's registers
and spills (-Xptxas -v), one line per launch with the two turns of each
side and the ratio of the means, and a JSON record as the last line.

The 2D solver's CN/CG kernel (`--cn-pcg`, csrc/cn_pcg_2d.cu) instead of
the step kernel:

    python -m raytrace_tpu_torch.kernel_ab --against DIR --cn-pcg
        [--cn-steps 180]

Each turn (other / this / this / other) builds its checkout's kernel and
times, on examples/chorus_acceleration.py's operator (this checkout's
fp2d_examples over the turn's package), float64 and float32, one launch
of `--cn-steps` CN steps at the wrapper's own layout and, where the
checkout has cluster layouts (ops/cn_pcg_2d.py::layout), at each cluster
size, twice each with CUDA events: us a CG iteration, ms a CN step,
beside the latency floor of the layout's synchronisation skeleton
(floor_us); both examples' walls (fp2d_chain: host clock around each
evolution, numpy out); random operators on small grids (SMALL; 40 CN
steps of 0.05, the least of three launches) at the wrapper's layout and
at each cluster size; the build's registers and spills. Prints a line per
turn and a JSON record as the last line.
"""

import contextlib
import argparse
import importlib.util
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
# the small grids of --cn-pcg
SMALL = ((20, 23), (24, 28), (32, 32), (40, 40))


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
    counts = [name for name in ("launches", "team_launches",
                                "sparse_launches", "group_launches",
                                "finish_launches", "fresh_launches")
              if hasattr(orig, name)]
    for name in counts:
        setattr(record, name, getattr(orig, name))
    sc.step_chunk = record
    try:
        yield seen
    finally:
        sc.step_chunk = orig
        for name in counts:
            setattr(orig, name, getattr(record, name))


def tail_spec(name):
    """(preset, dtype, overrides) of a tail's name,
    "preset[:dtype][:field=value...]" (float32 unless a dtype is named;
    a value is a Python literal or a bare word, a string)."""
    from raytrace_tpu_torch.profile_run import _literal

    base, *parts = name.split(":")
    dtype, over = "float32", {}
    for part in parts:
        if "=" in part:
            k, v = part.split("=", 1)
            over[k] = _literal(v)
        else:
            dtype = part
    return base, dtype, over


def capture_tail(name, path=None, grad_mode="fused"):
    """Run the preset of tail `name` (tail_spec) through run.run on the
    card and return its last launch, the merged tail, as a dict: the
    carry's fields and f (on the card), the launch's keywords, cfg and
    spec as dicts, the preset's dtype and overrides, and the last round's
    record (active rays, bucket, attempts); saved with torch.save to
    `path` when given."""
    import torch

    from raytrace_tpu_torch.config import preset
    from raytrace_tpu_torch.run import run

    base, dtype, over = tail_spec(name)
    # a gradient set among the tail's overrides takes precedence
    over = {"grad_mode": grad_mode, **over}
    with recording_launches() as seen:
        out = run(preset(base, dtype=dtype, **over), device="cuda")
    carry, f, _env, cfg, spec, kw = seen[-1]
    # the keywords of the reference scripts' modes only where they are on,
    # so that a checkout from before them replays the tail too; the
    # launch's own end (finish, fresh) is left out, so that both replay
    # the same attempts and nothing else
    kw = {k: v for k, v in kw.items()
          if (k, v) not in (("grad_mode", "fused"),
                            ("legacy_freq_state", False))
          and k not in ("finish", "fresh")}
    tail = dict(name=base, dtype=dtype, over=over, carry=carry._asdict(),
                f=f, kw=kw, cfg=cfg._asdict(), spec=spec._asdict(),
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
        env = preset(tail["name"], **tail.get("over", {})).medium.build()
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


def _cn_small_case(na, npp, dtype, dev, seed=31):
    """A random SPD operator with a signed cross term on an na x npp grid
    and its f0 (tests/test_torch_cuda.py's _fp2d_case)."""
    import numpy as np
    import torch

    from raytrace_tpu_torch import fokker_planck_2d as fp2

    rng = np.random.default_rng(seed)
    a11 = rng.uniform(0.3, 3.0, (na, npp))
    a22 = rng.uniform(0.3, 3.0, (na, npp))
    a12 = rng.uniform(-0.95, 0.95, (na, npp)) * np.sqrt(a11 * a22)
    g = fp2.make_grid_2d(np.radians(8.0), na, 0.5, 4.0, npp)
    op = fp2.make_operator_2d(g, *(torch.tensor(a, device=dev).to(dtype)
                                   for a in (a11, a12, a22)))
    f0 = torch.tensor(rng.uniform(0.5, 1.5, (na, npp)),
                      device=dev).to(dtype)
    return op, f0


def _cn_time(cg, x0, op, dt, n_steps, every, tol, reps, **kw):
    """`reps` launches of n_steps timed with CUDA events after a warm-up:
    (ms of each, CG iterations of the last, its layout or None)."""
    import torch

    cg.cn_pcg_2d(x0, op, dt, 2, 0, tol, 500, **kw)
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, _, it = cg.cn_pcg_2d(x0, op, dt, n_steps, every, tol, 500, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, int(it.long().sum()), getattr(cg.cn_pcg_2d, "last_layout",
                                             None)


def _cn_pcg_turn(steps):
    """One --cn-pcg turn over the package on the path: {key: row}."""
    import torch

    from raytrace_tpu_torch import fokker_planck_2d as fp2
    from raytrace_tpu_torch.ops import cn_pcg_2d as cg

    # this checkout's recipe, over the turn's package (fp2d_examples
    # imports the port by absolute name; a checkout from before the module
    # has the same operator and evolution)
    spec = importlib.util.spec_from_file_location(
        "fp2d_examples", os.path.join(os.path.dirname(_HERE),
                                      "fp2d_examples.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    dev = torch.device("cuda")
    cg.build()
    out = {"ptxas": [ln.strip() for ln in cg.BUILD_LOG.splitlines()
                     if any(w in ln for w in ("Compiling entry",
                                              "registers", "spill"))]}
    clusters = getattr(cg, "CLUSTER_SIZES", ())

    def row(ms, n_it, lay, dtype):
        r = dict(ms=ms, n_it=n_it, us_per_iteration=[m / n_it * 1e3
                                                     for m in ms])
        if lay is not None:
            r["layout"] = list(lay)
            r["floor_us"] = cg.floor_us(dtype, lay.cluster, lay.threads)
        return r

    k64 = fx.fp2d_for(dev, torch.float64)
    grid, e_c, f0, chorus, emic = fx.fp2d_grid(k64)
    t_ch, t_em = fx.fp2d_tensors(k64, grid, e_c, chorus, emic)
    dt = fx.CHORUS["dt"]
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        op = fp2.make_operator_2d(grid, *(torch.as_tensor(t, device=dev)
                                          .to(dtype) for t in t_ch))
        x0 = torch.as_tensor(f0, device=dev).to(dtype)
        tol = fp2.default_cg_tol(dtype)
        for c in (None, *clusters):
            kw = {} if c is None else {"cluster": c}
            ms, n_it, lay = _cn_time(cg, x0, op, dt, steps, steps, tol, 2,
                                     **kw)
            r = row(ms, n_it, lay, dtype)
            r["ms_per_cn_step"] = [m / steps for m in ms]
            out[f"chorus/{name}/{'auto' if c is None else c}"] = r
        out[f"walls/{name}"] = fx.fp2d_chain(
            fx.fp2d_for(dev, dtype), grid, e_c, f0, t_ch, t_em)["walls"]
        for na, npp in SMALL:
            op, x0 = _cn_small_case(na, npp, dtype, dev)
            for c in (None, *clusters):
                kw = {} if c is None else {"cluster": c}
                ms, n_it, lay = _cn_time(cg, x0, op, 0.05, 40, 0, tol, 3,
                                         **kw)
                out[f"small/{name}/{na}x{npp}/"
                    f"{'auto' if c is None else c}"] = row(
                        [min(ms)], n_it, lay, dtype)
    return out


def _child(root, mode, n, reps, presets, tails=None, tail_reps=3,
           grad_mode="fused", cn_steps=180):
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
    if mode == "cn_pcg":
        print(json.dumps(_cn_pcg_turn(cn_steps)))
        return
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
         "--grad-mode", args.grad_mode, "--cn-steps", str(args.cn_steps)],
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


def _cn_pcg_main(args):
    """--cn-pcg: the turns other / this / this / other."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi} (nvidia-smi)", flush=True)
    roots = {"this": _ROOT, "other": os.path.abspath(args.against)}
    turns = []
    for tag in ("other", "this", "this", "other"):
        rec = _run(roots[tag], "cn_pcg", args)
        rec.update(turn=tag, root=roots[tag])
        turns.append(rec)
        brief = {k: [round(u, 3) for u in v["us_per_iteration"]]
                 for k, v in rec.items() if k.startswith("chorus/")}
        walls = {k: v for k, v in rec.items() if k.startswith("walls/")}
        print(f"{tag} ({roots[tag]}): us an iteration {json.dumps(brief)}; "
              f"walls {json.dumps(walls)}", flush=True)
    print(json.dumps({"card": smi, "steps": args.cn_steps, "turns": turns}))
    return 0


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
    p.add_argument("--cn-pcg", action="store_true",
                   help="time the 2D solver's CN/CG kernel instead")
    p.add_argument("--cn-steps", type=int, default=180,
                   help="CN steps of --cn-pcg's chorus launch")
    p.add_argument("--child", help=argparse.SUPPRESS)
    p.add_argument("--mode", default="time", help=argparse.SUPPRESS)
    p.add_argument("--tail-dir", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    tails = [t for t in args.tails.split(",") if t]
    if args.child:
        _child(os.path.abspath(args.child), args.mode, args.n, args.reps,
               args.presets,
               {t: os.path.join(args.tail_dir, f"{t}.pt") for t in tails},
               args.tail_reps, args.grad_mode, args.cn_steps)
        return 0
    if not args.against:
        p.error("--against DIR is required")
    if args.cn_pcg:
        return _cn_pcg_main(args)
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
