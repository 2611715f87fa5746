"""What bounds one attempt of the step kernel's main-path instances, on
one card: the launch, its merged tail, one ray alone, one ray a warp.

    python -m raytrace_tpu_torch.latency_floor [--against DIR] [--reps 5]
        [--cells ensemble10k,ensemble10k:frame=2d_colat]

Each cell is a merged tail's name as kernel_ab takes it (a preset, its
dtype, float32 unless one is named, and its overrides;
ensemble10k:frame=2d_colat is the colatitude fan,
ensemble10k:float64:grad_mode=autodiff the float64 autodiff run), and
its instance the bs3 one of the cell's dtype, frame, medium and field
(ensemble10k_tilted: "float bs3 3d full tilted"). For each,
timed with CUDA events on the card, beside `clocks.sm` (nvidia-smi, read
while the same launches run on), and converted to cycles per attempt of
the ray that makes the most (a launch lasts as long as that ray's chain):

- (a) the launch: every ray of the preset x 512 attempts from the launch
  carry;
- (b) the merged tail, captured once by this checkout's run.run and
  replayed (kernel_ab.replay_tail), in the dense layout (32 rays a warp;
  the tail layout's threshold set to 0 where the checkout has one);
- (c) the tail's longest ray alone, a launch of B = 1;
- (d) the tail one ray a warp: its lanes, pad lanes too, 32 apart, the
  lanes between them stopped (a ray that is not ACTIVE leaves at once), so
  every warp steps one ray whatever layout the checkout has;
- (e) the tail as the wrapper launches it (the tail layout where the
  checkout has it: at most ops/step_chunk.py::layout_limit rays);
- (f) where the checkout and the instance have the tail layout: launches
  of 132, 264, 528, 1,056 and 2,112 rays of the preset (evenly spaced) x
  512 attempts in both layouts, the numbers behind the threshold.

A cell of an instance with a group body (the bs3 AD ones of
ops/step_chunk.py::GROUP_MAX_RAYS: ensemble10k:grad_mode=autodiff,
ensemble10k:float64:grad_mode=autodiff, ...) also times (a) and
the tail (g) in each body (GROUP_BODIES: the one-thread body, the group
body), (f) in both up to 8,448 rays, (b) on the one-thread body and (d) on
the group body.

Beside them the SASS census of the instance (sass_census: chain_cycles,
inorder_cycles, the attempt loop's size in bytes and its inner loop's)
and the latency floor: chain_cycles_total (the attempt loop's chain with
the out-of-line right-hand side it calls or the team body's helper loop
it waits on) at the measured clock times the longest ray's attempts. A
build whose attempt loop holds bs3's stage loop has no walkable chain
(sass_census): take the floor from a checkout with the stages unrolled
(the same operations), e.g. the parent's.
With --against DIR (another checkout's root, e.g. the parent unpacked
with `git archive` into a directory that .gitignore lists) both
checkouts build at once and the timings run in turns, other / this /
this / other, one process a turn. Prints a line per number and a JSON
record as the last line. Needs a CUDA device and the CUDA toolkit.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

DEFAULT_CELLS = "ensemble10k,ensemble10k:frame=2d_colat"
CROSSOVER_RAYS = (132, 264, 528, 1056, 2112)
_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(_HERE))
# clocks.sm beside each timing: readings, each with this many seconds of
# the timed launches queued
_CLOCK_READS = 3
_CLOCK_AHEAD = 0.25


def instance_of(conf):
    """The bs3 instance of a RunConfig as sass_census names it: its dtype
    ("float" or "double"), its frame, the medium code of its medium and
    gradient set and the field its medium takes (ops/step_chunk.py::
    medium_code, field_code)."""
    from raytrace_tpu_torch.ops import step_chunk as sc

    env = conf.medium.build()
    field = ("", " tilted", " igrf")[sc.field_code(env)]
    medium = sc._MEDIUM_NAMES[sc.medium_code(env, conf.solver(),
                                             conf.grad_mode)]
    scalar = "double" if conf.dtype == "float64" else "float"
    return f"{scalar} bs3 {conf.frame} {medium}{field}"


def tail_config(tail):
    """The RunConfig of a tail that kernel_ab.capture_tail saved: its
    preset in its dtype (float32 where the tail names none) with its
    overrides."""
    from raytrace_tpu_torch.config import preset

    return preset(tail["name"], dtype=tail.get("dtype", "float32"),
                  **tail["over"])


def _instance(cell):
    from raytrace_tpu_torch.kernel_ab import tail_spec

    base, dtype, over = tail_spec(cell)
    return instance_of(tail_config(dict(name=base, dtype=dtype, over=over)))


def _clock_mhz():
    """clocks.sm (MHz) as nvidia-smi reads it now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def _timed(launch, reps):
    """(mean ms of reps launches between CUDA events, the median of
    _CLOCK_READS clocks.sm readings, each taken while ~_CLOCK_AHEAD s of
    the same launches are queued on the card)."""
    import torch

    launch()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        launch()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    mhz = []
    for _ in range(_CLOCK_READS):
        for _ in range(max(1, int(_CLOCK_AHEAD * 1e3 / ms))):
            launch()
        mhz.append(_clock_mhz())
        torch.cuda.synchronize()
    return ms, sorted(mhz)[len(mhz) // 2]


def _record(ms, mhz, longest, rays):
    return dict(ms=ms, mhz=mhz, longest=longest, rays=rays,
                cycles_per_attempt=ms * 1e3 * mhz / max(longest, 1))


def _made(out, carry):
    return (out.n_accept + out.n_reject) - (carry.n_accept + carry.n_reject)


def _spread(carry, f, gap):
    """The carry with each lane `gap` lanes from the next, the lanes
    between them copies stopped at MAX_STEPS (they leave at once)."""
    import torch

    from raytrace_tpu_torch.integrate import events
    from raytrace_tpu_torch.integrate.solve import RayCarry

    b = f.shape[0]
    idx = torch.arange(b, device=f.device).repeat_interleave(gap)
    fields = {k: getattr(carry, k).index_select(0, idx)
              for k in RayCarry._fields}
    status = fields["status"].clone()
    live = torch.zeros_like(status, dtype=torch.bool)
    live[::gap] = True
    status[~live] = events.MAX_STEPS
    fields["status"] = status
    return RayCarry(**fields), f.index_select(0, idx), live


def _on_path(root):
    """`root`'s package first on the path (and not this file's directory,
    which Python put there)."""
    here = os.path.dirname(_HERE)
    sys.path[:] = [root] + [q for q in sys.path
                            if os.path.abspath(q or ".") != here]


def _same(a, b):
    """Two carries' fields equal bit for bit (NaN == NaN)."""
    import numpy as np

    return all(np.array_equal(x.cpu().numpy(), y.cpu().numpy(),
                              equal_nan=x.dtype.is_floating_point)
               for x, y in zip(a, b))


# the two bodies of an instance with a group body (ops/step_chunk.py::
# group_lanes), each by the threshold that on_body gives every instance's
# entry of the wrapper's GROUP_MAX_RAYS: the one-thread body and the group
# body
GROUP_BODIES = {"one-thread": 0, "group": 2 ** 31 - 1}


@contextlib.contextmanager
def on_body(sc, body):
    """Within the block every launch of an instance with a group body (of
    the checkout whose ops/step_chunk.py is `sc`) takes `body`, one of
    GROUP_BODIES: each entry of sc.GROUP_MAX_RAYS, whatever its key, set to
    the body's threshold; None leaves the wrapper's own."""
    own = sc.GROUP_MAX_RAYS
    if body is not None:
        sc.GROUP_MAX_RAYS = {k: GROUP_BODIES[body] for k in own}
    try:
        yield
    finally:
        sc.GROUP_MAX_RAYS = own


# (f) of such an instance: the crossover's launches and wider ones
GROUP_CROSSOVER_RAYS = CROSSOVER_RAYS + (4224, 6336, 8448)


def measure_cell(conf, tail, reps=5, tail_reps=3, crossover=True):
    """(a)-(f) of one cell on the card, by the package on the path: conf
    the cell's RunConfig (tail_config), tail a merged tail as
    kernel_ab.capture_tail gives it (its carry and f on the card). Returns
    {"a": record, ..., "tail": the tail's rays, bucket, attempts, longest
    ray, that ray's attempts alone, and whether the spaced launch (d) gave
    every lane's fields bit for bit}; a record is {ms, mhz, longest, rays,
    cycles_per_attempt, and "body" where the instance has a group body}.
    An instance with a group body (GROUP_BODIES) also has "a <body>" and
    "g <body>": the launch and the tail in each body; (b) is its tail on
    the one-thread body, (d) on the group body, and (f) its launches in
    both bodies."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import (
        RayCarry, SolverConfig, init_carry,
    )
    from raytrace_tpu_torch.ops import rhs as rhs_mod
    from raytrace_tpu_torch.ops import step_chunk as sc
    from raytrace_tpu_torch.run import _build_u0

    dev = torch.device("cuda")
    has_layout = hasattr(sc, "TAIL_LAYOUT_MAX_RAYS")
    env = conf.medium.build()
    cfg, spec = conf.solver(), conf.stop()
    double = conf.dtype == "float64"
    codes = (int(double), sc._STEPPER_CODE["bs3"],
             sc._FRAME_CODE[conf.frame][0],
             sc.medium_code(env, cfg, conf.grad_mode), sc.field_code(env))
    group = hasattr(sc, "group_lanes") and sc.group_lanes(*codes) > 0

    # the tail layout's thresholds (the team body's too, where the
    # checkout has one)
    knobs = [k for k in ("TAIL_LAYOUT_MAX_RAYS", "TEAM_LAYOUT_MAX_RAYS")
             if hasattr(sc, k)]
    own = {k: getattr(sc, k) for k in knobs}

    @contextlib.contextmanager
    def thresholds(limit=None, body=None):
        # the tail layout's thresholds at `limit`, or every launch on the
        # body `body` (on_body), within the block
        if limit is not None:
            for k in knobs:
                setattr(sc, k, limit)
        try:
            with on_body(sc, body if group else None):
                yield
        finally:
            for k, v in own.items():
                setattr(sc, k, v)

    def timed(launch, reps, longest, rays, limit=None, body=None):
        with thresholds(limit, body):
            r = _record(*_timed(launch, reps), longest, rays)
        if group:
            r["body"] = body or "as launched"
        return r

    rec = {}
    # (a) the launch
    u0, f = _build_u0(conf, env, np.float64 if double else np.float32, dev)
    u0, f = torch.as_tensor(u0).to(dev), torch.as_tensor(f).to(dev)
    rhs_fn = rhs_mod.frame_rhs(conf.frame, env, conf.root,
                               conf.grad_mode)[0]
    carry = init_carry(rhs_fn, u0, f, cfg)
    # the gradient set only where it is not the default, so that a
    # checkout from before it measures the fused cells too
    kw = dict(stepper="bs3", frame=conf.frame, root=conf.root,
              **({} if conf.grad_mode == "fused"
                 else {"grad_mode": conf.grad_mode}))

    def launch(c=carry, ff=f):
        return sc.step_chunk(c, ff, env, cfg, spec, n_steps=512, **kw)

    longest = int(_made(launch(), carry).max())
    rec["a"] = timed(launch, reps * 16, longest, f.shape[0])
    for body in GROUP_BODIES if group else ():
        rec[f"a {body}"] = timed(launch, reps * 16, longest, f.shape[0],
                                 body=body)
    # (f) the layouts from 132 to 2,112 rays, where the instance takes
    # the tail layout or has a group body
    if has_layout and crossover and not group:
        crossover = sc.tail_layout(*codes)
    sizes = GROUP_CROSSOVER_RAYS if group else CROSSOVER_RAYS
    for b in sizes if has_layout and crossover else ():
        rows = torch.linspace(0, f.shape[0] - 1, b, device=dev).long()
        c = RayCarry(*(x.index_select(0, rows) for x in carry))
        fb = f.index_select(0, rows)
        lng = int(_made(launch(c, fb), c).max())
        for body in GROUP_BODIES if group else ():
            rec[f"f {b} {body}"] = timed(lambda: launch(c, fb), reps * 4,
                                         lng, b, body=body)
        for name, limit in () if group else (("dense", 0), ("tail", b)):
            rec[f"f {b} {name}"] = timed(lambda: launch(c, fb), reps * 4,
                                         lng, b, limit)
    # the merged tail: (b) dense (on the one-thread body), (e) as the
    # wrapper launches it
    tcarry = RayCarry(**tail["carry"])
    tf = tail["f"]
    tcfg, tspec = SolverConfig(**tail["cfg"]), StopSpec(**tail["spec"])

    def replay(c=tcarry, ff=tf):
        return sc.step_chunk(c, ff, env, tcfg, tspec, **tail["kw"])

    made = _made(replay(), tcarry)[:tail["round"]["active"]]
    longest, ray = int(made.max()), int(made.argmax())
    bucket = int(tf.shape[0])
    rec["b"] = timed(replay, tail_reps, longest, bucket,
                     **({"body": "one-thread"} if group else {"limit": 0}))
    rec["e"] = timed(replay, tail_reps, longest, bucket)
    for body in GROUP_BODIES if group else ():
        rec[f"g {body}"] = timed(replay, tail_reps, longest, bucket,
                                 body=body)
    # (c) the longest ray alone
    one = RayCarry(*(x[ray:ray + 1] for x in tcarry))
    f1 = tf[ray:ray + 1]
    alone = int(_made(replay(one, f1), one)[0])
    rec["c"] = timed(lambda: replay(one, f1), tail_reps, alone, 1)
    # (d) one ray a warp, by spacing (the group body: 32 rays apart, each
    # group in a warp of its own)
    sp, fsp, live = _spread(tcarry, tf, 32)
    spaced = "group" if group else None
    with thresholds(body=spaced):
        same = _same([x[live] for x in replay(sp, fsp)], replay())
    rec["d"] = timed(lambda: replay(sp, fsp), tail_reps, longest, bucket,
                     body=spaced)
    rec["tail"] = dict(rays=tail["round"]["active"], bucket=bucket,
                       attempts=int(made.sum()), longest=longest,
                       alone_attempts=alone, spread_same=same)
    return rec


def _child(root, tails, reps, tail_reps):
    import torch

    import raytrace_tpu_torch
    from raytrace_tpu_torch.ops import step_chunk as sc

    assert raytrace_tpu_torch.__file__.startswith(root)
    sc.build()
    out = {"library": sc.library_path(), "cells": {}}
    for cell, path in tails.items():
        # the tail as this checkout captured it
        tail = torch.load(path, weights_only=False)
        out["cells"][cell] = measure_cell(tail_config(tail), tail, reps,
                                          tail_reps)
    print(json.dumps(out))


def _spawn(root, mode, args, tail_dir):
    return subprocess.Popen(
        [sys.executable, _HERE, "--child", root, "--mode", mode,
         "--cells", args.cells, "--reps", str(args.reps),
         "--tail-reps", str(args.tail_reps), "--tail-dir", tail_dir],
        stdout=subprocess.PIPE, text=True)


def _tail_paths(cells, tail_dir):
    return {c: os.path.join(tail_dir, c.replace(":", "_").replace("=", "-")
                            + ".pt") for c in cells.split(",") if c}


def main():
    p = argparse.ArgumentParser(
        prog="python -m raytrace_tpu_torch.latency_floor")
    p.add_argument("--against", help="root of another checkout")
    p.add_argument("--cells", default=DEFAULT_CELLS)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--tail-reps", type=int, default=3)
    p.add_argument("--child", help=argparse.SUPPRESS)
    p.add_argument("--mode", default="time", help=argparse.SUPPRESS)
    p.add_argument("--tail-dir", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        root = os.path.abspath(args.child)
        tails = _tail_paths(args.cells, args.tail_dir)
        _on_path(root)
        if args.mode == "build":
            from raytrace_tpu_torch.ops import step_chunk as sc

            sc.build()
            print(json.dumps({"library": sc.library_path()}))
        elif args.mode == "capture":
            from raytrace_tpu_torch.kernel_ab import capture_tail

            for cell, path in tails.items():
                capture_tail(cell, path)
            print(json.dumps({}))
        else:
            _child(root, tails, args.reps, args.tail_reps)
        return 0

    from . import sass_census
    from .kernel_ab import _result

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi} (nvidia-smi)", flush=True)
    tail_dir = tempfile.mkdtemp(prefix="latency_floor_tails_")
    roots = {"this": _ROOT}
    if args.against:
        roots["other"] = os.path.abspath(args.against)
    builds = {k: _spawn(r, "build", args, tail_dir) for k, r in roots.items()}
    libs = {k: _result(builds[k], roots[k])["library"] for k in roots}
    _result(_spawn(roots["this"], "capture", args, tail_dir), roots["this"])
    order = ("other", "this", "this", "other") if args.against else ("this",)
    turns = {k: [] for k in roots}
    for k in order:
        turns[k].append(_result(_spawn(roots[k], "time", args, tail_dir),
                                roots[k])["cells"])
        print(f"turn {sum(map(len, turns.values()))} ({k}) done", flush=True)
    wanted = {_instance(c) for c in args.cells.split(",") if c}
    census = {k: sass_census.run_census(libs[k], wanted) for k in roots}
    shutil.rmtree(tail_dir, ignore_errors=True)
    record = {"card": smi, "census": census, "turns": turns}
    for k in roots:
        for cell in turns[k][0]:
            # each body of the instance (the one-thread body, and the team
            # body where it runs the tail layout) with its latency floor
            chains = {}
            for key, inst in sass_census.bodies(census[k],
                                                _instance(cell)).items():
                chains[key] = inst["chain_cycles_total"]
                print(f"{k} {cell} ({key}): chain {inst['chain_cycles']} "
                      f"cycles ({chains[key]} with the calls and helpers it "
                      f"waits on), in-order issue {inst['inorder_cycles']} "
                      f"cycles, attempt loop {inst['loop']} instructions, "
                      f"{inst['loop_bytes']:,} bytes, its inner loop "
                      f"{inst['inner_loop']}; " + ", ".join(
                          f"{c} {n}" for c, n in sorted(
                              inst["by_class"].items())))
            for key in sorted(turns[k][0][cell]):
                if key == "tail":
                    print(f"  tail: {turns[k][0][cell]['tail']}")
                    continue
                rs = [t[cell][key] for t in turns[k]]
                print(f"  ({key}) " + " / ".join(
                    f"{r['ms']:.3f} ms at {r['mhz']:.0f} MHz, "
                    f"{r['cycles_per_attempt']:.0f} cycles an attempt of "
                    f"the longest ({r['longest']:,}), latency floor "
                    + ", ".join(f"{c * r['longest'] / (r['mhz'] * 1e3):.3f} "
                                f"ms ({b})" for b, c in chains.items())
                    for r in rs), flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
