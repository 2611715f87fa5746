"""CLI: python -m raytrace_tpu_torch <preset-name | config.json> [options].

Presets: ensemble10k, ensemble10k_production, ensemble10k_local, lat_fan,
knee, mr_fan, emic_heband (2D latitude frame); raymain (2D colatitude
frame); ensemble10k_3d, ensemble3d, knee_3d, 3d (3D dipole
frame); ensemble10k_plume, mr_fan_3d (3D, the MLT-resolved medium);
ensemble10k_tilted, ensemble10k_igrf (3D, the tilted dipole and the IGRF
truncation). A JSON file path loads a full RunConfig instead. The run goes to
the CUDA card unless --device names another device; it never falls back
to the CPU on its own. --trajectory K records a snapshot every K attempts
with the diagnostics; with --out it is written as <name>_traj.npz beside
<name>_final.npz and <name>_record.json, and --plots (which needs
matplotlib) draws it as <name>_rays.png. --sensitivity N adds the landing
sensitivity of the first N rays to the stats and the record.
--multihost runs one process per card: start K of them with `python -m
torch.distributed.run --nproc-per-node K -m raytrace_tpu_torch <preset>
--multihost`; each traces its slice of the launch grid on its card
(LOCAL_RANK's), prints its local line, and rank 0 prints the statistics
gathered over the processes as GLOBAL {json}.
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="raytrace_tpu_torch",
        description="whistler ray tracer, PyTorch + CUDA port (README.md)",
    )
    p.add_argument("config", help="preset name or RunConfig JSON path")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu must be "
                        "asked for)")
    p.add_argument("--float64", action="store_true",
                   help="run in float64 instead of the config's dtype")
    p.add_argument("--out", default="", help="output directory (optional)")
    p.add_argument("--trajectory", type=int, default=0, metavar="K",
                   help="record a snapshot every K steps, with the "
                        "diagnostics (mu, dmu/dpsi, dip, psi)")
    p.add_argument("--plots", action="store_true",
                   help="render the ray paths of a --trajectory run to "
                        "<out>/<name>_rays.png (needs matplotlib)")
    p.add_argument("--sensitivity", type=int, default=0, metavar="N",
                   help="landing-sensitivity analysis for the first N rays "
                        "(the event-projected variational Jacobian; its "
                        "amplification and status join the stats)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process SPMD run, one process a card: every "
                        "process traces its slice of the (identical) launch "
                        "grid and the statistics aggregate across processes "
                        "(a gloo group from torchrun's environment; a "
                        "single-process pass-through without it)")
    p.add_argument("--dump-config", action="store_true",
                   help="print the resolved RunConfig JSON and exit")
    args = p.parse_args(argv)

    from .config import RunConfig, preset

    if args.config.endswith(".json"):
        config = RunConfig.from_json(args.config)
    else:
        config = preset(args.config)
    if args.trajectory:
        config.save_every = args.trajectory
        config.save_diagnostics = True  # (mu, dmudpsi, dip, psi), any frame
    if args.sensitivity:
        config.sensitivity_rays = args.sensitivity
    if args.float64:
        config.dtype = "float64"
    if args.dump_config:
        print(config.to_json())
        return 0

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 2
    if args.multihost:
        return _run_multihost(
            config, None if args.device == "cuda" else args.device)
    import numpy as np

    from .integrate import events
    from .run import run, summarize

    t0 = time.perf_counter()
    out = run(config, device=args.device, out_dir=args.out or None,
              plots=args.plots)
    wall = time.perf_counter() - t0
    steps = int(out["stats"]["total_accepted_steps"]) + int(
        out["stats"]["total_rejected_steps"]
    )
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if args.device.startswith("cuda") else args.device)
    print(
        f"{config.name} on {where} ({config.dtype}): "
        f"{int(np.asarray(out['valid']).sum())} rays, "
        f"{steps} ray-steps, {wall:.3f}s "
        f"({steps / wall / 1e6:.2f}M steps/s, the wall includes start-up "
        f"and, the first time, the kernel build) | "
        f"{summarize(out['result'], out['valid'])}"
    )
    if config.sensitivity_rays > 0:
        amp = np.asarray(out["stats"]["sensitivity_amplification"])
        st = np.asarray(out["stats"]["sensitivity_status"])
        print(f"  landing sensitivity of the first {amp.size} rays: "
              f"|d lat_land / d lat_0| = {np.array2string(amp)}, status "
              f"{[events.STATUS_NAMES[int(x)] for x in st]}")
    for k, v in out["paths"].items():
        print(f"  {k}: {v}")
    return 0


def _run_multihost(config, device=None):
    """The scale-out path (the JAX package's _run_multihost): SPMD over
    processes, one a card. Every process builds the identical global
    grid, traces its contiguous slice on its card (`device` where the
    caller names one, else parallel.mesh.local_device's), and the
    terminal statistics aggregate with one all_gather over gloo.
    Single-process this is a pass-through."""
    import json

    import numpy as np
    import torch

    from .parallel import distributed as dist
    from .parallel.mesh import local_device
    from .run import _build_u0, summarize

    dist.ensure_initialized()
    try:
        device = local_device(device)
        env = config.medium.build()
        np_dtype = np.float32 if config.dtype == "float32" else np.float64
        u0, f = _build_u0(config, env, np_dtype, device)
        tracer_kw = dict(
            frame=config.frame, cfg=config.solver(), spec=config.stop(),
            adaptive=config.adaptive, stepper=config.stepper,
            base_stepper=config.base_stepper, max_steps=config.max_steps,
            grad_mode=config.grad_mode, root=config.root, want_carry=False,
        )
        t0 = time.perf_counter()
        res, v_l, gstats = dist.trace_ensemble_multihost(
            env, u0, f, tracer_kw=tracer_kw, device=device)
        wall = time.perf_counter() - t0
        pid, cnt = dist.rank(), dist.world_size()
        print(f"{config.name}[{pid}/{cnt}] on {device}: "
              f"{int(np.asarray(v_l).sum())} local rays, {wall:.3f}s | "
              f"{summarize(res, v_l)}", flush=True)
        if pid == 0:
            print("GLOBAL " + json.dumps(
                {k: float(v) for k, v in gstats.items()}), flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
