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
<name>_final.npz and <name>_record.json. --sensitivity N adds the landing
sensitivity of the first N rays to the stats and the record.
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
                   help="render ray plots (not ported: ROADMAP A11)")
    p.add_argument("--sensitivity", type=int, default=0, metavar="N",
                   help="landing-sensitivity analysis for the first N rays "
                        "(the event-projected variational Jacobian; its "
                        "amplification and status join the stats)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run over several cards (not "
                        "ported: ROADMAP A12)")
    p.add_argument("--dump-config", action="store_true",
                   help="print the resolved RunConfig JSON and exit")
    args = p.parse_args(argv)
    if args.plots:
        raise NotImplementedError(
            "--plots is not ported: the plots need matplotlib, which the "
            "card's machine lacks (ROADMAP A11); plot the _traj.npz that "
            "--trajectory writes")
    if args.multihost:
        raise NotImplementedError(
            "--multihost is not ported: the port runs on one card "
            "(ROADMAP A12)")

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
    import numpy as np

    from .integrate import events
    from .run import run, summarize

    t0 = time.perf_counter()
    out = run(config, device=args.device, out_dir=args.out or None)
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


if __name__ == "__main__":
    sys.exit(main())
