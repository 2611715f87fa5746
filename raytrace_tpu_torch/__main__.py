"""CLI: python -m raytrace_tpu_torch <preset-name | config.json> [options].

Presets: ensemble10k, lat_fan, knee. A JSON file path loads a full
RunConfig instead. The run goes to the CUDA card unless --device names
another device; it never falls back to the CPU on its own.
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
    p.add_argument("--dump-config", action="store_true",
                   help="print the resolved RunConfig JSON and exit")
    args = p.parse_args(argv)

    from .config import RunConfig, preset

    if args.config.endswith(".json"):
        config = RunConfig.from_json(args.config)
    else:
        config = preset(args.config)
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
    for k, v in out["paths"].items():
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
