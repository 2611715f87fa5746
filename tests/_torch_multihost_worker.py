"""Worker process of the port's 2-process test
(tests/test_torch_distributed.py::test_two_real_processes).

Each worker opens a gloo group against a localhost coordinator, traces
its slice of a shared global launch grid through the port's multi-process
path on the CPU, and prints its LOCAL stats row and (every process
computes it -- SPMD) the GLOBAL aggregated stats as JSON lines. It imports
nothing of JAX.

Usage: python _torch_multihost_worker.py <port> <num_processes> <rank>
"""

import json
import sys


def main():
    port, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import numpy as np
    import torch

    from raytrace_tpu_torch.constants import RE
    from raytrace_tpu_torch.integrate.events import StopSpec
    from raytrace_tpu_torch.integrate.solve import SolverConfig
    from raytrace_tpu_torch.models.medium import make_env_lat
    from raytrace_tpu_torch.parallel import LaunchSpec, build_launch
    from raytrace_tpu_torch.parallel import distributed as dist
    from raytrace_tpu_torch.parallel.ensemble import ensemble_stats

    torch.set_num_threads(1)
    dist.ensure_initialized(f"localhost:{port}", nproc, pid)
    assert dist.world_size() == nproc and dist.rank() == pid
    # the JAX package's worker grid (tests/_multihost_worker.py), identical
    # on every process
    spec = LaunchSpec(lats=tuple(np.linspace(0.6, 0.9, 4)), chis=(0.0,),
                      freqs=(1000.0, 2000.0))
    u0, f = build_launch(spec, np.float64)
    kw = dict(
        cfg=SolverConfig(rtol=1e-5, atol=1e-8, dt0=1e-4),
        spec=StopSpec(r_floor=1.0, t_max=5e9 / RE),
        max_steps=2000, round_steps=1024, chunk=64, bucket_floor=8,
    )
    res, v_l, gstats = dist.trace_ensemble_multihost(
        make_env_lat(), u0, f, tracer_kw=kw, device="cpu")
    local = {k: float(v) for k, v in ensemble_stats(res, v_l).items()}
    print(f"LOCAL {pid} " + json.dumps(local), flush=True)
    print(f"GLOBAL {pid} " + json.dumps(gstats), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
