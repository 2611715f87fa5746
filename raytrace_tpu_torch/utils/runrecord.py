"""Run records: a traced run serialized to JSON (port of
raytrace_tpu/utils/runrecord.py, with the same keys).

One record of environment, solver, stop conditions, launch grid and
results summary, in place of the reference's copy-pasted module globals
(README.md:11-12, SURVEY.md section 5.6).
"""

import dataclasses
import json
import platform
import time

import numpy as np
import torch


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tolist(x):
    if isinstance(x, torch.Tensor):
        x = _host(x)
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    if hasattr(x, "_asdict"):
        return {k: _tolist(v) for k, v in x._asdict().items()}
    if dataclasses.is_dataclass(x):
        return {k: _tolist(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, (list, tuple)):
        return [_tolist(v) for v in x]
    if isinstance(x, dict):
        return {k: _tolist(v) for k, v in x.items()}
    return x


def write_run_record(path, *, env, cfg, spec, launch=None, result=None,
                     stats=None, extra=None, device="cpu"):
    """Serialize a complete run description and summary to JSON; returns
    the record. `backend` is the type of the torch device the run used
    ("cuda" or "cpu") and `n_devices` the cards torch sees there (1 on
    the CPU)."""
    device = torch.device(device)
    rec = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "host": platform.node(),
        "backend": device.type,
        "n_devices": (torch.cuda.device_count() if device.type == "cuda"
                      else 1),
        "env": _tolist(env),
        "solver": _tolist(cfg),
        "stop": _tolist(spec),
    }
    if launch is not None:
        rec["launch"] = _tolist(launch)
    if result is not None:
        status = _host(result.status)
        rec["result"] = {
            "n_rays": int(status.size),
            "status_counts": {
                int(k): int(v)
                for k, v in zip(*np.unique(status, return_counts=True))
            },
            "total_accepted": int(_host(result.n_accept).sum()),
            "total_rejected": int(_host(result.n_reject).sum()),
        }
    if stats is not None:
        rec["stats"] = _tolist(stats)
    if extra:
        rec["extra"] = _tolist(extra)
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=2)
    return rec
