"""Checkpoint and resume of a carry batch (port of
raytrace_tpu/parallel/checkpoint.py).

The whole per-ray integration carry (state, t, dt, FSAL derivative,
controller memory, status, step counters) goes to a .npz in the JAX
package's layout -- one array per RayCarry field under its name,
`__step__`, and `__meta_<key>__` per meta entry -- so a checkpoint of
either package resumes in the other. Resume is exact: the integrator is
deterministic and carries no random state.
"""

import numpy as np
import torch

from ..integrate.solve import RayCarry

CARRY_FIELDS = RayCarry._fields


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_carry(path, carry: RayCarry, step: int = 0, meta: dict | None = None):
    """Save a (batched) RayCarry of tensors or arrays to `path` (.npz)."""
    arrays = {k: _host(getattr(carry, k)) for k in CARRY_FIELDS}
    arrays["__step__"] = np.asarray(step)
    if meta:
        for k, v in meta.items():
            arrays[f"__meta_{k}__"] = np.asarray(v)
    np.savez(path, **arrays)


def load_carry(path, *, device=None, dtype=None):
    """Load (carry, step, meta) from a checkpoint written by save_carry
    (of either package). Without `device` the carry holds numpy arrays, as
    the JAX package returns it; with it, tensors on `device` whose float
    fields take `dtype` (the stored one if None) and counters int32, ready
    for trace(carry0=...)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in CARRY_FIELDS}
        step = int(z["__step__"])
        meta = {
            k[len("__meta_"):-2]: z[k]
            for k in z.files
            if k.startswith("__meta_")
        }
    if device is None:
        return RayCarry(**arrays), step, meta

    def tensor(a):
        t = torch.from_numpy(a)
        if a.dtype.kind in "iu":
            return t.to(device=device, dtype=torch.int32)
        return t.to(device=device, dtype=dtype or t.dtype)

    return RayCarry(**{k: tensor(a) for k, a in arrays.items()}), step, meta
