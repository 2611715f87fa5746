"""Carry state between the JAX package and the port as plain values.

Takes and returns numpy arrays and Python scalars and never imports jax,
so the tests can step the very same state through both packages: a JAX
NamedTuple converts through its `_asdict()`, and a dict returned here
converts back with `JaxType(**d)`.
"""

import numpy as np
import torch

from .integrate.events import StopSpec
from .integrate.solve import RayCarry, SolverConfig
from .models.medium import EnvParams


def _fields(obj):
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _scalar(v):
    if isinstance(v, (str, tuple)):
        return v
    return float(np.asarray(v))


def env_from_numpy(fields):
    """The port's EnvParams from a JAX `EnvParams._asdict()` (values may
    be Python floats or 0-d arrays); tuples and strings pass through."""
    return EnvParams(**{k: _scalar(v) for k, v in _fields(fields).items()})


def carry_from_numpy(fields, *, device, dtype):
    """RayCarry of tensors on `device` from a mapping (or NamedTuple) of
    array-likes; the float fields take `dtype`, the counters int32."""
    out = {}
    for name in RayCarry._fields:
        a = np.array(_fields(fields)[name])  # a writable copy
        t = torch.from_numpy(a)
        out[name] = t.to(device=device, dtype=(
            torch.int32 if a.dtype.kind in "iu" else dtype))
    return RayCarry(**out)


def carry_to_numpy(carry: RayCarry):
    """{field: numpy array} of a RayCarry (fetched to the host)."""
    return {name: getattr(carry, name).detach().cpu().numpy()
            for name in RayCarry._fields}


def solver_config_from(cfg):
    """The port's SolverConfig from any NamedTuple with its fields."""
    d = _fields(cfg)
    return SolverConfig(**{
        k: (tuple(d[k]) if k == "ds_local_shells" else float(d[k]))
        for k in SolverConfig._fields
    })


def stop_spec_from(spec):
    """The port's StopSpec from any NamedTuple with its fields."""
    d = _fields(spec)
    return StopSpec(**{k: float(d[k]) for k in StopSpec._fields})
