"""Carry state between the JAX package and the port as plain values.

Takes and returns numpy arrays and Python scalars and never imports jax,
so the tests can step the very same state through both packages: a JAX
NamedTuple converts through its `_asdict()`, and a dict returned here
converts back with `JaxType(**d)`. Carries of either frame (4-state 2D,
7-state 3D) convert alike: the state dimension is the arrays' own. The
physics tiers' dataclasses (WaveSpectrum, HotElectrons, HotProtons)
convert from the JAX package's instances or their fields.
"""

import dataclasses

import numpy as np
import torch

from .diffusion import WaveSpectrum
from .fokker_planck_2d import _Op2D
from .growth import HotElectrons, HotProtons
from .integrate.events import StopSpec
from .integrate.solve import RayCarry, SolverConfig
from .models.medium import EnvParams


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _scalar(v):
    if isinstance(v, str):
        return v
    a = np.asarray(v)
    if isinstance(v, tuple) or a.ndim > 0:
        # ps_mlt_c and igrf_coeffs: tuples of Python floats (a JAX cast_env
        # holds ps_mlt_c as an array)
        return tuple(float(x) for x in a.ravel())
    return float(a)


def env_from_numpy(fields):
    """The port's EnvParams from a JAX `EnvParams._asdict()` (values may
    be Python floats or arrays); strings pass through, and the coefficient
    tuples come back as tuples of Python floats."""
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


def spectrum_from_numpy(fields):
    """The port's diffusion.WaveSpectrum from a JAX WaveSpectrum (or a
    mapping of its fields)."""
    d = _fields(fields)
    return WaveSpectrum(**{k: (v if k == "directions" else float(v))
                           for k, v in d.items()})


def hot_from_numpy(fields):
    """The port's growth.HotProtons from a JAX HotProtons, else
    growth.HotElectrons, from the instance or a mapping of its fields."""
    cls = HotProtons if type(fields).__name__ == "HotProtons" \
        else HotElectrons
    return cls(**{k: float(v) for k, v in _fields(fields).items()})


def op2d_from_numpy(fields, *, device, dtype=None):
    """The port's fokker_planck_2d._Op2D from a JAX `_Op2D` (or a mapping
    of its fields): the arrays as tensors on `device` in `dtype` (default:
    the arrays' own), da, n_a and n_p as Python numbers."""
    d = _fields(fields)
    out = {}
    for f in dataclasses.fields(_Op2D):
        v = d[f.name]
        if f.name == "da":
            out[f.name] = float(v)
        elif f.name in ("n_a", "n_p"):
            out[f.name] = int(v)
        else:
            t = torch.from_numpy(np.array(v))
            out[f.name] = t.to(device=device,
                               dtype=t.dtype if dtype is None else dtype)
    return _Op2D(**out)
