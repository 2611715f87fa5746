"""Debug gates: NaN trapping and domain checking (port of
raytrace_tpu/utils/debug.py, SURVEY.md section 5.2).

The reference's failure handling is a try/catch DomainError around
sqrt(mu^2) with an unphysical abs() fallback (RayMain.jl:212-238). Here:
  - nan_gate(): within the block, the first torch op whose output holds
    a NaN raises with the op's name (the JAX package's jax_debug_nans);
  - checked_mu_2d_lat(): a dispersion evaluation that reports the
    evanescent root and non-finite values as errors instead of silently
    abs()-guarding them -- for interactive medium exploration, not for the
    hot loop (the tracer carries per-ray status codes there).
"""

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models import medium
from ..ops import dispersion


class _NanGate(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if (isinstance(o, torch.Tensor) and o.is_floating_point()
                    and bool(torch.isnan(o).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_gate():
    """Raise FloatingPointError at the first op in the block that outputs
    a NaN."""
    with _NanGate():
        yield


class CheckError:
    """The outcome of a checked evaluation: get() is the first failed
    check's message or None, throw() raises it as a ValueError."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self):
        if self.message is not None:
            raise ValueError(self.message)


def checked_mu_2d_lat(r, lat, chi, f, env: medium.EnvParams, root=1.0):
    """(error, mu): the 2D latitude-frame refractive index with its domain
    checks -- the selected root evanescent (mu^2 < 0, the condition the
    reference papers over with abs(), RayMain.jl:213) or mu non-finite
    (the DomainError class it catches). Element-wise over tensors; the
    error names the first failing element."""
    r, lat, chi, f = (torch.as_tensor(x, dtype=torch.float64)
                      for x in (r, lat, chi, f))
    sinpsi, cospsi = dispersion.psi_trig_lat(lat, chi)
    ne = medium.ne_total_m3(r, lat, env)
    b = medium.b_mag(r, lat, env)
    rr, ll, pp = dispersion.stix_rlp(ne, b, f)
    mu2 = dispersion.mu2_signed_trig(rr, ll, pp, sinpsi, cospsi, root)
    mu = dispersion.mu_from_mu2(mu2)
    r_b, lat_b, mu2_b, mu_b = torch.broadcast_tensors(r, lat, mu2, mu)
    bad = mu2_b < 0.0
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        return CheckError(
            f"evanescent root: mu^2 = {float(mu2_b.flatten()[i])} < 0 at "
            f"r={float(r_b.flatten()[i])}, lat={float(lat_b.flatten()[i])}"
        ), mu
    bad = ~torch.isfinite(mu_b)
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        return CheckError(
            f"non-finite mu at r={float(r_b.flatten()[i])}, "
            f"lat={float(lat_b.flatten()[i])}"
        ), mu
    return CheckError(), mu
