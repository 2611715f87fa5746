"""Event localization: stop conditions and in-step root refinement.

Port of raytrace_tpu/integrate/events.py. Detection is a per-ray status
code set at the end of an accepted step; localization is a fixed-count
bisection on the cubic Hermite interpolant through (u0, du0, u1, du1).
Batched: u is (B, n), per-ray scalars are (B,).
"""

from typing import NamedTuple

import torch

# per-ray status codes (same values as the JAX package)
ACTIVE = 0
HIT_EARTH = 1          # r crossed the surface floor (terminal event)
MAX_PHASE_TIME = 2     # integration span exhausted
MAX_GROUP_TIME = 3     # group-delay budget exhausted
HIT_EQUATOR = 4        # magnetic-equator crossing (optional stop)
ESCAPED = 5            # r exceeded the outer ceiling
INVALID = 6            # non-finite state
DT_UNDERFLOW = 7       # adaptive dt fell below dt_min
MAX_STEPS = 8          # step budget exhausted while still integrable
EVANESCENT = 9         # group delay unwound past zero (opt-in stop)

STATUS_NAMES = (
    "ACTIVE", "HIT_EARTH", "MAX_PHASE_TIME", "MAX_GROUP_TIME",
    "HIT_EQUATOR", "ESCAPED", "INVALID", "DT_UNDERFLOW", "MAX_STEPS",
    "EVANESCENT",
)


class StopSpec(NamedTuple):
    """Stop-condition thresholds (Python floats).

    lat_sign/lat_offset map state[1] to magnetic latitude
    (lat = lat_sign * state[1] + lat_offset)."""

    r_floor: float = 1.0
    r_ceil: float = float("inf")
    t_max: float = float("inf")
    group_time_max: float = float("inf")
    stop_at_equator: float = 0.0
    lat_sign: float = 1.0
    lat_offset: float = 0.0
    stop_retrograde: float = 0.0


def hermite_interp(tau, u0, du0, u1, du1, dt):
    """Cubic Hermite interpolant on the step; tau and dt are (B,)."""
    t2 = tau * tau
    t3 = t2 * tau
    h00 = (2.0 * t3 - 3.0 * t2 + 1.0)[..., None]
    h10 = (t3 - 2.0 * t2 + tau)[..., None]
    h01 = (-2.0 * t3 + 3.0 * t2)[..., None]
    h11 = (t3 - t2)[..., None]
    dtc = dt[..., None]
    return h00 * u0 + h10 * dtc * du0 + h01 * u1 + h11 * dtc * du1


def refine_crossing(value_of, u0, du0, u1, du1, dt, n_iter=32):
    """Bisection for tau where value_of(hermite(tau)) crosses zero.

    value_of maps (B, n) states to (B,) values; value_of(u0) and
    value_of(u1) must have opposite signs. Returns (tau, u_at_tau)."""
    sign0 = torch.sign(value_of(u0))
    lo = torch.zeros_like(dt)
    hi = torch.ones_like(dt)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        vm = value_of(hermite_interp(mid, u0, du0, u1, du1, dt))
        same = torch.sign(vm) == sign0
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    tau = 0.5 * (lo + hi)
    return tau, hermite_interp(tau, u0, du0, u1, du1, dt)


def lat_of(u, spec: StopSpec):
    return spec.lat_sign * u[..., 1] + spec.lat_offset


def classify_step(u0, u1, t1, spec: StopSpec, group_idx=3):
    """Status for a just-accepted step u0 -> u1 (0 if still active).

    Priority: INVALID > HIT_EARTH > HIT_EQUATOR > ESCAPED >
    MAX_GROUP_TIME > EVANESCENT > MAX_PHASE_TIME."""
    surface = u1[..., 0] <= spec.r_floor
    equator = (spec.stop_at_equator > 0.5) & (
        torch.sign(lat_of(u1, spec)) != torch.sign(lat_of(u0, spec))
    )
    escaped = u1[..., 0] >= spec.r_ceil
    group = u1[..., group_idx] >= spec.group_time_max
    phase = t1 >= spec.t_max
    invalid = ~torch.isfinite(u1).all(dim=-1)
    retro = (spec.stop_retrograde > 0.5) & (u1[..., group_idx] < 0.0)
    zero = torch.zeros_like(t1, dtype=torch.int32)

    def code(c):
        return torch.full_like(zero, c)

    status = torch.where(phase, code(MAX_PHASE_TIME), zero)
    status = torch.where(retro, code(EVANESCENT), status)
    status = torch.where(group, code(MAX_GROUP_TIME), status)
    status = torch.where(escaped, code(ESCAPED), status)
    status = torch.where(equator, code(HIT_EQUATOR), status)
    status = torch.where(surface, code(HIT_EARTH), status)
    status = torch.where(invalid, code(INVALID), status)
    return status
