"""Batched ray integration driver (port of raytrace_tpu/integrate/solve.py).

Every ray carries its own (t, dt, status, controller memory), so an
adaptive batch diverges freely; stop conditions are per-ray status codes.
The carry is a `RayCarry` of tensors with the ray axis first: vectors are
(B, n), per-ray scalars (B,), the JAX package's layouts.

`trace` advances rays of the 2D latitude frame (`ops.rhs.rhs_2d_lat` over
a medium `env`) in final-state mode. The explicit pairs (bs3, dopri5) step
through `ops.step_chunk.step_chunk`, one launch per call: the hand-written
CUDA kernel on a CUDA tensor, its plain PyTorch loop of `_step_one` on a
CPU tensor. The Rosenbrock stiff pool (ros3pr) steps as torch ops on the
tensors' device. `init_carry` and `refine_events` are torch ops around the
kernel, as they sit around the Pallas kernel in the JAX package.
"""

from typing import Any, NamedTuple, Optional

import torch

from ..constants import RE
from ..ops import rhs as rhs_mod
from . import events
from .events import StopSpec
from .steppers import bs3_step, dopri5_step, ros3pr_step


class SolverConfig(NamedTuple):
    """Numeric solver knobs (Python floats; field meanings as in the JAX
    package's SolverConfig, integrate/solve.py:37-125)."""

    rtol: float = 1.0e-7
    atol: float = 1.0e-12
    dt0: float = 1.0e-4            # initial step, scaled units
    dt_min: float = 1.0e-12        # the wedge-retirement floor (RE)
    dt_max: float = 1.0e6 / RE     # reference dtmax
    safety: float = 0.9
    pi_alpha: float = 0.7 / 5.0    # PI controller exponents (Hairer II.4)
    pi_beta: float = 0.4 / 5.0
    fac_min: float = 0.2
    fac_max: float = 5.0
    accept_tol: float = 1.0
    stall_dt_factor: float = 1.0e3
    stall_count: float = 64.0
    ds_max: float = 0.0            # arc ceiling: not ported (ROADMAP A6)
    ds_local_knee: float = 0.0     # local arc ceiling: not ported (A6)
    ds_local_frac: float = 1.0
    ds_local_w: float = 0.1
    ds_local_shells: tuple = ()


class RayCarry(NamedTuple):
    """Per-ray integration state (see the JAX package's RayCarry for what
    each field means)."""

    u: torch.Tensor         # (B, n) state
    t: torch.Tensor         # (B,) phase path, scaled units
    dt: torch.Tensor        # (B,) current step size
    k1: torch.Tensor        # (B, n) du/dt at (t, u)   [FSAL carry]
    errold: torch.Tensor    # (B,) controller memory
    status: torch.Tensor    # (B,) events.* status code, int32
    n_accept: torch.Tensor  # (B,) int32
    n_reject: torch.Tensor  # (B,) int32
    u_prev: torch.Tensor    # (B, n) state at the start of the terminating step
    dt_prev: torch.Tensor   # (B,) size of the terminating step
    u_lo: torch.Tensor      # (B, n) compensated-summation residual of u
    rejected: torch.Tensor  # (B,) int32: previous attempt rejected
    n_tiny: torch.Tensor    # (B,) int32: consecutive tiny accepts
    caution: torch.Tensor   # (B,) int32: rejection-burst memory


class TraceResult(NamedTuple):
    u: torch.Tensor          # (B, n) final states
    t: torch.Tensor          # (B,) final phase path
    status: torch.Tensor     # (B,) status codes
    n_accept: torch.Tensor   # (B,)
    n_reject: torch.Tensor   # (B,)
    traj: Optional[Any] = None
    carry: Optional[Any] = None  # full RayCarry batch


# steppers whose attempts run inside the step kernel (ops/step_chunk.py)
KERNEL_STEPPERS = ("bs3", "dopri5")
_ORDER = {"bs3": 3.0, "dopri5": 5.0, "ros3pr": 3.0}


def check_supported(cfg: SolverConfig, group_idx: int, adaptive: bool,
                    stepper: str):
    """Raise on the _step_one options the port does not take yet."""
    if not adaptive:
        raise NotImplementedError(
            "fixed-step rk4 (adaptive=False) is not ported yet (ROADMAP B1 "
            "variants)"
        )
    if stepper not in _ORDER:
        raise NotImplementedError(
            f"stepper {stepper!r} is not ported yet (ROADMAP A10); the port "
            f"has {sorted(_ORDER)}"
        )
    if float(cfg.ds_max) != 0.0 or float(cfg.ds_local_knee) != 0.0:
        raise NotImplementedError(
            "the ds_max / ds_local arc ceilings are not ported yet "
            "(ROADMAP A6 and B1 variants)"
        )
    if group_idx != 3:
        raise NotImplementedError(
            "only the 4-state 2D frame (group_idx=3) is ported (the 3D frame "
            "is ROADMAP A7)"
        )


def init_carry(rhs_fn, u0, f, cfg: SolverConfig):
    """Initial carry for a batch; u0 (B, n), f (B,). One RHS per ray."""
    b = u0.shape[0]
    kw = dict(dtype=u0.dtype, device=u0.device)
    izero = torch.zeros(b, dtype=torch.int32, device=u0.device)
    return RayCarry(
        u=u0,
        t=torch.zeros(b, **kw),
        dt=torch.full((b,), cfg.dt0, **kw),
        k1=rhs_fn(u0, f),
        errold=torch.full((b,), 1.0e-4, **kw),
        status=izero,
        n_accept=izero,
        n_reject=izero,
        u_prev=u0,
        dt_prev=torch.full((b,), cfg.dt0, **kw),
        u_lo=torch.zeros_like(u0),
        rejected=izero,
        n_tiny=izero,
        caution=izero,
    )


def _jacobian_fn(rhs_fn, f):
    """u (B, n) -> (B, n, n) per-ray Jacobian of rhs_fn(., f) by forward-mode
    autodiff (the JAX package's jax.jacfwd under vmap)."""
    jac = torch.func.vmap(torch.func.jacfwd(rhs_fn, argnums=0))
    return lambda u: jac(u, f)


def _step_one(rhs_fn, carry: RayCarry, f, cfg: SolverConfig, spec: StopSpec,
              group_idx: int = 3, adaptive: bool = True,
              stepper: str = "dopri5"):
    """One attempted step for every ray of the batch; a no-op on rays that
    are not ACTIVE. The plain PyTorch form of what the step kernel runs
    per thread (csrc/step_chunk.cu)."""
    check_supported(cfg, group_idx, adaptive, stepper)
    active = carry.status == events.ACTIVE
    rhs1 = lambda u: rhs_fn(u, f)  # noqa: E731
    dt_eff = torch.clamp_max(carry.dt, cfg.dt_max)
    # do not overshoot the phase-path budget (CVODE integrates to tstop)
    dt_eff = torch.minimum(
        dt_eff, torch.clamp_min(spec.t_max - carry.t, cfg.dt_min)
    )
    order = _ORDER[stepper]
    if stepper == "bs3":
        out = bs3_step(rhs1, carry.u, carry.k1, dt_eff, cfg.rtol, cfg.atol)
    elif stepper == "dopri5":
        out = dopri5_step(rhs1, carry.u, carry.k1, dt_eff, cfg.rtol, cfg.atol)
    else:
        out = ros3pr_step(rhs1, carry.u, carry.k1, dt_eff, cfg.rtol,
                          cfg.atol, jac_fn=_jacobian_fn(rhs_fn, f))
    accept = out.err <= cfg.accept_tol

    t1 = carry.t + dt_eff
    status1 = events.classify_step(carry.u, out.u_new, t1, spec, group_idx)
    # an accepted step at the dt floor is a no-op in working precision:
    # flag the wedge unless a real stop already fired this step
    stalled = (status1 == events.ACTIVE) & (dt_eff <= cfg.dt_min * 2.0)
    status1 = torch.where(stalled, events.DT_UNDERFLOW, status1)
    terminal = (status1 == events.HIT_EARTH) | (status1 == events.HIT_EQUATOR)

    # PI controller; a non-finite error estimate is a hard rejection
    err = torch.where(
        torch.isfinite(out.err), torch.clamp_min(out.err, 1.0e-10),
        torch.full_like(out.err, 1.0e10),
    )
    log_err = torch.log(err)
    scale5 = 5.0 / order
    one = torch.ones_like(err)
    fac_cap = torch.where(
        carry.rejected > 0, one,
        torch.where(carry.caution > 8, one * 1.3, one * cfg.fac_max),
    )
    fac_acc = torch.minimum(
        torch.clamp_min(
            cfg.safety * torch.exp(
                scale5 * (-cfg.pi_alpha * log_err
                          + cfg.pi_beta * torch.log(carry.errold))
            ),
            cfg.fac_min,
        ),
        fac_cap,
    )
    fac_rej = torch.clamp(cfg.safety * torch.exp(-log_err / order), 0.05, 1.0)
    dt_next = torch.clamp(
        dt_eff * torch.where(accept, fac_acc, fac_rej), cfg.dt_min, cfg.dt_max
    )
    underflow = (~accept) & (dt_eff <= cfg.dt_min * (1.0 + 1.0e-6))
    errold_new = torch.where(accept, torch.clamp_min(err, 1.0e-4),
                             carry.errold)

    adv = active & accept
    status_new = torch.where(
        active,
        torch.where(
            accept, status1,
            torch.where(underflow, events.DT_UNDERFLOW, events.ACTIVE),
        ),
        carry.status,
    ).to(torch.int32)

    # device-side wedge retirement (SolverConfig.stall_dt_factor)
    tiny = (dt_eff < cfg.dt_min * cfg.stall_dt_factor) & (
        cfg.stall_dt_factor > 0
    )
    n_tiny_new = torch.where(
        adv, torch.where(tiny, carry.n_tiny + 1, 0), carry.n_tiny
    ).to(torch.int32)
    wedged = adv & (n_tiny_new >= cfg.stall_count) & (
        status_new == events.ACTIVE
    )
    status_new = torch.where(wedged, events.DT_UNDERFLOW, status_new).to(
        torch.int32
    )

    # compensated state update (fast two-sum)
    d = out.incr + carry.u_lo
    u_comp = carry.u + d
    u_lo_new = d - (u_comp - carry.u)

    snap = adv & terminal
    adv_c, snap_c = adv[:, None], snap[:, None]
    return RayCarry(
        u=torch.where(adv_c, u_comp, carry.u),
        t=torch.where(adv, t1, carry.t),
        dt=torch.where(active, dt_next, carry.dt),
        k1=torch.where(adv_c, out.k_end, carry.k1),
        errold=torch.where(active, errold_new, carry.errold),
        status=status_new,
        n_accept=carry.n_accept + adv.to(torch.int32),
        n_reject=carry.n_reject + (active & ~accept).to(torch.int32),
        u_prev=torch.where(snap_c, carry.u, carry.u_prev),
        dt_prev=torch.where(snap, dt_eff, carry.dt_prev),
        u_lo=torch.where(adv_c, u_lo_new, carry.u_lo),
        rejected=torch.where(active, (~accept).to(torch.int32),
                             carry.rejected),
        n_tiny=n_tiny_new,
        caution=torch.where(
            active,
            torch.clamp(carry.caution + torch.where(accept, -1, 4), 0, 60),
            carry.caution,
        ).to(torch.int32),
    )


def refine_events(rhs_fn, carry: RayCarry, f, spec: StopSpec):
    """One-shot post-pass event localization for the batch.

    For rays that ended on HIT_EARTH / HIT_EQUATOR, bisect the cubic
    Hermite interpolant of the snapshotted terminating step (k0 =
    rhs(u_prev), one extra eval per ray; k1 is the FSAL carry). With the
    equator stop off no ray can end on HIT_EQUATOR, so its bisection is
    skipped (the JAX package computes and discards it)."""
    is_surf = carry.status == events.HIT_EARTH
    is_eq = carry.status == events.HIT_EQUATOR
    k0 = rhs_fn(carry.u_prev, f)
    tau_s, u_s = events.refine_crossing(
        lambda uu: uu[..., 0] - spec.r_floor,
        carry.u_prev, k0, carry.u, carry.k1, carry.dt_prev,
    )
    u_fin = torch.where(is_surf[:, None], u_s, carry.u)
    tau = torch.where(is_surf, tau_s, torch.ones_like(tau_s))
    if spec.stop_at_equator > 0.5:
        tau_e, u_e = events.refine_crossing(
            lambda uu: events.lat_of(uu, spec),
            carry.u_prev, k0, carry.u, carry.k1, carry.dt_prev,
        )
        u_fin = torch.where(is_eq[:, None], u_e, u_fin)
        tau = torch.where(is_eq, tau_e, tau)
    t_fin = carry.t - (1.0 - tau) * carry.dt_prev
    return carry._replace(u=u_fin, t=t_fin)


def step_loop(rhs_fn, carry: RayCarry, f, cfg: SolverConfig, spec: StopSpec,
              *, group_idx=3, adaptive=True, stepper="dopri5", n_steps=0,
              check_every=64):
    """n_steps attempted `_step_one` steps as torch ops, leaving the loop
    once no ray is ACTIVE (checked every `check_every` steps; exact,
    since a step is a no-op on a ray that is not ACTIVE)."""
    for i in range(n_steps):
        if i % check_every == 0 and not bool(
            (carry.status == events.ACTIVE).any()
        ):
            break
        carry = _step_one(rhs_fn, carry, f, cfg, spec, group_idx, adaptive,
                          stepper)
    return carry


def trace(
    env,
    u0,
    f,
    *,
    cfg: SolverConfig = SolverConfig(),
    spec: StopSpec = StopSpec(),
    group_idx: int = 3,
    adaptive: bool = True,
    stepper: str = "dopri5",
    max_steps: int = 20000,
    save_every: int = 0,
    chunk: int = 64,
    carry0: Optional[RayCarry] = None,
    root: float = 1.0,
):
    """Integrate a batch of latitude-frame rays through `env`.

    u0: (B, 4) states (r, lat, chi, T); f: (B,) frequencies in Hz; both on
    the device and in the dtype the run uses. Final-state mode only.

    Each ray gets exactly ceil(max_steps / chunk) * chunk attempts unless
    it stops first -- the count the JAX package's chunked while_loop runs
    (integrate/solve.py:559-571) -- in ONE step-kernel launch for bs3 and
    dopri5. carry0 resumes from a RayCarry batch (MAX_STEPS rays re-arm).
    """
    if save_every:
        raise NotImplementedError(
            "the trajectory channel (save_every > 0) is not ported yet "
            "(ROADMAP A11)"
        )
    check_supported(cfg, group_idx, adaptive, stepper)
    rhs_fn = lambda u, ff: rhs_mod.rhs_2d_lat(u, ff, env, root=root)  # noqa: E731
    if carry0 is None:
        carry0 = init_carry(rhs_fn, u0, f, cfg)
    else:
        carry0 = carry0._replace(status=torch.where(
            carry0.status == events.MAX_STEPS, events.ACTIVE, carry0.status
        ).to(torch.int32))

    n_steps = -(-max_steps // chunk) * chunk
    if stepper in KERNEL_STEPPERS:
        from ..ops.step_chunk import step_chunk

        carry = step_chunk(carry0, f, env, cfg, spec, stepper=stepper,
                           n_steps=n_steps, root=root)
    else:
        carry = step_loop(rhs_fn, carry0, f, cfg, spec, group_idx=group_idx,
                          adaptive=adaptive, stepper=stepper,
                          n_steps=n_steps, check_every=chunk)

    # rays alive at budget exhaustion report MAX_STEPS, never ACTIVE
    carry = carry._replace(status=torch.where(
        carry.status == events.ACTIVE, events.MAX_STEPS, carry.status
    ).to(torch.int32))
    carry = refine_events(rhs_fn, carry, f, spec)
    return TraceResult(
        u=carry.u, t=carry.t, status=carry.status,
        n_accept=carry.n_accept, n_reject=carry.n_reject, carry=carry,
    )
