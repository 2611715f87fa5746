"""Batched ray integration driver (port of raytrace_tpu/integrate/solve.py).

Every ray carries its own (t, dt, status, controller memory), so an
adaptive batch diverges freely; stop conditions are per-ray status codes.
The carry is a `RayCarry` of tensors with the ray axis first: vectors are
(B, n), per-ray scalars (B,), the JAX package's layouts.

`trace` advances rays of a frame (`ops.rhs.frame_rhs`: the 2D latitude
frame's `rhs_2d_lat`, the 2D colatitude frame's `rhs_2d_colat` or the 3D
frame's `rhs_3d`, over a medium `env`), to final states or (save_every >
0) with the trajectory channel. The explicit pairs (bs3, dopri5) and
fixed-step rk4 (adaptive=False) step through `ops.step_chunk`, one launch
per call or per snapshot block: the hand-written
CUDA kernel on a CUDA tensor, its plain PyTorch loop of `_step_one` on a
CPU tensor. heun2 and the Rosenbrock steppers (ros2, ros2x, ros3pr, ros4x;
the auto mode's stiff pool) step as torch ops on the tensors' device, as
the Pallas kernel never runs them. The right-hand side carries the
gradient set (`grad_mode`) and, in the 2D frames, `legacy_freq_state`.
The first right-hand side (`init_carry`) and the event refinement
(`refine_events`), torch ops around the Pallas kernel in the JAX package,
run inside the step kernel's launch of a final-states trace (its `fresh`
and `finish` flags); the trajectory channel, `trace_rhs` and the
torch-op steppers keep `refine_events` as a post-pass.
"""

from typing import Any, NamedTuple, Optional

import torch

from ..constants import RE
from ..ops import rhs as rhs_mod
from . import events
from .events import StopSpec
from .graph import GraphLoop
from .steppers import (
    bs3_step, dopri5_step, heun21_step, rk4_step, ros2_step, ros2x_step,
    ros3pr_step, ros4x_step,
)


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
    ds_max: float = 0.0            # arc-length step ceiling (RE); 0 = off
    ds_local_knee: float = 0.0     # > 0: the local arc ceiling, knee L-shell
    ds_local_frac: float = 1.0     # local ceiling = frac * gradient length
    ds_local_w: float = 0.1        # the knee's width (RE)
    ds_local_shells: tuple = ()    # further ((L, width), ...) sharp shells


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


# adaptive steppers whose attempts run inside the step kernel
# (ops/step_chunk.py); fixed-step rk4 (adaptive=False) runs there too
KERNEL_STEPPERS = ("bs3", "dopri5")
_ORDER = {"bs3": 3.0, "dopri5": 5.0, "heun2": 2.0, "ros2": 2.0,
          "ros2x": 3.0, "ros3pr": 3.0, "ros4x": 4.0}
# the steppers run as torch ops: (step function, takes the Jacobian)
_TORCH_STEPPERS = {
    "heun2": (heun21_step, False), "ros2": (ros2_step, True),
    "ros2x": (ros2x_step, True), "ros3pr": (ros3pr_step, True),
    "ros4x": (ros4x_step, True),
}


def check_supported(cfg: SolverConfig, group_idx: int, adaptive: bool,
                    stepper: str):
    """Raise on the _step_one options the port does not take yet. With
    adaptive=False every ray takes fixed rk4 steps, whatever `stepper`
    names (as in the JAX package)."""
    if adaptive and stepper not in _ORDER:
        raise ValueError(
            f"unknown stepper {stepper!r}; the steppers are "
            f"{sorted(_ORDER)}"
        )
    if group_idx not in (3, 6):
        raise NotImplementedError(
            "the port has the 4-state frame (group_idx=3) and the 7-state "
            f"3D frame (group_idx=6); got group_idx={group_idx}"
        )


def init_carry(rhs_fn, u0, f, cfg: SolverConfig):
    """Initial carry for a batch; u0 (B, n), f (B,). One RHS per ray;
    rhs_fn None leaves k1 zero, for a step-kernel launch with `fresh` to
    form (ops.step_chunk.step_chunk)."""
    b = u0.shape[0]
    kw = dict(dtype=u0.dtype, device=u0.device)
    izero = torch.zeros(b, dtype=torch.int32, device=u0.device)
    return RayCarry(
        u=u0,
        t=torch.zeros(b, **kw),
        dt=torch.full((b,), cfg.dt0, **kw),
        k1=torch.zeros_like(u0) if rhs_fn is None else rhs_fn(u0, f),
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


def _local_arc_ceiling(u, spec: StopSpec, cfg: SolverConfig):
    """Arc-length ceiling from a local gradient-length estimate of the
    medium: r/4.5 (the L^-4.5 plasmasphere and the r^-3 dipole), tightened
    near each sharp shell -- the knee (ds_local_knee, ds_local_w) and the
    ds_local_shells -- to w + |r - L cos^2(lat)|, the radial distance to
    the shell at the ray's latitude (events.lat_of) floored by its width;
    times ds_local_frac."""
    r = u[..., 0]
    g = r * (1.0 / 4.5)
    c = torch.cos(events.lat_of(u, spec))
    c2 = c * c
    shells = ((cfg.ds_local_knee, cfg.ds_local_w),) + tuple(
        cfg.ds_local_shells)
    for shell_l, shell_w in shells:
        g = torch.minimum(g, shell_w + torch.abs(r - shell_l * c2))
    return cfg.ds_local_frac * g


def _arc_rate(u, k1):
    """Spatial speed ds/dtau of each ray from the FSAL derivative carry:
    ds^2 = dr^2 + (r dlat)^2 in the 4-state frames, plus (r sin(theta)
    dphi)^2 in the 7-state frame."""
    r = u[..., 0]
    s2 = k1[..., 0] * k1[..., 0] + (r * k1[..., 1]) * (r * k1[..., 1])
    if u.shape[-1] >= 7:
        vp = r * torch.sin(u[..., 1]) * k1[..., 2]
        s2 = s2 + vp * vp
    return torch.sqrt(s2)


def _step_one(rhs_fn, carry: RayCarry, f, cfg: SolverConfig, spec: StopSpec,
              group_idx: int = 3, adaptive: bool = True,
              stepper: str = "dopri5"):
    """One attempted step for every ray of the batch; a no-op on rays that
    are not ACTIVE. The plain PyTorch form of what the step kernel runs
    per thread (csrc/step_chunk.cu). adaptive=False takes one fixed rk4
    step of the carry's dt: no ceiling, always accepted, no stall flag,
    dt, errold and n_tiny kept (as in the JAX package)."""
    check_supported(cfg, group_idx, adaptive, stepper)
    active = carry.status == events.ACTIVE
    rhs1 = lambda u: rhs_fn(u, f)  # noqa: E731
    # step ceiling (adaptive only): the phase-path dt_max, tightened by the
    # arc-length ceiling ds / (ds/dtau), where ds is the local ceiling
    # (ds_local_knee > 0; clamped by ds_max where that is > 0 too) or
    # ds_max > 0. dt_next is clamped to the same dt_cap. ds_max divides as
    # a tensor: a Python-scalar numerator would become a reciprocal
    # product, which rounds otherwise than the kernel's quotient
    dt_cap = cfg.dt_max
    if adaptive and (cfg.ds_max > 0.0 or cfg.ds_local_knee > 0.0):
        if cfg.ds_local_knee > 0.0:
            ds = _local_arc_ceiling(carry.u, spec, cfg)
            if cfg.ds_max > 0.0:
                ds = torch.clamp_max(ds, cfg.ds_max)
        else:
            ds = torch.full_like(carry.t, cfg.ds_max)
        rate = torch.clamp_min(_arc_rate(carry.u, carry.k1), 1e-30)
        arc_cap = torch.clamp_min(ds / rate, cfg.dt_min)
        dt_cap = torch.clamp_max(arc_cap, cfg.dt_max)
    dt_eff = torch.clamp_max(carry.dt, dt_cap) if adaptive else carry.dt
    # do not overshoot the phase-path budget (CVODE integrates to tstop)
    dt_eff = torch.minimum(
        dt_eff, torch.clamp_min(spec.t_max - carry.t, cfg.dt_min)
    )
    if not adaptive:
        return _step_fixed(rhs1, carry, dt_eff, spec, group_idx, active)
    order = _ORDER[stepper]
    if stepper == "bs3":
        out = bs3_step(rhs1, carry.u, carry.k1, dt_eff, cfg.rtol, cfg.atol)
    elif stepper == "dopri5":
        out = dopri5_step(rhs1, carry.u, carry.k1, dt_eff, cfg.rtol, cfg.atol)
    else:
        step_fn, jac = _TORCH_STEPPERS[stepper]
        kw = {"jac_fn": _jacobian_fn(rhs_fn, f)} if jac else {}
        out = step_fn(rhs1, carry.u, carry.k1, dt_eff, cfg.rtol, cfg.atol,
                      **kw)
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
    dt_next = torch.clamp_max(
        torch.clamp_min(dt_eff * torch.where(accept, fac_acc, fac_rej),
                        cfg.dt_min),
        dt_cap,
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


def _step_fixed(rhs1, carry: RayCarry, dt_eff, spec: StopSpec, group_idx,
                active):
    """_step_one's adaptive=False branch: one rk4 step, always accepted;
    the controller's memory stays, caution still counts down."""
    out = rk4_step(rhs1, carry.u, carry.k1, dt_eff)
    t1 = carry.t + dt_eff
    status1 = events.classify_step(carry.u, out.u_new, t1, spec, group_idx)
    terminal = (status1 == events.HIT_EARTH) | (status1 == events.HIT_EQUATOR)
    d = out.incr + carry.u_lo
    u_comp = carry.u + d
    u_lo_new = d - (u_comp - carry.u)
    snap = active & terminal
    act_c, snap_c = active[:, None], snap[:, None]
    return carry._replace(
        u=torch.where(act_c, u_comp, carry.u),
        t=torch.where(active, t1, carry.t),
        k1=torch.where(act_c, out.k_end, carry.k1),
        status=torch.where(active, status1, carry.status).to(torch.int32),
        n_accept=carry.n_accept + active.to(torch.int32),
        u_prev=torch.where(snap_c, carry.u, carry.u_prev),
        dt_prev=torch.where(snap, dt_eff, carry.dt_prev),
        u_lo=torch.where(act_c, u_lo_new, carry.u_lo),
        rejected=torch.where(active, 0, carry.rejected).to(torch.int32),
        caution=torch.where(active, torch.clamp(carry.caution - 1, 0, 60),
                            carry.caution).to(torch.int32),
    )


def refine_events(rhs_fn, carry: RayCarry, f, spec: StopSpec):
    """One-shot post-pass event localization for the batch.

    For rays that ended on HIT_EARTH / HIT_EQUATOR, bisect the cubic
    Hermite interpolant of the snapshotted terminating step (k0 =
    rhs(u_prev), one extra eval per ray; k1 is the FSAL carry). With the
    equator stop off no ray can end on HIT_EQUATOR, so its bisection is
    skipped (the JAX package computes and discards it). The step kernel
    runs the same for a launch with `finish` (csrc/step_chunk.cu:
    refine_event)."""
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
    frame: str = "2d_lat",
    cfg: SolverConfig = SolverConfig(),
    spec: StopSpec = StopSpec(),
    adaptive: bool = True,
    stepper: str = "dopri5",
    max_steps: int = 20000,
    save_every: int = 0,
    save_fn=None,
    chunk: int = 64,
    carry0: Optional[RayCarry] = None,
    root: float = 1.0,
    grad_mode: str = "fused",
    legacy_freq_state: bool = False,
):
    """Integrate a batch of rays of `frame` through `env`.

    u0: (B, n) states -- (r, lat, chi, T) in the "2d_lat" frame, (r,
    theta, phi, rho_r, rho_theta, rho_phi, T) in the "3d" frame; f: (B,)
    frequencies in Hz; both on the device and in the dtype the run uses.

    save_every == 0: final states only. Each ray gets exactly
    ceil(max_steps / chunk) * chunk attempts unless it stops first -- the
    count the JAX package's chunked while_loop runs (integrate/solve.py:
    559-571) -- in ONE step-kernel launch for bs3, dopri5 and
    (adaptive=False, whatever `stepper` says) rk4, which also forms the
    first k1 (without carry0) and refines the events (step_chunk's
    `fresh` and `finish`): the trace's end is that launch.

    save_every > 0: the trajectory channel (the reference's
    SavingCallback, RayTrace_lat.jl:318-330). ceil(max_steps /
    save_every) blocks of exactly save_every attempts each, one kernel
    launch per block on a carry that stays in the kernel's layout
    (ops.step_chunk.ResidentCarry); after each block the carry's u, t and
    status are copied into a preallocated (n_outer, B, ...) buffer on the
    device, and save_fn(u, f) -- batched over the snapshots, e.g.
    saving.save_fn_for's (mu, dmu/dpsi, dip, psi) -- adds "extras",
    computed once over all snapshots. traj holds the unrefined carry of
    each block, as the JAX package's scan does; once no ray is ACTIVE
    (checked every `chunk` attempts) the remaining rows are the frozen
    state, which is what the scan records.

    carry0 resumes from a RayCarry batch (MAX_STEPS rays re-arm).
    grad_mode and legacy_freq_state select the right-hand side
    (ops.rhs.frame_rhs) that init_carry, the steps, the stiff steppers'
    Jacobian and refine_events all see.
    """
    rhs_fn, group_idx = rhs_mod.frame_rhs(frame, env, root, grad_mode,
                                          legacy_freq_state)
    check_supported(cfg, group_idx, adaptive, stepper)
    if save_every < 0:
        raise ValueError(f"save_every must be >= 0; got {save_every}")
    on_kernel = stepper in KERNEL_STEPPERS or not adaptive
    # the step kernel's first launch forms the first k1 itself (the
    # trajectory channel has none where max_steps is 0)
    fresh = carry0 is None and on_kernel and (save_every == 0
                                              or max_steps > 0)
    if carry0 is None:
        carry0 = init_carry(None if fresh else rhs_fn, u0, f, cfg)
    else:
        carry0 = carry0._replace(status=torch.where(
            carry0.status == events.MAX_STEPS, events.ACTIVE, carry0.status
        ).to(torch.int32))

    kernel_kw = dict(stepper=stepper, root=root, adaptive=adaptive,
                     frame=frame, grad_mode=grad_mode,
                     legacy_freq_state=legacy_freq_state)
    traj = None
    refined = False
    if save_every == 0:
        n_steps = -(-max_steps // chunk) * chunk
        if on_kernel:
            from ..ops.step_chunk import step_chunk

            carry = step_chunk(carry0, f, env, cfg, spec, n_steps=n_steps,
                               finish=True, fresh=fresh, **kernel_kw)
            refined = True
        else:
            carry = step_loop(rhs_fn, carry0, f, cfg, spec,
                              group_idx=group_idx, adaptive=adaptive,
                              stepper=stepper, n_steps=n_steps,
                              check_every=chunk)
    else:
        carry, traj = _trace_blocks(rhs_fn, group_idx, carry0, f, env, cfg,
                                    spec, -(-max_steps // save_every),
                                    save_every, save_fn, chunk, on_kernel,
                                    kernel_kw, fresh)

    return _finish(rhs_fn, carry, f, spec, traj, refined)


def _finish(rhs_fn, carry: RayCarry, f, spec: StopSpec, traj=None,
            refined=False):
    """A trace's end: rays alive at budget exhaustion report MAX_STEPS,
    never ACTIVE, and the terminal events are refined, here unless the
    step kernel's last launch has refined them (`refined`; the mapping
    and the refinement touch disjoint rays, so their order is free)."""
    carry = carry._replace(status=torch.where(
        carry.status == events.ACTIVE, events.MAX_STEPS, carry.status
    ).to(torch.int32))
    if not refined:
        carry = refine_events(rhs_fn, carry, f, spec)
    return TraceResult(
        u=carry.u, t=carry.t, status=carry.status,
        n_accept=carry.n_accept, n_reject=carry.n_reject, traj=traj,
        carry=carry,
    )


def trace_rhs(rhs_fn, u0, f, *, cfg: SolverConfig = SolverConfig(),
              spec: StopSpec = StopSpec(), group_idx: int = 3,
              adaptive: bool = True, stepper: str = "dopri5",
              max_steps: int = 20000, chunk: int = 64, graph: bool = True):
    """`trace` over a caller's right-hand side rhs_fn(u, f) (the JAX
    package's trace(rhs_fn, u0, f, ...), final states only), as torch ops
    on the tensors' device: init_carry, ceil(max_steps / chunk) * chunk
    attempts of `_step_one` (leaving once no ray is ACTIVE, checked every
    16 attempts: exact, since an attempt is a no-op on a ray that is not
    ACTIVE), refine_events. The state may be wider than the
    frame's (the variational system of sensitivity.py carries tangent
    columns after it): the stop events read the frame's components
    (group_idx names the group delay), while the error norm, the arc
    ceiling's rate and the event refinement take the whole state, as in
    the JAX package.

    On CUDA tensors with `graph`, one attempt is captured once as a CUDA
    graph over a copy of the carry and replayed for every attempt: the
    same kernels in the same order as the eager loop (so the same
    values), without the host's cost of launching thousands of small
    kernels an attempt one by one."""
    check_supported(cfg, group_idx, adaptive, stepper)
    carry = init_carry(rhs_fn, u0, f, cfg)
    n_steps = -(-max_steps // chunk) * chunk
    if graph and u0.device.type == "cuda":
        carry = _graph_loop(rhs_fn, carry, f, cfg, spec, group_idx,
                            adaptive, stepper, n_steps, 16)
    else:
        carry = step_loop(rhs_fn, carry, f, cfg, spec, group_idx=group_idx,
                          adaptive=adaptive, stepper=stepper,
                          n_steps=n_steps, check_every=16)
    return _finish(rhs_fn, carry, f, spec)


def _graph_loop(rhs_fn, carry: RayCarry, f, cfg, spec, group_idx, adaptive,
                stepper, n_steps, check_every):
    """step_loop through a CUDA graph of one `_step_one` that updates a
    static carry in place (fresh buffers: init_carry's fields share
    storage): graph.GraphLoop, leaving once no ray is ACTIVE."""
    static = RayCarry(*(x.clone() for x in carry))
    fs = f.clone()
    loop = GraphLoop(lambda c: _step_one(rhs_fn, c, fs, cfg, spec, group_idx,
                                         adaptive, stepper), static)
    return loop.run(n_steps, check_every=check_every,
                    until=lambda c: ~(c.status == events.ACTIVE).any())


def _trace_blocks(rhs_fn, group_idx, carry0, f, env, cfg, spec, n_outer,
                  save_every, save_fn, chunk, on_kernel, kernel_kw,
                  fresh=False):
    """trace's trajectory channel: n_outer blocks of save_every attempts,
    a snapshot after each (the first launch forms k1 where `fresh`; the
    snapshots hold the unrefined carry, so the refinement stays a
    post-pass). Returns (carry, traj)."""
    b, n = carry0.u.shape
    traj = {
        "u": carry0.u.new_empty((n_outer, b, n)),
        "t": carry0.t.new_empty((n_outer, b)),
        "status": carry0.status.new_empty((n_outer, b)),
    }
    if on_kernel:
        from ..ops.step_chunk import ResidentCarry

        resident = ResidentCarry(carry0, f, env, cfg, spec, **kernel_kw)
    carry = carry0
    check = max(1, chunk // save_every)
    k = 0
    while k < n_outer:
        if k % check == 0 and k > 0 and not bool(
                (carry.status == events.ACTIVE).any()):
            # every ray has stopped: the rows left are the frozen state
            for name in traj:
                traj[name][k:] = traj[name][k - 1]
            break
        if on_kernel:
            resident.advance(save_every, fresh=fresh and k == 0)
            carry = resident.carry()
        else:
            carry = step_loop(rhs_fn, carry, f, cfg, spec,
                              group_idx=group_idx,
                              adaptive=kernel_kw["adaptive"],
                              stepper=kernel_kw["stepper"],
                              n_steps=save_every, check_every=chunk)
        traj["u"][k] = carry.u
        traj["t"][k] = carry.t
        traj["status"][k] = carry.status
        k += 1
    if save_fn is not None:
        flat = traj["u"].reshape(n_outer * b, n)
        extras = save_fn(flat, f.repeat(n_outer))
        traj["extras"] = extras.reshape(n_outer, b, extras.shape[-1])
    return carry, traj
