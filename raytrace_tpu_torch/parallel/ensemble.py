"""Launch grids, the single-program tracer and the bucketed rounds tracer
(port of raytrace_tpu/parallel/ensemble.py, one device a process).

A LaunchSpec builds the 2D (latitude x wave-normal angle x frequency)
grid (run.py turns its latitudes into colatitudes for the colatitude
frame), `build_launch_list` a 2D launch from an explicit ray list,
`build_launch_3d` the 3D (latitude x longitude x wave-normal angle x
frequency) grid, and the batch is padded to a multiple of 8.
`make_ensemble_tracer` traces it in one `trace` call; `make_rounds_tracer`
integrates it in rounds: after each round the still-active rays are
gathered into the next power-of-two bucket ON THE DEVICE and continue
from their exact RayCarry. The whole carry rides one packed float tensor
that stays on the device across rounds; per round the host reads only
four bookkeeping columns (t, status, n_accept, n_reject) and sends back
an index list (and, with the trajectory channel, the round's snapshot
block).
"""

from time import perf_counter as _clock
from typing import NamedTuple

import numpy as np
import torch

from ..constants import RE
from ..integrate import events
from ..integrate.solve import (
    _ORDER, RayCarry, SolverConfig, TraceResult, trace,
)
from ..integrate.events import StopSpec
from ..ops.rhs import frame_rhs

# status code used for padding lanes (distinct from every events.* code)
PAD_STATUS = 100


class LaunchSpec(NamedTuple):
    """Host-side launch grid: rays at every (lat0, chi0, freq) combination
    (the canonical ICs of RayTrace_lat.jl:333 generalized to a fan)."""

    r0: float = (RE + 1.0e6) / RE
    lats: tuple = (np.pi / 4,)
    chis: tuple = (0.0,)
    freqs: tuple = (1000.0,)


def build_launch(spec: LaunchSpec, dtype=np.float32):
    """(u0 (N,4), f (N,)) numpy arrays for the 2D latitude-frame state."""
    lat, chi, fr = np.meshgrid(
        np.asarray(spec.lats, np.float64),
        np.asarray(spec.chis, np.float64),
        np.asarray(spec.freqs, np.float64),
        indexing="ij",
    )
    n = lat.size
    u0 = np.zeros((n, 4), dtype)
    u0[:, 0] = spec.r0
    u0[:, 1] = lat.ravel()
    u0[:, 2] = chi.ravel()
    return u0, fr.ravel().astype(dtype)


def build_launch_list(rays, r0=(RE + 1.0e6) / RE, dtype=np.float32):
    """(u0 (N,4), f (N,)) numpy arrays from an explicit per-ray list of
    (lat, chi, freq) triples, the `ray_start.dat` input style the
    reference planned (README.md:11). Accepts any array-like of shape
    (N, 3); an entry may carry a 4th column, its r0."""
    rows = []
    for r in rays:
        r = list(map(float, r))
        if len(r) == 3:
            r.append(float(r0))
        if len(r) != 4:
            raise ValueError("each ray must be (lat, chi, freq[, r0])")
        rows.append(r)
    rays = np.asarray(rows, np.float64)
    u0 = np.zeros((rays.shape[0], 4), dtype)
    u0[:, 0] = rays[:, 3]
    u0[:, 1] = rays[:, 0]
    u0[:, 2] = rays[:, 1]
    return u0, rays[:, 2].astype(dtype)


def build_launch_3d(r0, lats, phis, chis, freqs, rho0, dtype=np.float32):
    """(u0 (N,7), f (N,)) numpy arrays for the 3D frame, rays in the order
    of itertools.product(lats, phis, chis, freqs) (the JAX package's
    run._build_u0). Each chi rotates the rho0 direction within the launch
    meridional plane (positive chi tilts r-hat toward theta-hat); chi = 0
    keeps rho0 exactly. rho0 is a direction here: run.py puts it on the
    dispersion surface when asked to."""
    pr, pt, pp = (float(x) for x in rho0)
    # cos/sin per chi as numpy scalar calls, the JAX package's values
    c = np.array([np.cos(chi) for chi in chis], np.float64)
    s = np.array([np.sin(chi) for chi in chis], np.float64)
    lat, phi, ci, fr = np.meshgrid(
        np.asarray(lats, np.float64), np.asarray(phis, np.float64),
        np.arange(len(chis)), np.asarray(freqs, np.float64), indexing="ij",
    )
    ci = ci.ravel()
    u0 = np.zeros((ci.size, 7), dtype)
    u0[:, 0] = r0
    u0[:, 1] = np.pi / 2 - lat.ravel()
    u0[:, 2] = phi.ravel()
    u0[:, 3] = c[ci] * pr - s[ci] * pt
    u0[:, 4] = s[ci] * pr + c[ci] * pt
    u0[:, 5] = pp
    return u0, fr.ravel().astype(dtype)


def pad_batch(u0, f, multiple=8):
    """Pad (u0, f) to a multiple of `multiple` rays; returns
    (u0, f, valid_mask). Padding rays copy ray 0 and are excluded from
    statistics via the mask."""
    n = u0.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad != n:
        u0 = np.concatenate([u0, np.repeat(u0[:1], n_pad - n, axis=0)])
        f = np.concatenate([f, np.repeat(f[:1], n_pad - n)])
    valid = np.arange(n_pad) < n
    return u0, f, valid


def _bucket_size(n_active, n_full, floor):
    """Smallest power-of-two multiple of `floor` that holds n_active."""
    b = floor
    while b < n_active:
        b *= 2
    return min(b, n_full)


# --- packed carry transport ----------------------------------------------
# The whole RayCarry packed into ONE (B, 4n + 5 + 6) float tensor of the
# carry dtype. The int32 fields ride along exactly as floats: every value
# is bounded by max_steps < 2^24, inside the float32 mantissa (guarded in
# make_rounds_tracer).

_INT_FIELDS = (
    "status", "n_accept", "n_reject", "rejected", "n_tiny", "caution",
)
_VEC_FIELDS = ("u", "k1", "u_prev", "u_lo")          # (B, n) in state order
_SCALAR_FIELDS = ("t", "dt", "errold", "dt_prev")    # (B,)
# packed column index of t (after the 4 state-vector blocks):
T_OF = {"t": 0, "dt": 1, "errold": 2, "dt_prev": 3, "f": 4}
# int columns live after the float scalars + f:
I_OF = {name: 5 + i for i, name in enumerate(_INT_FIELDS)}


def pack_carry(carry: RayCarry, f):
    """(carry, f) -> one (B, 4n + 5 + 6) tensor of the carry dtype."""
    cols = [getattr(carry, name) for name in _VEC_FIELDS]
    cols += [getattr(carry, name)[:, None] for name in _SCALAR_FIELDS]
    cols.append(f[:, None])
    cols += [getattr(carry, name)[:, None].to(f.dtype) for name in _INT_FIELDS]
    return torch.cat(cols, dim=1)


def unpack_carry(fl, state_dim):
    """Inverse of pack_carry, for a tensor or a numpy array (host fetch).

    Returns (RayCarry, f)."""
    n = state_dim
    if isinstance(fl, np.ndarray):
        to_int = lambda x: x.astype(np.int32)  # noqa: E731
    else:
        to_int = lambda x: x.to(torch.int32)  # noqa: E731
    kw = {name: fl[:, i * n:(i + 1) * n] for i, name in enumerate(_VEC_FIELDS)}
    base = len(_VEC_FIELDS) * n
    kw.update((name, fl[:, base + T_OF[name]]) for name in _SCALAR_FIELDS)
    f = fl[:, base + T_OF["f"]]
    kw.update((name, to_int(fl[:, base + I_OF[name]])) for name in _INT_FIELDS)
    return RayCarry(**kw), f


def packed_state_dim(fl):
    """State dimension n from a packed array's column count."""
    return (fl.shape[1] - 5 - len(_INT_FIELDS)) // 4


def _fetch_later(x):
    """Start copying tensor x to the host; returns a function that waits
    for the copy and gives it as a numpy array. On the card the copy goes
    to pinned memory behind the work queued so far on x's stream, so the
    host can queue more work before it waits; on the CPU x is read when
    asked for (the caller passes a tensor nothing writes afterwards)."""
    if x.device.type != "cuda":
        return x.numpy
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


def _fetch_block(traj, rows):
    """[(field, _fetch_later of its first `rows` lanes)] of a snapshot
    block (the real rays of a bucket)."""
    return [(k, _fetch_later(v[:, :rows])) for k, v in traj.items()]


def make_ensemble_tracer(
    env,
    *,
    device="cuda",
    dtype,
    frame="2d_lat",
    cfg: SolverConfig = SolverConfig(),
    spec: StopSpec = StopSpec(),
    adaptive: bool = True,
    stepper: str = "dopri5",
    max_steps: int = 20000,
    chunk: int = 64,
    grad_mode="fused",
    root=1.0,
    legacy_freq_state: bool = False,
    save_every: int = 0,
    save_fn=None,
):
    """The single-program tracer (the JAX package's make_ensemble_tracer,
    parallel/ensemble.py:124-160): run(u0, f) -> TraceResult of one
    `trace` call over the whole batch on `device` in `dtype` (u0 and f,
    numpy arrays or tensors, are cast to them); the result's tensors stay
    on the device. save_every > 0 turns on the trajectory channel, whose
    whole history then lives on the device (integrate.solve.trace). The
    JAX package's `mesh` (ray sharding over chips) has no counterpart: a
    process drives one card, and several cards take one process each
    (parallel/distributed.py)."""
    if grad_mode == "autodiff":
        raise NotImplementedError(
            "grad_mode='autodiff' is not a step-kernel variant (ROADMAP B7)")
    frame_rhs(frame, env, root, grad_mode, legacy_freq_state)
    device = torch.device(device)

    def run(u0, f):
        return trace(
            env, torch.as_tensor(u0).to(device=device, dtype=dtype),
            torch.as_tensor(f).to(device=device, dtype=dtype), frame=frame,
            cfg=cfg, spec=spec, adaptive=adaptive, stepper=stepper,
            max_steps=max_steps, chunk=chunk, save_every=save_every,
            save_fn=save_fn, root=root, grad_mode=grad_mode,
            legacy_freq_state=legacy_freq_state,
        )

    return run


def make_rounds_tracer(
    env,
    *,
    device="cuda",
    dtype,
    frame="2d_lat",
    cfg: SolverConfig = SolverConfig(),
    spec: StopSpec = StopSpec(),
    adaptive: bool = True,
    stepper: str = "auto",
    max_steps: int = 20000,
    round_steps=(2048, 2048, 1024),
    chunk: int = 512,
    grad_mode="fused",
    root=1.0,
    bucket_floor: int = 256,
    stall_progress: float = 1.0e-3,
    stiff_switch: float = 0.5,
    stiff_unswitch: float = 0.02,
    stiff_stepper: str = "ros3pr",
    base_stepper: str = "dopri5",
    order_switch_dt: float = 0.0,
    order_unswitch_dt: float = 0.5,
    tail_stepper: str = "",
    want_carry: bool = True,
    pipeline: int = 1,
    legacy_freq_state: bool = False,
    save_every: int = 0,
    save_fn=None,
):
    """Ensemble tracer with bucketed re-batching; returns run(u0, f, valid).

    Semantics of the JAX package's make_rounds_tracer: stepper="auto" runs
    every ray on `base_stepper` and moves a ray whose rejection fraction
    over a round exceeds `stiff_switch` into the `stiff_stepper` pool
    (back when it falls below `stiff_unswitch`); rays whose phase path
    advanced less than `stall_progress` over a round retire as
    DT_UNDERFLOW; once the active set no longer halves (n_active * 4 <=
    floor) the rest of the budget runs as one merged-tail round. Each
    round is one `trace` call, i.e. one step-kernel launch per pool.

    frame: "2d_lat" or "2d_colat" (4-state) or "3d" (7-state).
    adaptive=False steps every pool with fixed rk4 at the carry's dt (which
    then never rejects, so no ray turns stiff). device/dtype: where and
    in what precision the carry lives (the card unless the caller asks for
    the CPU); u0 and f are cast to them. The returned TraceResult holds numpy arrays (the
    final fetch); `run.last_rounds` and `run.last_stiff` record per-round
    diagnostics and which rays ended on the stiff pool.

    grad_mode ("fused" or "reference") and legacy_freq_state (2D only)
    select the right-hand side of every pool (ops.rhs.frame_rhs); the
    autodiff gradient set, which the step kernel does not compute, stays
    refused here (ROADMAP B7).

    save_every > 0 turns on the trajectory channel (the JAX package's,
    parallel/ensemble.py:369-411): each round's `trace` records a snapshot
    block (u, t, status [, save_fn extras]) every save_every attempts,
    which comes back to the host once per round, so the device holds one
    round's block, never the whole history. The host scatters each ray's
    rows at its own cursor (the pools advance at their own budgets; pad
    lanes are dropped) and fills the rows past a ray's cursor with its
    last row, the frozen state the single-shot trace(save_every=...)
    records for a stopped ray: with a pinned stepper the assembled
    trajectory equals the single-shot one bit for bit. Every round length
    and max_steps must be multiples of save_every (ValueError otherwise),
    and the stiff pool's round cap is rounded down to the cadence.

    Three scheduling knobs (the JAX package's, parallel/ensemble.py:
    281-367), all off by default:

    - pipeline: the most parts a pool's index set of a round is split into
      (power-of-two multiples of the bucket floor, `_split_parts`). Every
      part of every pool of a round is launched before any bookkeeping
      comes back to the host (each part's columns copy to pinned host
      memory behind its own launch on the stream), so the host's work on
      part k overlaps the card's on part k + 1. Per-ray results do not
      depend on the split.
    - order_switch_dt > 0 (auto mode with a base other than dopri5): a
      third pool runs dopri5 for accuracy-limited rays, those whose mean
      accepted dt over a round falls below order_switch_dt * dt_max at a
      rejection fraction below stiff_switch; a ray returns to the base
      once its mean dt exceeds order_unswitch_dt * dt_max. Refused with
      cfg.ds_max (ValueError: the dt_max-relative thresholds do not hold
      under an arc-length ceiling). `run.last_slow` records which rays
      ended on that pool.
    - tail_stepper (auto mode only): the non-stiff pool's method for the
      merged-tail round ("" keeps base_stepper).

    `run.last_rounds` records each launch's stepper, active rays, bucket,
    attempts and wall."""
    if grad_mode == "autodiff":
        raise NotImplementedError(
            "grad_mode='autodiff' is not ported to the rounds tracer: the "
            "step kernel does not compute the autodiff gradient set "
            "(ROADMAP B7)")
    if grad_mode not in ("fused", "reference"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    for st in ((stepper if stepper != "auto" else base_stepper),
               stiff_stepper, tail_stepper or base_stepper):
        if adaptive and st not in _ORDER:
            raise ValueError(f"unknown stepper {st!r}; the steppers are "
                             f"{sorted(_ORDER)}")
    # the 3D frame refuses legacy_freq_state (the JAX message)
    frame_rhs(frame, env, root, grad_mode, legacy_freq_state)
    if max_steps >= (1 << 24):
        raise ValueError(
            "max_steps must stay below 2^24 so the step counters ride the "
            "packed float transport exactly"
        )
    device = torch.device(device)
    schedule = (
        tuple(round_steps) if isinstance(round_steps, (tuple, list))
        else (int(round_steps),)
    )
    save_on = save_every > 0
    if save_on:
        bad = [n for n in schedule + (max_steps,) if n % save_every]
        if bad:
            raise ValueError(
                "the trajectory channel needs every round length and "
                f"max_steps to be multiples of save_every={save_every}; "
                f"got {bad} (snapshot cadence must align across rounds)"
            )
        # the stiff pool's short-round cap, rounded to the cadence
        stiff_cap = max(save_every, 1024 - 1024 % save_every)
    else:
        stiff_cap = 1024
    auto = stepper == "auto"
    if not auto:
        base_stepper = stepper
    # the third pool (order selection) exists only when the base is
    # cheaper than dopri5
    order_pools = (
        auto and base_stepper != "dopri5" and order_switch_dt > 0.0
    )
    if order_pools and float(cfg.ds_max) > 0.0:
        raise ValueError(
            "order_switch_dt > 0 (three-pool order selection) is not "
            "supported together with SolverConfig.ds_max: the dt_max-"
            "relative switch thresholds do not apply under an arc-length "
            "ceiling"
        )
    # a Python float: the comparisons below round it to the mirror's
    # dtype as the JAX package's numpy comparisons do
    _dtmax = float(cfg.dt_max)
    floor = max(8, bucket_floor)
    T_, ST_, ACC_, REJ_ = 0, 1, 2, 3  # columns of the host stats mirror

    def make_kw(n, st):
        return dict(frame=frame, cfg=cfg, spec=spec, adaptive=adaptive,
                    stepper=st, max_steps=n, chunk=min(chunk, n), root=root,
                    grad_mode=grad_mode, legacy_freq_state=legacy_freq_state,
                    save_every=save_every, save_fn=save_fn)

    def stat_cols(sd):
        base = 4 * sd
        return [base + T_OF["t"], base + I_OF["status"],
                base + I_OF["n_accept"], base + I_OF["n_reject"]]

    def round_len(i):
        return schedule[min(i, len(schedule) - 1)]

    def _split_parts(idx_all, max_parts):
        """Decompose an index set into <= max_parts contiguous parts whose
        sizes are power-of-two multiples of the bucket floor (the last
        part takes the remainder): less bucket padding than one
        power-of-two bucket (3,370 rays -> 2,048 + 1,024 + 512 lanes
        instead of 4,096), and parts that pipeline (the JAX package's
        _split_parts, exactly)."""
        units = -(-idx_all.size // floor)
        if units < 2 or max_parts < 2:
            return [idx_all]
        sizes, u = [], units
        bit = 1 << (units.bit_length() - 1)
        while bit:
            if u >= bit:
                sizes.append(bit)
                u -= bit
            bit >>= 1
        while len(sizes) > max_parts:      # merge the small tail
            sizes.append(sizes.pop() + sizes.pop())
        # halve the largest while the part budget lasts (keeps powers of
        # two, so the bucket-size set stays small)
        while len(sizes) < max_parts and max(sizes) >= 4:
            m = max(sizes)
            sizes.remove(m)
            sizes += [m - m // 2, m // 2]
        sizes.sort(reverse=True)
        parts, startp = [], 0
        for k, s in enumerate(sizes):
            count = (
                s * floor if k < len(sizes) - 1 else idx_all.size - startp
            )
            count = min(count, idx_all.size - startp)
            parts.append(idx_all[startp:startp + count])
            startp += count
        return [p for p in parts if p.size]

    def run(u0, f, valid):
        run.last_rounds = []
        n = u0.shape[0]
        sd = u0.shape[1]
        cols = torch.tensor(stat_cols(sd), device=device)
        u0_t = torch.as_tensor(u0).to(device=device, dtype=dtype)
        f_t = torch.as_tensor(f).to(device=device, dtype=dtype)
        first = min(round_len(0), max_steps)
        w0_start = _clock()
        res = trace(env, u0_t, f_t, **make_kw(first, base_stepper))
        fl_dev = pack_carry(res.carry, f_t)
        if save_on:
            # host snapshot buffers and each ray's cursor (its next row:
            # the pools advance at their own budgets)
            n_snaps = max_steps // save_every
            s0 = first // save_every
            tr0 = {k: fetch() for k, fetch in _fetch_block(res.traj, n)}
            traj_buf = {
                k: np.zeros((n_snaps,) + v.shape[1:], v.dtype)
                for k, v in tr0.items()
            }
            for k, v in tr0.items():
                traj_buf[k][:s0] = v
            cursor = np.full(n, s0, np.int64)
        hs = fl_dev[:, cols].cpu().numpy()
        run.last_rounds.append(dict(
            stepper=base_stepper, active=n, bucket=n, steps=first,
            attempted=int(hs[:, ACC_].sum() + hs[:, REJ_].sum()),
            wall_s=_clock() - w0_start,
        ))

        override = np.full(n, -1, np.int32)   # host-side stall retirement
        stiff = np.zeros(n, bool)
        # accuracy-limited rays (order pools): the dopri5 pool
        slow = np.zeros(n, bool)

        def _alive(status_col):
            return (status_col == events.ACTIVE) | (
                status_col == events.MAX_STEPS
            )

        def settle(idx, rf, prog, is_stiff_pool, acc_delta):
            """After a launch, for its rays: stall retirement, then the
            stiff and order pools' membership. is_stiff_pool is the pool,
            not the method: a tail_stepper equal to stiff_stepper does not
            take the unswitch branch."""
            still = _alive(hs[idx, ST_]) & (override[idx] < 0)
            if stall_progress > 0.0:
                stalled = still & (prog < stall_progress)
                override[idx[stalled]] = events.DT_UNDERFLOW
                still = still & ~stalled
            if auto and is_stiff_pool:
                stiff[idx[still & (rf < stiff_unswitch)]] = False
            elif auto:
                stiff[idx[still & (rf > stiff_switch)]] = True
            if order_pools:
                # mean accepted dt over the round against the ceiling
                md = prog / np.maximum(acc_delta, 1)
                ok = still & ~stiff[idx]
                slow[idx[
                    ok & (md < order_switch_dt * _dtmax)
                    & (rf < stiff_switch)
                ]] = True
                slow[idx[ok & (md > order_unswitch_dt * _dtmax)]] = False

        idx0 = np.nonzero(np.asarray(valid))[0]
        att0 = hs[idx0, ACC_] + hs[idx0, REJ_]
        settle(idx0, hs[idx0, REJ_] / np.maximum(att0, 1), hs[idx0, T_],
               False, hs[idx0, ACC_])

        steps_done = first
        i = 1
        while steps_done < max_steps:
            active = (
                _alive(hs[:, ST_]) & (override < 0) & np.asarray(valid)
            )
            if not active.any():
                break
            n_active = int(active.sum())
            merged_tail = n_active * 4 <= floor   # the straggler tail
            if merged_tail:
                nr = max_steps - steps_done
            else:
                nr = min(round_len(i), max_steps - steps_done)
            base_st = (
                tail_stepper if (auto and merged_tail and tail_stepper)
                else base_stepper
            )
            # snapshot pool membership: rays marked stiff by this round's
            # settle wait for the next round
            pool_mask = stiff.copy()
            if order_pools:
                slow_mask = slow & ~pool_mask
                pools = ((~pool_mask & ~slow_mask, base_st, False),
                         (slow_mask, "dopri5", False),
                         (pool_mask, stiff_stepper, True))
            elif auto:
                pools = ((~pool_mask, base_st, False),
                         (pool_mask, stiff_stepper, True))
            else:
                pools = ((np.ones(n, bool), base_st, False),)
            # launch every pool's parts, then read their bookkeeping back
            # in order (each ray is in one part: the split is exact)
            jobs = []
            for mask, st, is_stiff_pool in pools:
                idx_all = np.nonzero(active & mask)[0]
                if idx_all.size == 0:
                    continue
                nr_pool = min(nr, stiff_cap) if is_stiff_pool else nr
                for idx in _split_parts(idx_all, pipeline):
                    w0 = _clock()
                    b = _bucket_size(idx.size, n, floor)
                    # pad lanes duplicate idx[0]; only the idx.size real
                    # rows are scattered back, so every target is unique
                    sel = torch.as_tensor(
                        np.concatenate(
                            [idx, np.repeat(idx[:1], b - idx.size)]),
                        device=device,
                    )
                    carry, ff = unpack_carry(fl_dev.index_select(0, sel), sd)
                    res = trace(env, carry.u, ff, carry0=carry,
                                **make_kw(nr_pool, st))
                    # the device-resident carry is updated in place
                    fl_dev[sel[:idx.size]] = (
                        pack_carry(res.carry, ff)[:idx.size])
                    jobs.append((idx, st, is_stiff_pool, nr_pool, b, w0,
                                 _fetch_later(fl_dev[:, cols]),
                                 _fetch_block(res.traj, idx.size)
                                 if save_on else ()))
            hs0 = hs
            for (idx, st, is_stiff_pool, nr_pool, b, w0, fetch_hs,
                 fetch_traj) in jobs:
                hs = fetch_hs()
                if save_on:
                    # the bucket's block at each ray's own cursor (pad
                    # lanes beyond idx.size dropped)
                    s_blk = nr_pool // save_every
                    rows = cursor[idx][None, :] + np.arange(s_blk)[:, None]
                    for k, fetch in fetch_traj:
                        traj_buf[k][rows, idx[None, :]] = fetch()
                    cursor[idx] += s_blk
                acc = hs[idx, ACC_] - hs0[idx, ACC_]
                rej = hs[idx, REJ_] - hs0[idx, REJ_]
                att = acc + rej
                rf = rej / np.maximum(att, 1)
                run.last_rounds.append(dict(
                    stepper=st, active=int(idx.size), bucket=b,
                    steps=nr_pool, attempted=int(att.sum()),
                    wall_s=_clock() - w0,
                ))
                settle(idx, rf, hs[idx, T_] - hs0[idx, T_], is_stiff_pool,
                       acc)
            steps_done += nr
            i += 1

        run.last_stiff = stiff
        run.last_slow = slow
        traj_out = None
        if save_on:
            # row min(k, cursor - 1) of each ray: rows past its cursor
            # repeat its last row, the frozen state the single-shot trace
            # records for a stopped ray (a stiff-pool ray, whose capped
            # rounds took fewer rows, holds its last round-end state)
            rows_ix = torch.minimum(
                torch.arange(n_snaps)[:, None],
                torch.from_numpy(np.maximum(cursor - 1, 0))[None, :])
            traj_out = {}
            for k, v in traj_buf.items():
                # torch's gather runs on every core; a numpy fancy index on
                # one (~5x longer at 625 x 10,240 rows)
                v = torch.from_numpy(v)
                ix = rows_ix.reshape(rows_ix.shape + (1,) * (v.dim() - 2))
                traj_out[k] = torch.gather(v, 0, ix.expand(v.shape)).numpy()
        patch = override >= 0
        if not want_carry:
            base = 4 * sd
            res_cols = list(range(sd)) + [
                base + T_OF["t"], base + I_OF["status"],
                base + I_OF["n_accept"], base + I_OF["n_reject"],
            ]
            out = fl_dev[:, torch.tensor(res_cols, device=device)]
            out = out.cpu().numpy()
            status = out[:, sd + 1].astype(np.int32)
            status[patch] = override[patch]
            return TraceResult(
                u=out[:, :sd], t=out[:, sd], status=status,
                n_accept=out[:, sd + 2].astype(np.int32),
                n_reject=out[:, sd + 3].astype(np.int32), traj=traj_out,
                carry=None,
            )
        fl = fl_dev.cpu().numpy().copy()
        fl[patch, 4 * sd + I_OF["status"]] = override[patch]
        final, _ = unpack_carry(fl, sd)
        return TraceResult(
            u=final.u, t=final.t, status=final.status,
            n_accept=final.n_accept, n_reject=final.n_reject, traj=traj_out,
            carry=final,
        )

    run.last_slow = None
    run.last_stiff = None
    run.last_rounds = []
    return run


def ensemble_stats(result, valid, lat_sign=1.0, lat_offset=0.0):
    """Summary statistics over a traced ensemble (host numpy arrays).

    Per-status counts, mean/median group delay and landing L-shell among
    surface hits, total accepted/rejected steps and the count of rays whose
    final group delay is negative (the abs(mu^2) regime). lat_sign and
    lat_offset map state[1] to magnetic latitude: (1, 0) in the latitude
    frame, (-1, pi/2) in the 3D frame, where state[1] is the colatitude
    and the landing L = r / sin^2(theta)."""
    valid = np.asarray(valid)
    status = np.where(valid, result.status, PAD_STATUS)
    out = {
        f"n_{name.lower()}": np.sum(status == code)
        for code, name in enumerate(events.STATUS_NAMES)
    }
    hit = status == events.HIT_EARTH
    u = np.asarray(result.u)
    T = u[:, -1]
    lat_land = lat_sign * u[:, 1] + lat_offset
    l_land = u[:, 0] / np.cos(lat_land) ** 2
    n_hit = np.sum(hit)
    denom = np.maximum(n_hit, 1)
    out["mean_group_delay_s"] = np.sum(np.where(hit, T, 0.0)) / denom
    out["mean_landing_l"] = np.sum(np.where(hit, l_land, 0.0)) / denom
    mid = np.maximum(n_hit - 1, 0) // 2
    any_hit = n_hit > 0
    out["median_landing_l"] = np.where(
        any_hit, np.sort(np.where(hit, l_land, np.inf))[mid], 0.0
    )
    out["median_group_delay_s"] = np.where(
        any_hit, np.sort(np.where(hit, T, np.inf))[mid], 0.0
    )
    out["total_accepted_steps"] = np.sum(np.where(valid, result.n_accept, 0))
    out["total_rejected_steps"] = np.sum(np.where(valid, result.n_reject, 0))
    out["n_retrograde_t"] = np.sum(np.where(valid, T < 0.0, False))
    return out
