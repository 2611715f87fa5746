"""Launch grids and the bucketed rounds tracer (port of
raytrace_tpu/parallel/ensemble.py, single device).

A LaunchSpec builds the (latitude x wave-normal angle x frequency) grid,
the batch is padded to a multiple of 8, and `make_rounds_tracer` integrates
it in rounds: after each round the still-active rays are gathered into the
next power-of-two bucket ON THE DEVICE and continue from their exact
RayCarry. The whole carry rides one packed float tensor that stays on the
device across rounds; per round the host reads only four bookkeeping
columns (t, status, n_accept, n_reject) and sends back an index list.
"""

from time import perf_counter as _clock
from typing import NamedTuple

import numpy as np
import torch

from ..constants import RE
from ..integrate import events
from ..integrate.solve import RayCarry, SolverConfig, TraceResult, trace
from ..integrate.events import StopSpec

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


def make_rounds_tracer(
    env,
    *,
    device,
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
    tail_stepper: str = "",
    want_carry: bool = True,
    pipeline: int = 1,
    legacy_freq_state: bool = False,
    save_every: int = 0,
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

    device/dtype: where and in what precision the carry lives. u0 and f
    are cast to them. The returned TraceResult holds numpy arrays (the
    final fetch); `run.last_rounds` and `run.last_stiff` record per-round
    diagnostics and which rays ended on the stiff pool.

    Knobs the JAX package measured and left off are not ported (ROADMAP
    A5): pipeline > 1, order_switch_dt > 0, tail_stepper, save_every."""
    unported = {
        "pipeline > 1": pipeline > 1,
        "order_switch_dt > 0": order_switch_dt > 0.0,
        "tail_stepper": bool(tail_stepper),
        "save_every > 0 (trajectory channel, ROADMAP A11)": save_every > 0,
        "legacy_freq_state (ROADMAP A10)": legacy_freq_state,
        f"frame={frame!r} (ROADMAP A7/A10)": frame != "2d_lat",
        f"grad_mode={grad_mode!r}": grad_mode != "fused",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported to the rounds tracer: {', '.join(bad)} (ROADMAP A5 "
            "unless named)"
        )
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
    auto = stepper == "auto"
    if not auto:
        base_stepper = stepper
    stiff_cap = 1024
    floor = max(8, bucket_floor)
    T_, ST_, ACC_, REJ_ = 0, 1, 2, 3  # columns of the host stats mirror

    def make_kw(n, st):
        return dict(cfg=cfg, spec=spec, adaptive=adaptive, stepper=st,
                    max_steps=n, chunk=min(chunk, n), root=root)

    def stat_cols(sd):
        base = 4 * sd
        return [base + T_OF["t"], base + I_OF["status"],
                base + I_OF["n_accept"], base + I_OF["n_reject"]]

    def round_len(i):
        return schedule[min(i, len(schedule) - 1)]

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
        hs = fl_dev[:, cols].cpu().numpy()
        run.last_rounds.append(dict(
            stepper=base_stepper, active=n, bucket=n, steps=first,
            attempted=int(hs[:, ACC_].sum() + hs[:, REJ_].sum()),
            wall_s=_clock() - w0_start,
        ))

        override = np.full(n, -1, np.int32)   # host-side stall retirement
        stiff = np.zeros(n, bool)

        def _alive(status_col):
            return (status_col == events.ACTIVE) | (
                status_col == events.MAX_STEPS
            )

        def settle(idx, rf, prog, is_stiff_pool):
            still = _alive(hs[idx, ST_]) & (override[idx] < 0)
            if stall_progress > 0.0:
                stalled = still & (prog < stall_progress)
                override[idx[stalled]] = events.DT_UNDERFLOW
                still = still & ~stalled
            if auto and is_stiff_pool:
                stiff[idx[still & (rf < stiff_unswitch)]] = False
            elif auto:
                stiff[idx[still & (rf > stiff_switch)]] = True

        idx0 = np.nonzero(np.asarray(valid))[0]
        att0 = hs[idx0, ACC_] + hs[idx0, REJ_]
        settle(idx0, hs[idx0, REJ_] / np.maximum(att0, 1), hs[idx0, T_],
               False)

        steps_done = first
        i = 1
        while steps_done < max_steps:
            active = (
                _alive(hs[:, ST_]) & (override < 0) & np.asarray(valid)
            )
            if not active.any():
                break
            n_active = int(active.sum())
            if n_active * 4 <= floor:      # merged straggler tail
                nr = max_steps - steps_done
            else:
                nr = min(round_len(i), max_steps - steps_done)
            # snapshot pool membership: rays marked stiff by this round's
            # settle wait for the next round
            pool_mask = stiff.copy()
            if auto:
                pools = ((~pool_mask, base_stepper, False),
                         (pool_mask, stiff_stepper, True))
            else:
                pools = ((np.ones(n, bool), base_stepper, False),)
            for mask, st, is_stiff_pool in pools:
                idx = np.nonzero(active & mask)[0]
                if idx.size == 0:
                    continue
                nr_pool = min(nr, stiff_cap) if is_stiff_pool else nr
                w0 = _clock()
                b = _bucket_size(idx.size, n, floor)
                # pad lanes duplicate idx[0]; only the idx.size real rows
                # are scattered back, so every write target is unique
                sel = torch.as_tensor(
                    np.concatenate([idx, np.repeat(idx[:1], b - idx.size)]),
                    device=device,
                )
                acc0 = hs[idx, ACC_].copy()
                rej0 = hs[idx, REJ_].copy()
                t0 = hs[idx, T_].copy()
                carry, ff = unpack_carry(fl_dev.index_select(0, sel), sd)
                res = trace(env, carry.u, ff, carry0=carry,
                            **make_kw(nr_pool, st))
                # the device-resident carry is updated in place
                fl_dev[sel[:idx.size]] = pack_carry(res.carry, ff)[:idx.size]
                hs = fl_dev[:, cols].cpu().numpy()
                att = (hs[idx, ACC_] - acc0) + (hs[idx, REJ_] - rej0)
                rf = (hs[idx, REJ_] - rej0) / np.maximum(att, 1)
                run.last_rounds.append(dict(
                    stepper=st, active=int(idx.size), bucket=b,
                    steps=nr_pool, attempted=int(att.sum()),
                    wall_s=_clock() - w0,
                ))
                settle(idx, rf, hs[idx, T_] - t0, is_stiff_pool)
            steps_done += nr
            i += 1

        run.last_stiff = stiff
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
                n_reject=out[:, sd + 3].astype(np.int32), carry=None,
            )
        fl = fl_dev.cpu().numpy().copy()
        fl[patch, 4 * sd + I_OF["status"]] = override[patch]
        final, _ = unpack_carry(fl, sd)
        return TraceResult(
            u=final.u, t=final.t, status=final.status,
            n_accept=final.n_accept, n_reject=final.n_reject, carry=final,
        )

    run.last_stiff = None
    run.last_rounds = []
    return run


def ensemble_stats(result, valid, lat_sign=1.0, lat_offset=0.0):
    """Summary statistics over a traced ensemble (host numpy arrays).

    Per-status counts, mean/median group delay and landing L-shell among
    surface hits, total accepted/rejected steps and the count of rays whose
    final group delay is negative (the abs(mu^2) regime)."""
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
