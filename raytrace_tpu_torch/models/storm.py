"""Storm-time plasmasphere dynamics: a time-dependent env sequence (port
of raytrace_tpu/models/storm.py; NumPy over the port's make_env, nothing on
the device).

The reference's plasmasphere is a static snapshot driven by one number,
Kp_max, the maximum Kp over the preceding 24 h (plasmasphere.jl:42, via
Lppi = 5.6 - 0.46 Kp_max). Given a Kp time series, this module produces
the plasmapause history and one EnvParams per requested epoch, with fast
erosion (tau_erode, ~3 h: the plasmapause follows the instantaneous
CA1992 position inward) and slow refilling (tau_refill, ~30 h outward; the
trough density saturates on tau_density, ~2 days):

    dL_pp/dt = -(L_pp - L_target(t)) / tau,
    tau = tau_erode  if L_target < L_pp  (inward motion)
        = tau_refill otherwise           (outward recovery)

with L_target(t) = 5.6 - 0.46 * max(Kp over the preceding 24 h). Each
epoch's env is built by the standard host pre-solve with lppi pinned to
L_pp(t); ray group delays are seconds while the plasmasphere moves over
hours, so a frozen medium per epoch is exact for any single ray.
"""

import numpy as np

from . import medium, plasmasphere


def kp_max_24h(t_hours, kp_hours, kp_values):
    """max Kp over the 24 h preceding each epoch in ``t_hours``.

    kp_hours/kp_values: the Kp time series (piecewise-constant, standard
    3-hourly cadence or any irregular sampling). Epochs before the first
    sample use the first value."""
    t_hours = np.atleast_1d(np.asarray(t_hours, np.float64))
    kp_hours = np.asarray(kp_hours, np.float64)
    kp_values = np.asarray(kp_values, np.float64)
    out = np.empty_like(t_hours)
    for i, t in enumerate(t_hours):
        in_win = (kp_hours > t - 24.0) & (kp_hours <= t)
        # the sample straddling the window start is still in effect
        prior = np.nonzero(kp_hours <= t - 24.0)[0]
        vals = list(kp_values[in_win])
        if prior.size:
            vals.append(kp_values[prior[-1]])
        elif not vals:
            vals.append(kp_values[0])
        out[i] = max(vals)
    return out


def _histories(t_hours, kp_hours, kp_values, tau_erode, tau_refill,
               tau_density, lpp0, dt_hours, lppi_fn=None):
    """(grid, lpp, w_refill) on the fine grid (shared integrator).

    lppi_fn maps a Kp array to plasmapause positions; default is the
    empirical CA1992 fit. A drift-derived boundary
    (convection.lppi_derived) drives the relaxation target from drift
    physics instead."""
    if lppi_fn is None:
        lppi_fn = plasmasphere.lppi_from_kp
    t_hours = np.atleast_1d(np.asarray(t_hours, np.float64))
    t0, t1 = float(t_hours.min()), float(t_hours.max())
    grid = np.arange(t0, t1 + dt_hours, dt_hours)
    target = np.asarray(lppi_fn(kp_max_24h(grid, kp_hours, kp_values)),
                        np.float64)
    lpp = np.empty_like(grid)
    w = np.empty_like(grid)
    lpp[0] = target[0] if lpp0 is None else float(lpp0)
    w[0] = 1.0
    for k in range(1, grid.size):
        eroding = target[k] < lpp[k - 1]
        tau = tau_erode if eroding else tau_refill
        # exact relaxation over the substep (unconditionally stable)
        a = np.exp(-dt_hours / tau)
        lpp[k] = target[k] + (lpp[k - 1] - target[k]) * a
        # trough refill weight: convection strips the refilled plasma on
        # the erosion timescale; quiet times refill toward saturation on
        # the (slower still) density timescale
        w_tgt, tau_w = (0.0, tau_erode) if eroding else (1.0, tau_density)
        aw = np.exp(-dt_hours / tau_w)
        w[k] = w_tgt + (w[k - 1] - w_tgt) * aw
    return grid, lpp, w


def plasmapause_history(
    t_hours,
    kp_hours,
    kp_values,
    tau_erode=3.0,
    tau_refill=30.0,
    lpp0=None,
    dt_hours=0.25,
    lppi_fn=None,
):
    """L_pp(t): asymmetric-relaxation plasmapause driven by the Kp series.

    Integrates the relaxation ODE (module docstring) from the first
    epoch with an explicit fine step (dt_hours); lpp0 defaults to the
    initial 24-h-Kp equilibrium. Returns L_pp at each ``t_hours``.
    lppi_fn replaces the empirical CA1992 target (see _histories)."""
    t_hours = np.atleast_1d(np.asarray(t_hours, np.float64))
    grid, lpp, _ = _histories(
        t_hours, kp_hours, kp_values, tau_erode, tau_refill, 48.0, lpp0,
        dt_hours, lppi_fn=lppi_fn,
    )
    return np.interp(t_hours, grid, lpp)


def refill_history(
    t_hours,
    kp_hours,
    kp_values,
    tau_erode=3.0,
    tau_refill=30.0,
    tau_density=48.0,
    dt_hours=0.25,
    lppi_fn=None,
):
    """w(t) in [0, 1]: density-level trough refill weight for
    EnvParams.ps_refill (plasmasphere.ne_plasma_cm3). Erosion intervals
    strip it toward 0 on tau_erode; quiet intervals refill toward 1 on
    tau_density (~2 days -- the plasmapause position recovers faster
    than the trough density saturates, hence the separate timescale).
    lppi_fn: same hook as plasmapause_history -- the erosion/quiet
    classification follows the boundary target, so a derived-boundary
    run gets consistent lpp and refill histories."""
    t_hours = np.atleast_1d(np.asarray(t_hours, np.float64))
    grid, _, w = _histories(
        t_hours, kp_hours, kp_values, tau_erode, tau_refill, tau_density,
        None, dt_hours, lppi_fn=lppi_fn,
    )
    return np.interp(t_hours, grid, w)


def storm_sequence(
    t_hours,
    kp_hours,
    kp_values,
    tau_erode=3.0,
    tau_refill=30.0,
    refill=False,
    tau_density=48.0,
    lppi_fn=None,
    **env_kw,
):
    """One EnvParams per epoch, with lppi pinned to the dynamic L_pp(t).

    env_kw passes through to make_env (b0, day, rbar, mlt, ps_model,
    ducts, composition, ...). refill=True additionally sets each epoch's
    ps_refill to the density-level trough recovery weight
    (refill_history). lppi_fn: same hook as plasmapause_history -- the
    relaxation target driving every epoch's env. Returns (envs, lpp) -- the env list and the
    plasmapause history at the epochs."""
    t_hours = np.atleast_1d(np.asarray(t_hours, np.float64))
    grid, lpp_g, w_g = _histories(
        t_hours, kp_hours, kp_values, tau_erode, tau_refill, tau_density,
        None, 0.25, lppi_fn=lppi_fn,
    )
    lpp = np.interp(t_hours, grid, lpp_g)
    w = np.interp(t_hours, grid, w_g)
    envs = []
    for L, wk in zip(lpp, w):
        # invert Lppi = 5.6 - 0.46 Kp so make_env's pre-solve lands the
        # plasmapause exactly at the dynamic position
        kw = dict(env_kw)
        if refill:
            kw["ps_refill"] = float(wk)
        envs.append(medium.make_env(kp_max=(5.6 - L) / 0.46, **kw))
    return envs, lpp
