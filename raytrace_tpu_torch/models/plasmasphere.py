"""Carpenter & Anderson 1992 plasmasphere (port of raytrace_tpu/models/plasmasphere.py).

Three-branch piecewise model in L-shell (plasmasphere.jl:73-94):
  (i)   L <= Lppi:        log10 ne = (-0.3145 L + 3.9043) + a_season exp((2-L)/1.5)
  (ii)  Lppi < L <= Lppo: ne = ne(Lppi) * 10^((Lppi - L)/0.1)
  (iii) L > Lppo:         ne = (5800 + 300 mlt) L^-4.5 + (1 - exp((2-L)/10))

The plasmapause pre-solve (Lppo, ne(Lppi)) is host-side NumPy float64 and
runs once per medium; the density itself is evaluated on tensors, with
hard branches or sigmoid-smoothed ones, an optional trough refill, the
simplified-GCPM alternative and the field-aligned duct factor.
"""

import math

import numpy as np
import torch

from ..constants import RE

# DE-model constants (plasmasphere.jl:99-103)
DE_TEMP_K = 2500.0
DE_RBASE_M = 7.37e6
# S = 1.506 T (rb[m]/7370)^2 / 4^(i-1) with i=1 (single ion species)
DE_S = 1.506 * DE_TEMP_K * (DE_RBASE_M / 7370.0) ** 2

LN10 = 2.302585092994046


def season_coeff(day, rbar):
    """Seasonal/solar coefficient of CA1992 branch (i). Host-side scalar."""
    return (
        0.15
        * (
            math.cos(2.0 * math.pi * (day + 9.0) / 365.0)
            - 0.5 * math.cos(4.0 * math.pi * (day + 9.0) / 365.0)
        )
        + 0.00127 * rbar
        - 0.0635
    )


def lppi_from_kp(kp_max):
    """Plasmapause inner limit. plasmasphere.jl:43."""
    return 5.6 - 0.46 * kp_max


def _branch1_log10(L, a_season):
    return (-0.3145 * L + 3.9043) + a_season * np.exp((2.0 - L) / 1.5)


def initialize_plasmasphere(lppi, day, rbar, mlt):
    """Host-side pre-solve for (Lppo, ne_Lppi). plasmasphere.jl:48-71.

    Scans L = r/RE for r in [RE, 10 RE] at 1 km steps and returns the L
    where branches (ii) and (iii) are closest, plus the branch (i) density
    at Lppi. NumPy float64."""
    a = season_coeff(day, rbar)
    ne_lppi = 10.0 ** _branch1_log10(np.float64(lppi), a)
    r = np.arange(RE, 10.0 * RE + 1.0, 1000.0, dtype=np.float64)
    L = r / RE
    ne2 = ne_lppi * 10.0 ** (-(L - lppi) / 0.1)
    ne3 = (5800.0 + 300.0 * mlt) * L ** (-4.5) + (1.0 - np.exp((2.0 - L) / 10.0))
    lppo = L[int(np.argmin(np.abs(ne2 - ne3)))]
    return float(lppo), float(ne_lppi)


def refill_weight(L, w0, q, lref=4.0):
    """Per-L trough refill weight from the epoch weight w0 at L = lref:
    w(L) = 1 - (1 - w0)^((lref/L)^q), each shell refilling on its own
    tau ~ L^q clock. q = 0 returns the global weight w0; the 1 - w0 floor
    keeps w0 = 1 finite."""
    if q == 0.0:
        return w0
    Lsafe = torch.clamp_min(L, 1e-6)
    e = torch.exp(q * (math.log(lref) - torch.log(Lsafe)))  # (lref/L)^q
    ln_keep = math.log(max(1.0 - w0, 1e-30))
    return 1.0 - torch.exp(e * ln_keep)


def ne_plasma_cm3(L, lppi, lppo, ne_lppi, a_season, trough_c, smooth=0.0,
                  refill=0.0, refill_q=0.0, refill_lref=4.0):
    """CA1992 plasmasphere density (cm^-3).

    trough_c = 5800 + 300 mlt. Powers as exp/log, the form the JAX
    package uses, so values agree to rounding. smooth > 0 replaces the
    hard branch boundaries by log-space sigmoid blends of that width in
    L; refill in [0, 1] blends the trough in log space toward the
    saturated branch-1 profile (per L with refill_q > 0, see
    refill_weight). The boundaries may be tensors (the MLT-resolved
    medium's effective parameters)."""
    log_ne1 = (-0.3145 * L + 3.9043) + a_season * torch.exp((2.0 - L) / 1.5)
    ne1 = torch.exp(LN10 * log_ne1)
    ne2 = ne_lppi * torch.exp(LN10 * (lppi - L) / 0.1)
    Lsafe = torch.clamp_min(L, 1e-6)
    ne3 = trough_c * torch.exp(-4.5 * torch.log(Lsafe)) + (
        1.0 - torch.exp((2.0 - L) / 10.0)
    )
    if refill != 0.0:
        w = refill_weight(L, refill, refill_q, refill_lref)
        ne3 = torch.exp((1.0 - w) * torch.log(ne3) + w * (LN10 * log_ne1))
    hard = torch.where(L <= lppi, ne1, torch.where(L <= lppo, ne2, ne3))
    if smooth == 0.0:
        return hard
    # in log space, where branch 2's steep growth toward small L cannot
    # leak through a sigmoid's tail; ln2 analytically, since ne2 may
    # underflow to 0 at extreme L and log(0) * 0 would be NaN
    w1 = sigmoid((lppi - L) / smooth)
    w2 = sigmoid((lppo - L) / smooth)
    ln1 = LN10 * log_ne1
    ln_ne_lppi = (math.log(ne_lppi) if isinstance(ne_lppi, float)
                  else torch.log(ne_lppi))
    ln2 = ln_ne_lppi + LN10 * (lppi - L) / 0.1
    ln3 = torch.log(ne3)
    return torch.exp(w1 * ln1 + (1.0 - w1) * (w2 * ln2 + (1.0 - w2) * ln3))


def sigmoid(x):
    """The logistic 1 / (1 + exp(-x)), written out as the JAX package
    writes it (jax_sigmoid): torch.sigmoid rounds differently, and the
    step kernel must round as this plain form does."""
    return 1.0 / (1.0 + torch.exp(-x))


def ne_gcpm_cm3(L, lat, lppo, trough_c, ne0, lscale, bpow, knee=0.2):
    """Simplified-GCPM plasmasphere density (cm^-3):
    ne0 exp(-(L - 2)/lscale) m(lat)^bpow with the dipole mirror ratio
    m = sqrt(1 + 3 sin^2 lat)/cos^6 lat, joined to the CA1992 trough at
    lppo by a log-space sigmoid of width `knee` in L."""
    cl = torch.cos(lat)
    sl = torch.sin(lat)
    q2 = 1.0 + 3.0 * (sl * sl)
    ln_m = 0.5 * torch.log(q2) - 6.0 * torch.log(cl)
    ln_ps = math.log(ne0) - (L - 2.0) / lscale + bpow * ln_m
    Lsafe = torch.clamp_min(L, 1e-6)
    ln_tr = torch.log(
        trough_c * torch.exp(-4.5 * torch.log(Lsafe))
        + (1.0 - torch.exp((2.0 - L) / 10.0))
    )
    w = sigmoid((lppo - L) / knee)
    return torch.exp(w * ln_ps + (1.0 - w) * ln_tr)


# calibrated GCPM defaults: the equatorial profile of CA1992's saturated
# branch (i) without the seasonal term
GCPM_NE0 = 10.0 ** (3.9043 - 2.0 * 0.3145)   # 1884.3 cm^-3 at L = 2
GCPM_LSCALE = 1.0 / (0.3145 * LN10)          # 1.3811 L per e-fold
GCPM_KNEE = 0.2                              # plasmapause blend width, L


def duct_factor(L, amp, l0, width):
    """Field-aligned density duct: 1 + amp exp(-(L - l0)^2 / (2 width^2)),
    a Gaussian crest (amp > 0) or trough (amp < 0) across L that rides
    the dipole field line; it multiplies the plasmasphere term."""
    x = (L - l0) / width
    return 1.0 + amp * torch.exp(-0.5 * x * x)


def diffusive_equilibrium_factor(r):
    """Field-line density falloff factor sqrt(exp(-G/S)), r in RE.

    plasmasphere.jl:96-106 (G = rb (1 - rb/r), single species)."""
    r_m = r * RE
    G = DE_RBASE_M * (1.0 - DE_RBASE_M / r_m)
    return torch.sqrt(torch.exp(-G / DE_S))
