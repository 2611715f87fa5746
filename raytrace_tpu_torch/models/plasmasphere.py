"""Carpenter & Anderson 1992 plasmasphere (port of raytrace_tpu/models/plasmasphere.py).

Three-branch piecewise model in L-shell (plasmasphere.jl:73-94):
  (i)   L <= Lppi:        log10 ne = (-0.3145 L + 3.9043) + a_season exp((2-L)/1.5)
  (ii)  Lppi < L <= Lppo: ne = ne(Lppi) * 10^((Lppi - L)/0.1)
  (iii) L > Lppo:         ne = (5800 + 300 mlt) L^-4.5 + (1 - exp((2-L)/10))

The plasmapause pre-solve (Lppo, ne(Lppi)) is host-side NumPy float64 and
runs once per medium; the density itself is evaluated on tensors with hard
branches (the sigmoid-smoothed and refilled variants are not ported yet).
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


def ne_plasma_cm3(L, lppi, lppo, ne_lppi, a_season, trough_c):
    """CA1992 plasmasphere density (cm^-3) with hard branches.

    trough_c = 5800 + 300 mlt. Powers as exp/log, the form the JAX
    package uses, so values agree to rounding."""
    log_ne1 = (-0.3145 * L + 3.9043) + a_season * torch.exp((2.0 - L) / 1.5)
    ne1 = torch.exp(LN10 * log_ne1)
    ne2 = ne_lppi * torch.exp(LN10 * (lppi - L) / 0.1)
    Lsafe = torch.clamp_min(L, 1e-6)
    ne3 = trough_c * torch.exp(-4.5 * torch.log(Lsafe)) + (
        1.0 - torch.exp((2.0 - L) / 10.0)
    )
    return torch.where(L <= lppi, ne1, torch.where(L <= lppo, ne2, ne3))


def diffusive_equilibrium_factor(r):
    """Field-line density falloff factor sqrt(exp(-G/S)), r in RE.

    plasmasphere.jl:96-106 (G = rb (1 - rb/r), single species)."""
    r_m = r * RE
    G = DE_RBASE_M * (1.0 - DE_RBASE_M / r_m)
    return torch.sqrt(torch.exp(-G / DE_S))
