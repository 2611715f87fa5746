"""Physical constants for whistler ray tracing.

Values match the reference (RayMain.jl:110-116, RayTrace_3D.jl:38-44,
plasmasphere.jl:33-39) so float64 trajectories can be cross-validated.

The reference carries two values of B0 (the equatorial surface field):
3.0696381e-5 T in the 2D scripts (RayMain.jl:112, RayTrace_lat.jl:15) and
3.12e-5 T in the 3D script and plasmasphere module (RayTrace_3D.jl:40,
plasmasphere.jl:35). We expose both; the 2D-legacy value is the default for
the 2D configs so trajectories are comparable with the reference scripts.

All compute-path code works in scaled units:
  - length in units of Earth radii (RE)
  - the independent ODE variable t is phase path length in units of RE
    (the reference integrates in meters of phase path, tspan (0, 5e9) m;
    see RayMain.jl:384 -- scaled here to (0, 5e9/RE))
  - group delay time T in seconds
  - wave frequency f in Hz
"""

import math

# --- SI constants (reference: RayMain.jl:110-116) ---
C_LIGHT = 2.99792458e8      # speed of light, m/s
RE = 6.3712e6               # Earth radius, m
B0_2D = 3.0696381e-5        # equatorial surface dipole field, T (2D scripts)
B0_3D = 3.12e-5             # equatorial surface dipole field, T (3D/plasmasphere)
Q_E = 1.602e-19             # elementary charge, C
M_E = 9.1093e-31            # electron mass, kg
M_P = 1.6726219e-27         # proton mass, kg
EPS0 = 8.854e-12            # vacuum permittivity, F/m

# --- derived coefficients for the ratio-form Stix parameters ---
# f_pe^2 = FPE2_E * n_e[cm^-3]   (Hz^2); reference computes
# omega_e2 = n_e[m^-3] e^2/(eps0 me) (RayMain.jl:157) -- identical algebra.
FPE2_E = Q_E * Q_E * 1.0e6 / (EPS0 * M_E * 4.0 * math.pi * math.pi)
FPE2_P = Q_E * Q_E * 1.0e6 / (EPS0 * M_P * 4.0 * math.pi * math.pi)
# f_ce = FCE_E * |B|[T]  (Hz); reference Omega_e = e B / me (RayMain.jl:162)
FCE_E = Q_E / (M_E * 2.0 * math.pi)
FCE_P = Q_E / (M_P * 2.0 * math.pi)

# heavier singly-charged ions for multi-ion composition (an extension --
# the reference is protons-only, RayMain.jl:154). Masses as exact proton
# multiples (4, 16), the standard cold-plasma idealization of He+ / O+:
# f_p^2 ~ n/m and f_c ~ 1/m.
FPE2_HE = FPE2_P / 4.0
FPE2_O = FPE2_P / 16.0
FCE_HE = FCE_P / 4.0
FCE_O = FCE_P / 16.0

# scaled-time conversion: dT/dt' = (RE / C_LIGHT) * (1 + (f/mu) dmu/df)
RE_OVER_C = RE / C_LIGHT
