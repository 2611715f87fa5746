"""Environment (medium) models: dipole B-field, ionosphere, plasmasphere."""

from . import dipole, ionosphere, plasmasphere, storm
from .medium import (
    EnvParams, b_mag, b_vec, make_env, make_env_lat, make_env_raymain,
    mlat_3d, mlon_3d, mlt_gcpm_params, mlt_on, mlt_ps_params, ne_total_m3,
)

__all__ = [
    "EnvParams",
    "b_mag",
    "b_vec",
    "dipole",
    "ionosphere",
    "make_env",
    "make_env_lat",
    "make_env_raymain",
    "mlat_3d",
    "mlon_3d",
    "mlt_gcpm_params",
    "mlt_on",
    "mlt_ps_params",
    "ne_total_m3",
    "plasmasphere",
    "storm",
]
