"""Environment (medium) models: dipole B-field, ionosphere, plasmasphere."""

from . import dipole, ionosphere, plasmasphere
from .medium import EnvParams, b_mag, make_env, make_env_lat, ne_total_m3

__all__ = [
    "EnvParams",
    "b_mag",
    "dipole",
    "ionosphere",
    "make_env",
    "make_env_lat",
    "ne_total_m3",
    "plasmasphere",
]
