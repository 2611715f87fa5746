"""Host-side visualization (matplotlib, imported when a plot is drawn),
mirroring the reference's plots (RayMain.jl:389-404,
RayTrace_lat.jl:340-416, RayTrace_3D.jl:421-586, plasmasphere.jl:
120-233). The data helpers compute on a device and need no matplotlib."""

from .plots import (
    density_profile_data,
    environment_data,
    plot_density_profile,
    plot_diagnostics,
    plot_environment,
    plot_ray_paths,
    plot_refractive_surface,
    refractive_surface_data,
)

__all__ = [
    "density_profile_data",
    "environment_data",
    "plot_density_profile",
    "plot_diagnostics",
    "plot_environment",
    "plot_ray_paths",
    "plot_refractive_surface",
    "refractive_surface_data",
]
