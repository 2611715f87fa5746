"""Visualization: ray paths, solver diagnostics, refractive-index surfaces,
environment maps (port of raytrace_tpu/viz/plots.py; the reference's
components C22-C25).

The data of a figure that needs the medium -- the mu(psi) sweep, the n_e
and |B| maps, the equatorial density profile -- is computed as tensors on
a device (`device=`, the card unless the caller names another) by the
`*_data` helpers, which need no matplotlib, then moved to the host.
matplotlib is imported (with the Agg backend) only when a figure is
drawn, so the package imports on a machine without it. Every plot
function returns the matplotlib Figure; pass `path` to also save it.
"""

import numpy as np
import torch

from ..models import dipole, ionosphere, medium, plasmasphere
from ..ops import dispersion
from ..placement import device_of


def _pyplot():
    """matplotlib.pyplot on the Agg backend; ImportError naming what needs
    it when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "matplotlib is not installed: the plots (--plots, "
            "raytrace_tpu_torch.viz) need it; the data helpers "
            "(refractive_surface_data, environment_data, "
            "density_profile_data) do not") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, path):
    if path:
        fig.savefig(path, dpi=130, bbox_inches="tight")
        plt.close(fig)
    return fig


def _earth(ax):
    th = np.linspace(0, 2 * np.pi, 256)
    ax.plot(np.cos(th), np.sin(th), "k-", lw=1, label="Earth")


def _field_lines(ax, l_values=(1.5, 2, 3, 4, 5, 6)):
    """Dipole field lines r = L cos^2(lat) (scratch.jl:434-462)."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, 301)
    for L in l_values:
        r = L * np.cos(lat) ** 2
        m = r >= 1.0
        ax.plot(r[m] * np.cos(lat[m]), r[m] * np.sin(lat[m]),
                color="0.75", lw=0.6, zorder=0)


def _on(x, dev):
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def refractive_surface_data(r, lat, f, env: medium.EnvParams, n_psi=6284,
                            device=None):
    """The mu(psi) sweep of plot_refractive_surface at fixed (r, lat, f):
    {psi, chi, mu} as float64 numpy arrays, mu computed on `device`
    (RayTrace_lat.jl:391: chi = -psi + 3 pi/2 - dip)."""
    dev = device_of(device=device)
    psi = np.linspace(0.0, 2 * np.pi, n_psi)
    dip = float(dipole.dip_angle_lat(_on(lat, dev)))
    chi = -psi + 3 * np.pi / 2 - dip
    chi_t = _on(chi, dev)
    full = lambda v: torch.full_like(chi_t, float(v))  # noqa: E731
    mu = dispersion.mu_2d_lat(full(r), full(lat), chi_t, full(f), env)
    return {"psi": psi, "chi": chi, "mu": mu.cpu().numpy()}


def environment_data(env: medium.EnvParams, extent=4.0, n=400, device=None):
    """The maps of plot_environment on an n x n grid over [-extent,
    extent]^2 (x along the equator, y along the dipole axis): {X, Y, r,
    lat, ne, b, L} as float64 numpy arrays, n_e (m^-3) and |B| (T) computed
    on `device` and NaN inside the Earth, L = r / cos^2(lat) (inf on the
    axis)."""
    dev = device_of(device=device)
    x = np.linspace(-extent, extent, n)
    y = np.linspace(-extent, extent, n)
    X, Y = np.meshgrid(x, y)
    r = np.sqrt(X**2 + Y**2)
    lat = np.arctan2(Y, X)
    r_t, lat_t = _on(r.ravel(), dev), _on(lat.ravel(), dev)
    ne = medium.ne_total_m3(r_t, lat_t, env).cpu().numpy().reshape(r.shape)
    b = medium.b_mag(r_t, lat_t, env).cpu().numpy().reshape(r.shape)
    L = np.where(np.abs(np.cos(lat)) > 1e-6, r / np.cos(lat) ** 2, np.inf)
    return {"X": X, "Y": Y, "r": r, "lat": lat,
            "ne": np.where(r >= 1.0, ne, np.nan),
            "b": np.where(r >= 1.0, b, np.nan), "L": L}


def density_profile_data(env: medium.EnvParams, device=None):
    """The equatorial profile of plot_density_profile: {L, ne_iono,
    ne_plasma} (cm^-3) over L = r in [1, 7], 2,000 points, computed on
    `device`."""
    dev = device_of(device=device)
    r = np.linspace(1.0, 7.0, 2000)
    r_t = _on(r, dev)
    ne_i = ionosphere.ne_iono_cm3(r_t, env.iono_n0, env.iono_decay,
                                  env.iono_r0)
    ne_p = plasmasphere.ne_plasma_cm3(r_t, env.lppi, env.lppo, env.ne_lppi,
                                      env.ps_season, env.ps_trough)
    return {"L": r, "ne_iono": ne_i.cpu().numpy(),
            "ne_plasma": ne_p.cpu().numpy()}


def plot_ray_paths(traj_u, traj_status=None, frame="2d_lat", path=None,
                   title="whistler ray paths"):
    """Ray paths over the Earth disk and dipole field lines.

    traj_u: (S, B, n) snapshot stack or (S, n) single ray (numpy, or a
    tensor on any device). Reference: RayMain.jl:403-404,
    RayTrace_lat.jl:354-355."""
    plt = _pyplot()
    u = (traj_u.cpu().numpy() if isinstance(traj_u, torch.Tensor)
         else np.asarray(traj_u))
    if u.ndim == 2:
        u = u[:, None, :]
    r, a = u[..., 0], u[..., 1]
    if frame == "2d_lat":
        x, y = r * np.cos(a), r * np.sin(a)
    else:
        x, y = r * np.sin(a), r * np.cos(a)
    fig, ax = plt.subplots(figsize=(7, 7))
    _earth(ax)
    _field_lines(ax)
    for b in range(x.shape[1]):
        ax.plot(x[:, b], y[:, b], lw=0.9)
    ax.set_aspect("equal")
    ax.set_xlabel("x (RE)")
    ax.set_ylabel("y (RE)")
    ax.set_title(title)
    return _finish(plt, fig, path)


def plot_diagnostics(traj_t, extras, path=None):
    """mu, dmu/dpsi, dip, psi and step size vs time -- the reference's
    saved-value plots (RayTrace_lat.jl:357-378)."""
    plt = _pyplot()
    t = np.asarray(traj_t)
    e = np.asarray(extras)  # (S, 4) = mu, dmudpsi, dip, psi
    fig, axes = plt.subplots(5, 1, figsize=(7, 11), sharex=False)
    names = ["mu", "dmu/dpsi", "dip (deg)", "psi (deg)"]
    scale = [1.0, 1.0, 180 / np.pi, 180 / np.pi]
    for i, (name, sc) in enumerate(zip(names, scale)):
        axes[i].plot(t, e[:, i] * sc, lw=0.9)
        axes[i].set_ylabel(name)
    dt = np.diff(t)
    axes[4].plot(np.arange(len(dt)), dt, lw=0.9)
    axes[4].set_ylabel("dt (step size)")
    axes[4].set_xlabel("step number")
    axes[0].set_title("solver diagnostics")
    return _finish(plt, fig, path)


def plot_refractive_surface(r, lat, f, env: medium.EnvParams, path=None,
                            n_psi=6284, device=None):
    """mu(psi) surface at fixed (r, lat, f), B-aligned and x-y frames
    (RayTrace_lat.jl:380-416); the sweep computes on `device`
    (refractive_surface_data)."""
    plt = _pyplot()
    d = refractive_surface_data(r, lat, f, env, n_psi, device)
    psi, chi, mu = d["psi"], d["chi"], d["mu"]
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    axes[0].plot(mu * np.sin(psi), mu * np.cos(psi), lw=0.8)
    axes[0].set_title("mu surface (B-aligned frame)")
    axes[1].plot(mu * np.sin(chi - (np.pi / 2 - lat)),
                 mu * np.cos(chi - (np.pi / 2 - lat)), lw=0.8)
    axes[1].set_title("mu surface (x-y frame)")
    for ax in axes:
        ax.set_aspect("equal")
    return _finish(plt, fig, path)


def plot_environment(env: medium.EnvParams, path=None, extent=4.0, n=400,
                     device=None):
    """log10 n_e(x, y) heatmap with L-shell contours and the Earth disk,
    and the dipole |B| map (RayTrace_3D.jl:544-586, plasmasphere.jl:
    157-206); the maps compute on `device` (environment_data)."""
    plt = _pyplot()
    d = environment_data(env, extent, n, device)
    fig, axes = plt.subplots(1, 2, figsize=(13, 6))
    im = axes[0].imshow(
        np.log10(d["ne"] * 1e-6), origin="lower",
        extent=[-extent, extent] * 2, cmap="magma", vmin=-1, vmax=5,
    )
    fig.colorbar(im, ax=axes[0], label="log10 n_e (cm^-3)")
    axes[0].contour(d["X"], d["Y"], d["L"], levels=np.arange(1, 6.5, 0.5),
                    colors="w", linewidths=0.4)
    axes[0].add_patch(plt.Circle((0, 0), 1.0, color="k"))
    axes[0].set_title("electron density + L-shells")
    im2 = axes[1].imshow(
        np.log10(d["b"]), origin="lower", extent=[-extent, extent] * 2,
        cmap="viridis",
    )
    fig.colorbar(im2, ax=axes[1], label="log10 |B| (T)")
    axes[1].add_patch(plt.Circle((0, 0), 1.0, color="k"))
    axes[1].set_title("dipole field magnitude")
    # day/night terminator: nightside semicircle overlay
    # (plasmasphere.jl:208-233)
    th = np.linspace(np.pi / 2, 3 * np.pi / 2, 100)
    for ax in axes:
        ax.fill(
            np.concatenate([0.95 * np.cos(th), [0.0]]),
            np.concatenate([0.95 * np.sin(th), [0.0]]),
            color="w", alpha=0.9, zorder=3,
        )
    for ax in axes:
        ax.set_aspect("equal")
        ax.set_xlabel("x (RE)")
    return _finish(plt, fig, path)


def plot_density_profile(env: medium.EnvParams, path=None, device=None):
    """Equatorial n_e(L) component profiles (plasmasphere.jl:134-155); the
    profile computes on `device` (density_profile_data)."""
    plt = _pyplot()
    d = density_profile_data(env, device)
    L, ne_i, ne_p = d["L"], d["ne_iono"], d["ne_plasma"]
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.semilogy(L, ne_i, label="ionosphere")
    ax.semilogy(L, ne_p, label="plasmasphere (CA1992)")
    ax.semilogy(L, ne_i + ne_p, label="total")
    ax.axvline(env.lppi, color="0.6", ls="--", lw=0.8, label="Lppi")
    ax.axvline(env.lppo, color="0.4", ls="--", lw=0.8, label="Lppo")
    ax.set_ylim(1e-1, 1e6)
    ax.set_xlabel("L (RE)")
    ax.set_ylabel("n_e (cm^-3)")
    ax.legend()
    ax.set_title("equatorial density profile")
    return _finish(plt, fig, path)
