"""Port parity: the plots (raytrace_tpu_torch/viz/plots.py) against the
JAX package's (raytrace_tpu/viz/plots.py), on the CPU.

Each of the five plots renders to a PNG of more than 5,000 bytes (as
tests/test_diagnostics.py::test_plots_render holds the JAX package's),
and the data each figure draws, read back from its artists, equals the
JAX figure's on the same inputs: exactly where the figure draws its
inputs, to 1e-12 where the medium is computed (the port's data helpers
in float64 against the JAX package's vmapped functions). Without
matplotlib, --plots raises an ImportError that names it."""

import sys

import numpy as np
import pytest
import torch

import raytrace_tpu.viz as j_viz
import raytrace_tpu_torch.config as t_config
import raytrace_tpu_torch.viz as t_viz
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu_torch.__main__ import main as t_main
from raytrace_tpu_torch.integrate.saving import save_fn_for
from raytrace_tpu_torch.integrate.solve import SolverConfig, trace
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.run import run as t_run

plt = pytest.importorskip("matplotlib.pyplot")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traj():
    """A short 2-ray trajectory with the diagnostics, traced by the port
    (float64, the plain version): (u (S, B, 4), t (S, B), extras)."""
    env = make_env_lat()
    u0 = torch.tensor([[1.157, 0.7, 0.0, 0.0], [1.157, 0.9, 0.3, 0.0]],
                      dtype=torch.float64)
    res = trace(env, u0, torch.tensor([2000.0, 3000.0], dtype=torch.float64),
                cfg=SolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4),
                stepper="dopri5", max_steps=96, save_every=8,
                save_fn=save_fn_for("2d_lat", env))
    return {k: v.numpy() for k, v in res.traj.items()}


def _lines(fig):
    return [line.get_xydata() for ax in fig.axes for line in ax.lines]


def _images(fig):
    return [np.ma.filled(im.get_array().astype(np.float64), np.nan)
            for ax in fig.axes for im in ax.images]


def _same(got, ref, rtol):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(a, b)


def _figures(name, traj):
    """(port figure, JAX figure) of one plot on the same inputs."""
    t_env, j_env = make_env_lat(), j_make_env_lat()
    if name == "ray_paths":
        return (t_viz.plot_ray_paths(traj["u"]),
                j_viz.plot_ray_paths(traj["u"]))
    if name == "diagnostics":
        args = (traj["t"][:, 0], traj["extras"][:, 0, :])
        return t_viz.plot_diagnostics(*args), j_viz.plot_diagnostics(*args)
    if name == "refractive_surface":
        args = (2.0, 0.24, 5000.0)
        return (t_viz.plot_refractive_surface(*args, t_env, n_psi=500,
                                              device="cpu"),
                j_viz.plot_refractive_surface(*args, j_env, n_psi=500))
    if name == "environment":
        return (t_viz.plot_environment(t_env, n=80, device="cpu"),
                j_viz.plot_environment(j_env, n=80))
    return (t_viz.plot_density_profile(t_env, device="cpu"),
            j_viz.plot_density_profile(j_env))


# the figures that draw their inputs must equal the JAX figures exactly;
# those that compute the medium agree to 1e-12
@pytest.mark.parametrize("name,rtol", [
    ("ray_paths", 0), ("diagnostics", 0), ("refractive_surface", 1e-12),
    ("environment", 1e-12), ("density_profile", 1e-12),
])
def test_figure_data_matches_jax(name, rtol, traj):
    fig, j_fig = _figures(name, traj)
    try:
        if name == "environment":   # the two maps (log10 n_e, log10 |B|)
            _same(_images(fig), _images(j_fig), rtol)
        else:
            _same(_lines(fig), _lines(j_fig), rtol)
    finally:
        plt.close(fig)
        plt.close(j_fig)


def test_plots_render(tmp_path, traj):
    """Mirror of test_diagnostics.py::test_plots_render: the five plots
    render to PNG files of more than 5,000 bytes."""
    env = make_env_lat()
    paths = [tmp_path / f"{k}.png" for k in
             ("rays", "diag", "surface", "envmap", "profile")]
    t_viz.plot_ray_paths(traj["u"], path=str(paths[0]))
    t_viz.plot_diagnostics(traj["t"][:, 0], traj["extras"][:, 0, :],
                           path=str(paths[1]))
    t_viz.plot_refractive_surface(2.0, 0.24, 5000.0, env, path=str(paths[2]),
                                  n_psi=500, device="cpu")
    t_viz.plot_environment(env, path=str(paths[3]), n=80, device="cpu")
    t_viz.plot_density_profile(env, path=str(paths[4]), device="cpu")
    for p in paths:
        assert p.exists() and p.stat().st_size > 5000, p


def test_data_helpers_shapes():
    """The helpers chip_smoke.py runs without matplotlib: their arrays at
    the plots' default sizes, finite outside the Earth."""
    env = make_env_lat()
    s = t_viz.refractive_surface_data(2.0, 0.24, 5000.0, env, device="cpu")
    assert s["mu"].shape == s["psi"].shape == (6284,)
    assert np.isfinite(s["mu"]).all()
    e = t_viz.environment_data(env, n=40, device="cpu")
    out = e["r"] >= 1.0
    assert e["ne"].shape == (40, 40) and np.isfinite(e["ne"][out]).all()
    assert np.isnan(e["b"][~out]).all() and (e["b"][out] > 0).all()
    d = t_viz.density_profile_data(env, device="cpu")
    assert d["ne_plasma"].shape == (2000,) and (d["ne_iono"] > 0).all()


def test_data_helpers_default_to_the_card(monkeypatch):
    """With no device named the helpers compute on the card, and without
    one they raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_viz.environment_data(make_env_lat(), n=4)


def _tiny_json(tmp_path):
    cfg = t_config.preset("ensemble10k", lats=(0.9,), chis=(0.5,),
                          freqs=(3000.0,), max_steps=128)
    path = tmp_path / "tiny.json"
    cfg.to_json(str(path))
    return path


def test_cli_plots_without_matplotlib(tmp_path, monkeypatch):
    """--plots on a machine without matplotlib raises an ImportError that
    names matplotlib and --plots, before any tracing."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib") as e:
        t_main([str(_tiny_json(tmp_path)), "--device", "cpu", "--plots",
                "--out", str(tmp_path / "out")])
    assert "--plots" in str(e.value)
    assert not (tmp_path / "out").exists()


def test_cli_plots_draw_the_trajectory(tmp_path):
    """--plots with --trajectory goes through run(plots=True) and writes
    <name>_rays.png beside the trajectory; the figure draws the written
    trajectory."""
    out = tmp_path / "out"
    assert t_main([str(_tiny_json(tmp_path)), "--device", "cpu",
                   "--float64", "--trajectory", "32", "--plots", "--out",
                   str(out)]) == 0
    png = out / "ensemble10k_rays.png"
    assert png.exists() and png.stat().st_size > 5000
    with np.load(out / "ensemble10k_traj.npz") as z:
        u = z["u"]
    fig = t_viz.plot_ray_paths(u)
    rays = [line.get_xydata() for line in fig.axes[0].lines[7:]]
    plt.close(fig)
    assert len(rays) == u.shape[1]
    np.testing.assert_array_equal(rays[0][:, 0],
                                  u[:, 0, 0] * np.cos(u[:, 0, 1]))


def test_run_plots_needs_a_trajectory(tmp_path):
    """run(plots=True) without the trajectory channel draws nothing, as
    the JAX package's run() does."""
    out = t_run(t_config.preset("ensemble10k", lats=(0.9,), chis=(0.5,),
                                freqs=(3000.0,), max_steps=64,
                                dtype="float64"),
                device="cpu", out_dir=str(tmp_path), plots=True)
    assert "rays_png" not in out["paths"] and "final" in out["paths"]
