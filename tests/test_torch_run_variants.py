"""Port parity for the paths of the last step variants as a whole, float64
on the CPU: raymain (the colatitude frame's single ray), emic_heband (the
multi-ion EMIC fan, its step budget cut), and small fans of
ensemble10k_local (the local arc ceiling), of ensemble10k in the
colatitude frame and of ensemble10k with fixed-step rk4, each through
raytrace_tpu_torch.run.run against raytrace_tpu.run.run, and the
colatitude frame's launch."""

import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
import raytrace_tpu_torch.config as t_config
import raytrace_tpu_torch.run as t_run
from raytrace_tpu_torch.constants import RE

# 16 rays of the 2D fan that land within a few hundred steps (the cut of
# test_torch_slice.py; for rk4 at the reference ceiling 1e6 m), and 8 that
# do so in the colatitude frame
CUT = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
           freqs=(2000.0, 3000.0), dtype="float64")
CUT_COLAT = dict(frame="2d_colat", lats=(0.95, 1.0, 1.05, 1.1),
                 chis=(-0.5,), freqs=(6649.9, 8000.0), dtype="float64")
CUT_RK4 = dict(CUT, lats=(0.9, 1.0, 1.05, 1.1), freqs=(4600.0, 6650.0),
               adaptive=False, dt0=1.0e6 / RE)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# (preset, overrides, rtol of the final states): the bs3 bases carry the
# conditioning of bs3's error estimate into the landing states (~1e-8,
# test_torch_slice.py); dopri5 (raymain, emic_heband) and rk4 hold 1e-9
RUNS = {
    "raymain": ("raymain", dict(dtype="float64"), 1e-9),
    "emic_heband": ("emic_heband", dict(dtype="float64", max_steps=256),
                    1e-9),
    "ensemble10k_local": ("ensemble10k_local", CUT, 1e-7),
    "colat": ("ensemble10k", CUT_COLAT, 1e-7),
    "rk4": ("ensemble10k", CUT_RK4, 1e-9),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_matches_jax_run(run):
    name, over, rtol = RUNS[run]
    j_out = j_run.run(j_config.preset(name, **over))
    t_out = t_run.run(t_config.preset(name, **over), device="cpu")
    n = int(t_out["valid"].sum())
    assert n == int(np.asarray(j_out["valid"]).sum())
    jr, tr = j_out["result"], t_out["result"]
    for field in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, field)[:n],
                                      np.asarray(getattr(jr, field))[:n],
                                      err_msg=field)
    ju = np.asarray(jr.u)[:n]
    scale = np.abs(ju).max(axis=0)
    assert (np.abs(tr.u[:n] - ju) <= rtol * scale).all()
    np.testing.assert_allclose(tr.t[:n], np.asarray(jr.t)[:n], rtol=rtol)
    assert t_out["stats"].keys() == j_out["stats"].keys()
    for k, v in j_out["stats"].items():
        np.testing.assert_allclose(t_out["stats"][k], v, rtol=rtol,
                                   err_msg=k)
    if run != "emic_heband":
        assert int(t_out["stats"]["n_hit_earth"]) == n
    if run == "rk4":
        assert int(t_out["stats"]["total_rejected_steps"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_colat_launch_matches_jax(dtype):
    """The colatitude frame's launch: theta = pi/2 - lat formed in the run
    dtype, as the JAX package forms it."""
    np_dt = np.float32 if dtype == "float32" else np.float64
    conf = dict(CUT_COLAT, dtype=dtype)
    uj, fj = j_run._build_u0(j_config.preset("ensemble10k", **conf), np_dt)
    t_cfg = t_config.preset("ensemble10k", **conf)
    ut, ft = t_run._build_u0(t_cfg, t_cfg.medium.build(), np_dt,
                             torch.device("cpu"))
    assert ut.dtype == np_dt
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(ft, fj)
