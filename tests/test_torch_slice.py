"""Port parity for the slice as a whole: raytrace_tpu_torch.run.run against
raytrace_tpu.run.run on a cut ensemble10k preset (float64, CPU), the
interop round trips, the configuration, the CLI, and that the port never
imports JAX."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
import raytrace_tpu_torch.config as t_config
import raytrace_tpu_torch.run as t_run
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate.solve import RayCarry as JRayCarry
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu_torch.integrate.solve import RayCarry
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.models.medium import make_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 16 rays of the ensemble10k workload that land cleanly in < 1000 steps
CUT = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
           freqs=(2000.0, 3000.0), dtype="float64")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# with the preset's bs3 base, landing states carry the conditioning of
# bs3's error estimate (test_torch_step_chunk.py); dopri5 holds 1e-12
@pytest.mark.parametrize("base,rtol", [("bs3", 1e-8), ("dopri5", 1e-12)])
def test_run_matches_jax_run(base, rtol):
    j_out = j_run.run(j_config.preset("ensemble10k", base_stepper=base,
                                      **CUT))
    t_out = t_run.run(t_config.preset("ensemble10k", base_stepper=base,
                                      **CUT), device="cpu")
    n = int(t_out["valid"].sum())
    assert n == 16 and int(np.asarray(j_out["valid"]).sum()) == n
    jr, tr = j_out["result"], t_out["result"]
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, name)[:n],
                                      np.asarray(getattr(jr, name))[:n],
                                      err_msg=name)
    np.testing.assert_allclose(tr.u[:n], np.asarray(jr.u)[:n], rtol=rtol)
    np.testing.assert_allclose(tr.t[:n], np.asarray(jr.t)[:n], rtol=rtol)
    assert t_out["stats"].keys() == j_out["stats"].keys()
    for k, v in j_out["stats"].items():
        np.testing.assert_allclose(t_out["stats"][k], v, rtol=rtol, err_msg=k)
    assert int(t_out["stats"]["n_hit_earth"]) == 16


def test_interop_round_trips():
    je = j_make_env(b0=3.0696381e-5)
    te = env_from_numpy(je._asdict())
    assert te == make_env(b0=3.0696381e-5)
    assert env_from_numpy(te._asdict()) == te

    cfg = JSolverConfig(rtol=1e-6, atol=1e-9, dt0=1e-3, ds_max=0.25)
    assert tuple(solver_config_from(cfg)) == tuple(
        float(v) if not isinstance(v, tuple) else v for v in cfg)
    spec = JStopSpec(r_floor=1.01, t_max=7.0, stop_at_equator=1.0)
    assert tuple(stop_spec_from(spec)) == tuple(map(float, spec))
    assert stop_spec_from(JStopSpec()).r_ceil == float("inf")

    rng = np.random.default_rng(40)
    d = {name: (rng.integers(0, 99, 5).astype(np.int32)
                if name in ("status", "n_accept", "n_reject", "rejected",
                            "n_tiny", "caution")
                else rng.normal(size=(5, 4) if name in
                                ("u", "k1", "u_prev", "u_lo") else 5))
         for name in RayCarry._fields}
    carry = carry_from_numpy(JRayCarry(**{k: jnp.asarray(v)
                                          for k, v in d.items()}),
                             device="cpu", dtype=torch.float64)
    assert carry.status.dtype == torch.int32
    assert carry.u.dtype == torch.float64
    back = carry_to_numpy(carry)
    for name in RayCarry._fields:
        np.testing.assert_array_equal(back[name], d[name], err_msg=name)
    JRayCarry(**back)   # converts back field by field


def test_config_json_round_trips_across_packages():
    t_cfg = t_config.preset("ensemble10k")
    j_cfg = j_config.preset("ensemble10k")
    assert json.loads(t_cfg.to_json()) == json.loads(j_cfg.to_json())
    assert t_config.RunConfig.from_json(j_cfg.to_json()) == t_cfg
    assert t_cfg.solver() == tuple(j_cfg.solver())
    assert tuple(t_cfg.stop()) == tuple(j_cfg.stop())
    assert t_config.preset("ensemble10k", dtype="float32").solver().rtol == (
        j_config.preset("ensemble10k", dtype="float32").solver().rtol)
    for name in ("lat_fan", "knee"):
        assert json.loads(t_config.preset(name).to_json()) == json.loads(
            j_config.preset(name).to_json())


# every preset of the JAX package is served (no name is refused,
# test_torch_slice_variants.py); what a preset still refuses is a feature
# the port has not ported, switched on by an override: the autodiff
# gradient set in the rounds tracer -- also with the trajectory channel
# and explicit ray lists, which run since they were ported
# (tests/test_torch_trajectory.py). The reference gradient set over the
# EXT media (the local ceiling) and the sensitivity rays run since the
# ALTX instances and sensitivity.py: those cases run a cut fan (one ray,
# 16 attempts, and a phase budget short enough that the variational
# system stops within its first check)
_CUT = {"ensemble10k_local": dict(lats=(0.8,), chis=(0.3,),
                                  freqs=(2000.0,), max_steps=16),
        "emic_heband": dict(lats=(0.0,), chis=(0.0,), freqs=(1.0,),
                            max_steps=16, t_max=0.5)}


def _runs_cut(conf):
    """A case ported since: the cut run ends with every ray stopped or at
    its budget, finite, and with the sensitivity channel's stats when it
    is on."""
    out = t_run.run(conf, device="cpu")
    assert np.isfinite(out["result"].u[out["valid"]]).all()
    if conf.sensitivity_rays:
        amp = out["stats"]["sensitivity_amplification"]
        assert amp.size == min(conf.sensitivity_rays,
                               int(np.sum(out["valid"])))
        assert np.isfinite(amp).all()


@pytest.mark.parametrize("name,over", [
    ("raymain", dict(save_every=8, grad_mode="autodiff")),
    ("ensemble10k_local", dict(save_every=8, grad_mode="reference")),
    ("ensemble10k_local", dict(rays=((0.8, 0.3, 2000.0),),
                               grad_mode="reference")),
    ("emic_heband", dict(grad_mode="autodiff")),
    ("emic_heband", dict(sensitivity_rays=4)),
])
def test_unported_presets_raise(name, over):
    if over.get("grad_mode") != "autodiff":
        _runs_cut(t_config.preset(name, **{**_CUT[name], **over}))
        return
    conf = t_config.preset(name, **over)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_run.run(conf, device="cpu")


# the single-program path, the trajectory channel and ray lists run
# (tests/test_torch_trajectory.py); each is held here to the features
# that stay refused on it (the autodiff set), and the features ported
# since (the reference set over the local ceiling, the sensitivity rays)
# run on it
@pytest.mark.parametrize("kw", [
    dict(grad_mode="autodiff"), dict(use_rounds=False, grad_mode="autodiff"),
    dict(save_every=8, ds_local=True, grad_mode="reference"),
    dict(sensitivity_rays=2),
    dict(rays=((0.8, 0.3, 2000.0),), sensitivity_rays=1),
])
def test_run_refuses_unported_features(kw):
    cfg = t_config.preset("ensemble10k", lats=(0.8,), chis=(0.3,),
                          freqs=(2000.0,), max_steps=8, **kw)
    if kw.get("grad_mode") != "autodiff":
        cfg.t_max = 0.5
        _runs_cut(cfg)
        return
    with pytest.raises(NotImplementedError):
        t_run.run(cfg, device="cpu")


def _python(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    # every module of the package (the 3D slice's, the trajectory
    # channel's, the physics tiers' and the 2D solver's with its kernel
    # wrapper included) and the smoke
    proc = _python("-c", (
        "import importlib, pkgutil, sys\n"
        "import raytrace_tpu_torch, raytrace_tpu_torch.__main__, chip_smoke\n"
        "for m in pkgutil.walk_packages(raytrace_tpu_torch.__path__, "
        "'raytrace_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('ops.fused', 'integrate.saving', 'parallel.checkpoint',"
        " 'utils.runrecord', 'utils.profiling', 'utils.debug', 'growth',"
        " 'diffusion', 'fokker_planck', 'radial', 'drift',"
        " 'fokker_planck_2d', 'convection', 'ops.cn_pcg_2d'):\n"
        "    assert 'raytrace_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'raytrace_tpu' or m.startswith('raytrace_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_runs_on_the_device_asked_for(tmp_path):
    cfg = t_config.preset("ensemble10k", lats=(0.9,), chis=(0.5,),
                          freqs=(3000.0,))
    path = tmp_path / "tiny.json"
    cfg.to_json(str(path))
    proc = _python("-m", "raytrace_tpu_torch", str(path), "--device", "cpu",
                   "--float64")
    assert proc.returncode == 0, proc.stderr
    assert "1 rays" in proc.stdout and "HIT_EARTH=1" in proc.stdout
    dump = _python("-m", "raytrace_tpu_torch", "ensemble10k", "--dump-config")
    assert json.loads(dump.stdout) == json.loads(
        t_config.preset("ensemble10k").to_json())
    if not torch.cuda.is_available():
        # the default device is the card; without one the CLI stops
        # instead of falling back to the CPU
        proc = _python("-m", "raytrace_tpu_torch", str(path))
        assert proc.returncode == 2 and "--device cpu" in proc.stderr
