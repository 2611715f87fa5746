"""The wave-particle chain through both packages, float64 on the CPU.

examples/lightning_to_lifetimes.py's chain (a traced fan -> growth along
each ray -> the equator crossings and the shell they pick -> a wave band
from the rays -> bounce-averaged D_aa -> precipitation lifetimes) and
examples/two_belt_structure.py's (tau(L) per probe shell -> radial
equilibria -> storm-recovery refilling), cut to a few rays, cells and
steps: the recipes are chip_smoke.py's (lightning_chain, two_belt_chain),
run over the JAX package and over the port (device="cpu"). The fan is
traced by each package: the JAX package's trace and the port's (its
plain version on the CPU). The end numbers agree to 1e-8 relative, the
ray sets exactly.

Run as a script, this file prints the JAX package's numbers of the whole
chains at the examples' sizes, which chip_smoke.py's phase 29 pins
(LIGHTNING_PINS, TWO_BELT_PINS): `PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_tiers_chain.py` (~1-2 min)."""

import functools
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from raytrace_tpu import diffusion as j_diff
from raytrace_tpu import fokker_planck as j_fp
from raytrace_tpu import growth as j_growth
from raytrace_tpu import radial as j_radial
from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import trace as j_trace
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate.solve import trace
from raytrace_tpu_torch.models import make_env_lat

import chip_smoke
from _tiers_parity import Side, assert_same

jax.config.update("jax_enable_x64", True)

# the cut: 4 rays of the fan (its extreme latitudes and frequencies) to
# 900 attempts (every ray crosses the equator by ~800), 2 + 3 energies on
# 24 cells; 7 probe shells, 60 radial cells, 300 CN steps
LIGHTNING_CUT = dict(chip_smoke.LIGHTNING, lats=np.array([0.76, 0.92]),
                     freqs=np.array([3000.0, 6000.0]), max_steps=900,
                     e_three=np.array([1000.0, 5000.0]),
                     e_scan=np.geomspace(500.0, 10000.0, 3), nc=24,
                     ba=dict(n_lat=12, n_grid=96, n_bisect=24))
TWO_BELT_CUT = dict(chip_smoke.TWO_BELT, l_probe=np.linspace(1.6, 6.4, 7),
                    nc=32, n_l=60, n_steps=300, save_every=100,
                    ba=dict(n_lat=12, n_grid=96, n_bisect=24))


def _tiers(port):
    """One package's tier functions, numpy in and out: the port's as
    chip_smoke.py builds them, on the CPU."""
    if port:
        return chip_smoke.tiers_for(torch.device("cpu"))
    sides = [Side(m, False) for m in (j_growth, j_diff, j_fp, j_radial)]
    names = dict(path_gain=0, HotElectrons=0, spectrum_from_rays=1,
                 WaveSpectrum=1, bounce_averaged=1, loss_cone_lifetime_s=1,
                 make_grid=2, precipitation_lifetime=2, make_l_grid=3,
                 dll_power_law=3, steady_state=3, evolve_radial=3)
    return SimpleNamespace(**{k: getattr(sides[i], k)
                              for k, i in names.items()})


def jax_fan_trace(conf):
    """The fan through the JAX package's trace: (traj u, traj status, f)."""
    env = j_make_env_lat()
    u0, f_g = chip_smoke.lightning_fan(conf)
    res = j_trace(lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env), u0, f_g,
                  cfg=JSolverConfig(rtol=conf["rtol"], atol=conf["atol"],
                                    dt0=conf["dt0"]),
                  spec=JStopSpec(r_floor=1.0, t_max=conf["t_max_m"] / RE),
                  max_steps=conf["max_steps"], save_every=conf["save_every"])
    return np.asarray(res.traj["u"]), np.asarray(res.traj["status"]), f_g


def port_fan_trace(conf):
    """The fan through the port's trace on the CPU (its plain version)."""
    u0, f, env, cfg, spec = chip_smoke.lightning_setup(torch.device("cpu"),
                                                       conf)
    res = trace(env, u0, f, cfg=cfg, spec=spec, stepper="dopri5",
                max_steps=conf["max_steps"], save_every=conf["save_every"])
    return res.traj["u"].numpy(), res.traj["status"].numpy(), f.numpy()


@functools.lru_cache(maxsize=None)
def _lightning(port):
    traj, st, f_g = (port_fan_trace if port else jax_fan_trace)(
        LIGHTNING_CUT)
    env = make_env_lat() if port else j_make_env_lat()
    return traj, st, chip_smoke.lightning_chain(_tiers(port), traj, st, f_g,
                                                env, LIGHTNING_CUT)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_lightning_fan_traces_alike():
    traj_t, st_t, _ = _lightning(True)
    traj_j, st_j, _ = _lightning(False)
    np.testing.assert_array_equal(st_t, st_j)
    # each state component to 1e-8 of its largest magnitude over the fan
    # (chi and T start at 0)
    scale = np.abs(traj_j).max(axis=(0, 1))
    assert (np.abs(traj_t - traj_j) <= 1e-8 * scale).all()


@pytest.mark.parametrize("key", [
    "crossed", "in_shell", "l_star", "f_m", "df", "bw_t", "f_lc", "f_uc",
    "l_eq", "has_wave", "tau_e", "tau_weak"])
def test_lightning_chain_matches_jax(key):
    got, want = _lightning(True)[2][key], _lightning(False)[2][key]
    assert_same(got, want, 1e-8, key)
    if key == "in_shell":
        assert want.any()


@pytest.mark.parametrize("key,axis,tol", [("gamma", 0, 1e-6),
                                          ("gain_neper", 0, 1e-6),
                                          ("daa3", 1, 1e-8)])
def test_lightning_profiles_match_jax(key, axis, tol):
    # the growth rate along each ray and D_aa over pitch angle, to tol of
    # the ray's (energy's) largest magnitude. The two traces part by up
    # to 1.7e-9 in r after 900 dopri5 attempts, and gamma ~ exp(-zeta^2)
    # (zeta^2 ~ 20 at a ray's peak, zeta ~ B ~ r^-3) carries that ~40x
    # further: 3.8e-8 of the peak measured. D_aa near a resonance edge
    # follows l_star's ~1e-10.
    got, want = _lightning(True)[2][key], _lightning(False)[2][key]
    scale = np.abs(want).max(axis=axis, keepdims=True)
    assert (scale > 0.0).all()
    assert (np.abs(got - want) <= tol * scale).all(), key


@functools.lru_cache(maxsize=None)
def _two_belt(port):
    if port:
        return chip_smoke.two_belt_chain(_tiers(True), make_env_lat(),
                                         conf=TWO_BELT_CUT)
    return chip_smoke.two_belt_chain(
        _tiers(False), j_make_env_lat(),
        bounce_averaged=Side(j_diff, False).bounce_averaged_jax,
        conf=TWO_BELT_CUT)


@pytest.mark.parametrize("key", ["tau", "s0", "f_bnd", "f_src_unit", "f_eq",
                                 "f_free", "snaps", "f_end"])
def test_two_belt_chain_matches_jax(key):
    assert_same(_two_belt(True)[key], _two_belt(False)[key], 1e-8, key)
    if key == "tau":
        assert np.isfinite(_two_belt(False)["tau"]).sum() >= 3


def main():
    """Print the JAX package's numbers of both chains at the examples'
    sizes (chip_smoke.py's LIGHTNING_PINS and TWO_BELT_PINS)."""
    def fmt(a):
        return "[" + ", ".join("math.inf" if np.isinf(x) else repr(float(x))
                               for x in np.ravel(a)) + "]"

    conf = chip_smoke.LIGHTNING
    traj, st, f_g = jax_fan_trace(conf)
    out = chip_smoke.lightning_chain(_tiers(False), traj, st, f_g,
                                     j_make_env_lat(), conf)
    print("LIGHTNING_PINS = dict(")
    print(f"    in_shell={np.flatnonzero(out['in_shell']).tolist()},")
    print(f"    crossed={int(out['crossed'].sum())},")
    for k in ("l_star", "f_m", "df", "bw_t"):
        print(f"    {k}={float(out[k])!r},")
    print(f"    has_wave={out['has_wave'].tolist()},")
    print(f"    tau_e={fmt(out['tau_e'])},")
    print(f"    tau_weak={fmt(out['tau_weak'])})")
    belt = chip_smoke.two_belt_chain(
        _tiers(False), j_make_env_lat(),
        bounce_averaged=Side(j_diff, False).bounce_averaged_jax)
    every = chip_smoke.TWO_BELT_EVERY
    print("TWO_BELT_PINS = dict(")
    print(f"    tau={fmt(belt['tau'])},")
    print(f"    s0={float(belt['s0'])!r},")
    for k in ("f_bnd", "f_src_unit", "f_free", "f_eq"):
        print(f"    {k}={fmt(belt[k][::every])},")
    print("    snaps=[" + ",\n           ".join(
        fmt(row[::every]) for row in belt["snaps"]) + "])")


if __name__ == "__main__":
    sys.exit(main())
