"""Port parity for raytrace_tpu_torch.sensitivity, float64 on the CPU,
against the JAX package's sensitivity.py (inputs from numpy seeds): the
variational right-hand side, the single-ray and batched landing
Jacobians on short legs, the secant, and the channel through run() and
the CLI. The JAX package's own tests/test_sensitivity.py (the canonical
ray's whole path) is slow; these legs are cut by the phase budget t_max,
one ray launched just above the ground on the canonical ray's path, so
that the surface event and its projection run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import sensitivity as j_sens
from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch import sensitivity as t_sens
from raytrace_tpu_torch.__main__ import main
from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig
from raytrace_tpu_torch.models import make_env, make_env_lat
from raytrace_tpu_torch.ops import rhs as t_rhs
from raytrace_tpu_torch.run import run

jax.config.update("jax_enable_x64", True)

R0 = (RE + 1.0e6) / RE
B0_3D = 3.12e-5
# a short leg: 3 RE of phase path, rtol 1e-9 (the module's default)
SPEC = dict(r_floor=1.0, t_max=3.0)
CFG = dict(rtol=1e-9, atol=1e-13)
# three launches of 1-2 kHz rays: up the field line at lat 45 and 40 deg,
# and the canonical ray's state 2 RE of phase path before it lands (the
# JAX package's trace at rtol 1e-9), which lands
U0 = np.array([[R0, np.pi / 4, 0.0, 0.0], [R0, 0.7, 0.2, 0.0],
               [1.0020197255289935, 0.06303038659715957, -3.086764540736551,
                3.1325639427591883]])
F = np.array([1000.0, 2000.0, 1000.0])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_fn(env):
    return lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env)


@pytest.mark.parametrize("frame", ["2d_lat", "3d_mlt"])
def test_variational_rhs_matches_jax(frame):
    """make_variational_rhs at random states and tangents, the full set of
    columns and two of them: every component within 1e-12 of its largest
    magnitude (2D: the canonical medium; 3D: the MLT-resolved
    plasmasphere, whose d ne/dphi the tangents carry)."""
    rng = np.random.default_rng(90)
    b = 32
    if frame == "2d_lat":
        n = 4
        u = np.stack([rng.uniform(1.05, 4.0, b), rng.uniform(-1, 1, b),
                      rng.uniform(-1, 1, b), rng.uniform(0, 3, b)], 1)
        je, te = j_make_env_lat(), make_env_lat()
        jfn = _jax_fn(je)
        tfn = t_rhs.frame_rhs("2d_lat", te)[0]
    else:
        n = 7
        u = np.stack([rng.uniform(1.05, 4.0, b), rng.uniform(0.4, 2.7, b),
                      rng.uniform(-3, 3, b), *rng.normal(size=(3, b)) * 20,
                      rng.uniform(0, 3, b)], 1)
        je = j_make_env(b0=B0_3D, ps_mlt=True)
        te = make_env(b0=B0_3D, ps_mlt=True)
        jfn = lambda uu, ff: j_rhs.rhs_3d(uu, ff, je)  # noqa: E731
        tfn = t_rhs.frame_rhs("3d", te)[0]
    f = rng.uniform(500.0, 8000.0, b)
    for k in (n, 2):
        ua = np.concatenate([u, rng.normal(size=(b, n * k))], 1)
        want = np.asarray(jax.vmap(j_sens.make_variational_rhs(jfn, n, k))(
            jnp.asarray(ua), jnp.asarray(f)))
        got = t_sens.make_variational_rhs(tfn, n, k)(
            torch.tensor(ua), torch.tensor(f)).numpy()
        scale = np.abs(want).max(axis=0)
        assert float(np.max(np.abs(got - want) / scale)) <= 1e-12, k


@pytest.fixture(scope="module")
def batch_pair():
    """landing_sensitivity_batch on the three launches, both packages."""
    want = j_sens.landing_sensitivity_batch(
        _jax_fn(j_make_env_lat()), U0, F, cfg=JSolverConfig(**CFG),
        spec=JStopSpec(**SPEC))
    got = t_sens.landing_sensitivity_batch(
        t_rhs.frame_rhs("2d_lat", make_env_lat())[0], U0, F,
        cfg=SolverConfig(**CFG), spec=StopSpec(**SPEC), device="cpu")
    return got, want


def test_landing_sensitivity_batch_matches_jax(batch_pair):
    """Statuses exactly (the third ray lands, the others run out of phase
    path); u_land at rtol 1e-10; the event-projected Jacobians at rtol
    1e-4, the band of the JAX package's own
    test_batched_sensitivity_matches_single (a tangent amplifies the last
    ulps), and the amplification likewise."""
    got, want = batch_pair
    np.testing.assert_array_equal(got["status"], want["status"])
    assert list(got["status"]) == [events.MAX_PHASE_TIME] * 2 + [
        events.HIT_EARTH]
    np.testing.assert_allclose(got["u_land"], want["u_land"], rtol=1e-10)
    np.testing.assert_allclose(got["jac"], want["jac"], rtol=1e-4,
                               atol=1e-12 * np.abs(want["jac"]).max())
    np.testing.assert_allclose(got["amplification"], want["amplification"],
                               rtol=1e-4)


def test_landing_sensitivity_single_with_tangents(batch_pair):
    """The single-ray tool on the landing ray with two tangent columns:
    the event projection is linear in the launch perturbation, so its
    Jacobian is the batch's full one times the tangents, to the
    integration's error (the two systems' error norms run over other
    columns, so their steps differ: rtol 1e-5); no amplification unless
    k == n; the landing state the batch's."""
    got_b, _ = batch_pair
    fn = t_rhs.frame_rhs("2d_lat", make_env_lat())[0]
    tan = np.eye(4)[:, :2] + 0.1
    got = t_sens.landing_sensitivity(
        fn, U0[2], F[2], cfg=SolverConfig(**CFG), spec=StopSpec(**SPEC),
        tangents=tan, device="cpu")
    assert got["status"] == events.HIT_EARTH
    assert got["amplification"] is None and got["jac"].shape == (4, 2)
    want = got_b["jac"][2] @ tan
    np.testing.assert_allclose(got["jac"], want, rtol=1e-5,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got["dlat_dlaunch"], got["jac"][1])
    np.testing.assert_allclose(got["u_land"], got_b["u_land"][2],
                               rtol=1e-10)


def test_landing_secant_matches_jax():
    """The central secant of the landing latitude on the landing ray (h =
    1e-6 in the launch latitude), and the refusal of a ray that does not
    land."""
    fn = t_rhs.frame_rhs("2d_lat", make_env_lat())[0]
    got = t_sens.landing_secant(fn, U0[2], F[2], spec=StopSpec(**SPEC),
                                device="cpu")
    want = j_sens.landing_secant(_jax_fn(j_make_env_lat()), U0[2], F[2],
                                 spec=JStopSpec(**SPEC))
    assert got == pytest.approx(want, rel=1e-6)
    with pytest.raises(RuntimeError, match="did not land"):
        t_sens.landing_secant(fn, U0[0], F[0], spec=StopSpec(**SPEC),
                              device="cpu")


def _cut(sensitivity_rays=2):
    """The first two launches of U0 as an explicit ray list of the
    canonical medium (make_env_lat's b0), at the settings of SPEC and CFG,
    float64, with the channel on for the first sensitivity_rays rays."""
    rays = tuple((float(u[1]), float(u[2]), float(ff))
                 for u, ff in zip(U0[:2], F[:2]))
    return preset("ensemble10k", rays=rays, dtype="float64",
                  sensitivity_rays=sensitivity_rays, **CFG, **SPEC)


def test_run_sensitivity_channel_on_the_cpu(tmp_path, batch_pair):
    """run(sensitivity_rays=2) on the first two launches of U0: the stats
    and the run record gain their amplification and status, those of
    landing_sensitivity_batch at the same settings (rtol 1e-10: the same
    rays in a batch of two, not three)."""
    conf = _cut()
    assert conf.solver() == SolverConfig(**CFG)
    out = run(conf, device="cpu", out_dir=str(tmp_path))
    st = out["stats"]
    got_b, _ = batch_pair
    np.testing.assert_array_equal(st["sensitivity_status"],
                                  got_b["status"][:2])
    np.testing.assert_allclose(st["sensitivity_amplification"],
                               got_b["amplification"][:2], rtol=1e-10)
    rec = json.load(open(out["paths"]["record"]))
    assert rec["stats"]["sensitivity_status"] == list(
        st["sensitivity_status"])


def test_cli_sensitivity_on_the_cpu(tmp_path, capsys):
    """python -m raytrace_tpu_torch <config.json> --device cpu
    --sensitivity 1 prints the channel's line and writes it into the
    record."""
    path = tmp_path / "cut.json"
    path.write_text(_cut(sensitivity_rays=0).to_json())
    assert main([str(path), "--device", "cpu", "--sensitivity", "1",
                 "--out", str(tmp_path / "out")]) == 0
    assert "landing sensitivity of the first 1 rays" in capsys.readouterr().out
    rec = json.load(open(tmp_path / "out" / "ensemble10k_record.json"))
    assert len(rec["stats"]["sensitivity_amplification"]) == 1
