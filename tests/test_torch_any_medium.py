"""Port parity for the media and step ceilings the port once refused: a
fractional plasmasphere weight (ps_weight) and diffusive-equilibrium
weight (de_weight), any count of MLT harmonics (0 included: a constant
plasmapause shape) and of local-ceiling shells, and the autodiff set over
the MLT medium at 0 harmonics. Each is held to the JAX package on the CPU
in float64: the density and the fused and autodiff chains at rtol 1e-12,
the step kernel's plain version, and small fans traced end to end
(statuses and step counters exactly, landing L at 1e-9).

Run as a script, the file prints the JAX package's float64 and float32
censuses of the full-width paths that chip_smoke.py phase 35 pins
(ensemble10k_plume at 12 harmonics, ensemble10k at ps_weight = 0.5, every
4th ray of ensemble10k with the DE factor at de_weight = 0.5), traced on
the CPU in one batch through the JAX package's rounds tracer, as run()
traces a launch (a few minutes each; in batches of 1,024 rays, the stall
checks of a few stragglers fall elsewhere and move them between
DT_UNDERFLOW and MAX_STEPS), and the two dtypes' agreement (the share of rays
with equal statuses, the median relative landing-L error of the rays that
land in both); with --nudge instead, the rays whose float64 status moves
when every launch latitude moves up by one ulp (the run's own sensitivity
to rounding) and the status each then takes:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_any_medium.py \\
        plume12|ps_half|de_half [--nudge]
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import config as j_config
from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import solve as j_solve
from raytrace_tpu.models import cast_env
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import fused as j_fused
from raytrace_tpu.ops import gradients as j_grad
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu.parallel import ensemble as j_ens
from raytrace_tpu_torch import config as t_config
from raytrace_tpu_torch.constants import B0_2D, B0_3D
from raytrace_tpu_torch.integrate import events, solve
from raytrace_tpu_torch.integrate.solve import RayCarry
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import dispersion, fused, gradients
from raytrace_tpu_torch.ops import step_chunk as sc
from raytrace_tpu_torch.parallel import ensemble
from raytrace_tpu_torch.run import _build_u0

# the full-width paths of chip_smoke.py phase 35: (preset, medium fields,
# env fields replaced after the build, every k-th ray of the launch)
CENSUS_CASES = {
    "plume12": ("ensemble10k_plume", dict(ps_mlt_harmonics=12), {}, 1),
    "ps_half": ("ensemble10k", {}, dict(ps_weight=0.5), 1),
    "de_half": ("ensemble10k", dict(de_correction=True),
                dict(de_weight=0.5), 4),
}


def _jax_census(case, dtype="float64", batch=None, nudge=False):
    """The JAX package's census of a CENSUS_CASES entry on the CPU: the
    preset's launch (every k-th ray) over its medium with the fields
    replaced, through make_rounds_tracer with run()'s keywords, in batches
    of `batch` rays (one batch by default). Returns ({status name: count, steps, median_l, rays},
    each ray's status, each ray's landing L, NaN where it does not
    land)."""
    import raytrace_tpu.run as j_run
    from raytrace_tpu.integrate import events as j_events
    from raytrace_tpu.integrate.solve import TraceResult
    from raytrace_tpu.parallel import ensemble_stats

    name, med, env_over, every = CENSUS_CASES[case]
    cfg = j_config.preset(name, dtype=dtype)
    cfg = dataclasses.replace(cfg, medium=dataclasses.replace(cfg.medium,
                                                              **med))
    np_dt = np.float32 if dtype == "float32" else np.float64
    u0, f = j_run._build_u0(cfg, np_dt)
    u0, f = u0[::every], f[::every]
    if nudge:
        u0[:, 1] = np.nextafter(u0[:, 1], np.inf)
    kw = dict(frame=cfg.frame, cfg=cfg.solver(), spec=cfg.stop(),
              adaptive=cfg.adaptive, stepper=cfg.stepper,
              max_steps=cfg.max_steps, grad_mode=cfg.grad_mode,
              root=cfg.root, want_carry=False,
              base_stepper=cfg.base_stepper)
    if cfg.round_steps:
        kw["round_steps"] = tuple(cfg.round_steps)
    env = cfg.medium.build()._replace(**env_over)
    tracer = j_ens.make_rounds_tracer(cast_env(env, np_dt), **kw)
    cols = {k: [] for k in ("u", "status", "n_accept", "n_reject")}
    batch = batch or u0.shape[0]
    for start in range(0, u0.shape[0], batch):
        ub, fb = u0[start:start + batch], f[start:start + batch]
        res = tracer(ub, fb, np.ones(ub.shape[0], bool))
        for k in cols:
            cols[k].append(np.asarray(getattr(res, k)))
    arrays = {k: np.concatenate(v) for k, v in cols.items()}
    spec = cfg.stop()
    stats = ensemble_stats(
        TraceResult(u=arrays["u"], t=None, status=arrays["status"],
                    n_accept=arrays["n_accept"], n_reject=arrays["n_reject"]),
        np.ones(u0.shape[0], bool), lat_sign=spec.lat_sign,
        lat_offset=spec.lat_offset, xp=np)
    status = arrays["status"]
    out = {nm: int((status == k).sum())
           for k, nm in enumerate(j_events.STATUS_NAMES)
           if (status == k).any()}
    out["steps"] = int(arrays["n_accept"].sum() + arrays["n_reject"].sum())
    out["median_l"] = float(np.asarray(stats["median_landing_l"]))
    out["rays"] = int(u0.shape[0])
    u = arrays["u"].astype(np.float64)
    # the 2D latitude frame carries the latitude, the 3D frame colatitude
    trig = np.cos if cfg.frame == "2d_lat" else np.sin
    land = np.where(status == j_events.HIT_EARTH,
                    u[:, 0] / trig(u[:, 1]) ** 2, np.nan)
    return out, status, land


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, rtol, what):
    """Each output within rtol of its largest magnitude over the points (a
    partial that crosses zero has no useful pointwise relative error);
    finite where the JAX package's is."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), what
    ok = np.isfinite(want)
    scale = max(float(np.abs(want[ok]).max(initial=0.0)), 1e-300)
    err = float(np.abs(got[ok] - want[ok]).max(initial=0.0)) / scale
    assert err <= rtol, f"{what}: {err:.3e}"


def _points(seed, n=256):
    """3D states across the plasmasphere, the knee and the trough, every
    local time: (r, theta, phi, rho_r, rho_t, rho_p, f)."""
    rng = np.random.default_rng(seed)
    rho = rng.normal(size=(3, n))
    rho = rng.uniform(2.0, 40.0, n) * rho / np.linalg.norm(rho, axis=0)
    return (rng.uniform(1.05, 6.0, n), rng.uniform(0.5, np.pi - 0.5, n),
            rng.uniform(-4.0, 7.0, n), rho[0], rho[1], rho[2],
            rng.uniform(500.0, 8000.0, n))


# ---- fractional plasmasphere and DE weights ------------------------------

WEIGHTS = (0.25, 0.5, 0.75)
# (make_env keywords, frame) of the media the weights are held over: the
# axisymmetric medium, GCPM and the multi-ion plasma in the 2D chain, the
# MLT-resolved plasmasphere in the 3D dipole chain, the tilted dipole (with
# it) in the general chain; the DE factor on in every one
WEIGHT_MEDIA = {
    "axi": (dict(b0=B0_2D), "2d"),
    "gcpm": (dict(b0=B0_2D, ps_model="gcpm"), "2d"),
    "multi_ion": (dict(b0=B0_2D, eta_he=0.1, eta_o=0.02), "2d"),
    "mlt": (dict(b0=B0_3D, ps_mlt=True), "3d"),
    "tilted_mlt": (dict(b0=B0_3D, ps_mlt=True, b_model="tilted",
                        b_tilt=0.2, b_tilt_phi=0.5), "3d"),
}


def _weighted_envs(name, which, w):
    kw, _ = WEIGHT_MEDIA[name]
    je = j_medium.make_env(de_correction=True, **kw)._replace(
        **{f"{which}_weight": w})
    te = medium.make_env(de_correction=True, **kw)._replace(
        **{f"{which}_weight": w})
    assert env_from_numpy(je._asdict()) == te
    return je, te


@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("which", ["ps", "de"])
@pytest.mark.parametrize("name", sorted(WEIGHT_MEDIA))
def test_fractional_weights_match_jax(name, which, w):
    """ne_total_m3, the fused density chain and the fused mu chain (2D:
    mu_and_grads_2d_lat; 3D: the dipole chain or the general one) at a
    fractional ps_weight or de_weight, float64, each output within 1e-12
    of its scale; the weight moves every output (against the weight 1)."""
    je, te = _weighted_envs(name, which, w)
    r, th, ph, rr, rt, rp, f = _points(11)
    lat = np.pi / 2 - th
    three_d = WEIGHT_MEDIA[name][1] == "3d"
    phi_j, phi_t = (jnp.asarray(ph), torch.tensor(ph)) if three_d else (
        None, None)
    ne_t = medium.ne_total_m3(torch.tensor(r), torch.tensor(lat), te,
                              phi=phi_t)
    ne_j = j_medium.ne_total_m3(jnp.asarray(r), jnp.asarray(lat), je,
                                phi=phi_j)
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=1e-12)
    one = medium.ne_total_m3(torch.tensor(r), torch.tensor(lat),
                             te._replace(**{f"{which}_weight": 1.0}),
                             phi=phi_t)
    assert float(((ne_t - one) / one).abs().max()) > 1e-5
    if three_d and te.b_model == "dipole":
        got = fused._ne_and_grads(torch.tensor(r), torch.tensor(lat), te,
                                  mlt=fused.mlt_params(phi_t, te))
        want = j_fused._ne_and_grads(
            jnp.asarray(r), jnp.asarray(lat), je,
            mlt=j_medium.mlt_ps_params(phi_j, je, with_grads=True))
    else:
        got = fused._ne_and_grads(torch.tensor(r), torch.tensor(lat), te)
        want = j_fused._ne_and_grads(jnp.asarray(r), jnp.asarray(lat), je)
    for what, a, b in zip(("ne", "dne/dr", "dne/dlat", "dne/dphi"), got,
                          want):
        _close(a.numpy(), b, 1e-12, f"{name} {which} {w} {what}")
    if not three_d:
        chi = np.random.default_rng(12).uniform(-0.5, 0.5, r.size)
        pts = (r, lat, chi, f)
        got = fused.mu_and_grads_2d_lat(*map(torch.tensor, pts), te)
        want = j_fused.mu_and_grads_2d_lat(*map(jnp.asarray, pts), je)
    else:
        pts = (r, th, ph, rr, rt, rp, f)
        chain, j_chain = (
            (fused.mu_and_grads_3d, j_fused.mu_and_grads_3d)
            if te.b_model == "dipole" else
            (fused.mu_and_grads_3d_general, j_fused.mu_and_grads_3d_general))
        mu, grads = chain(*map(torch.tensor, pts), te)
        jmu, jgrads = jax.vmap(lambda *a: j_chain(*a, je))(
            *map(jnp.asarray, pts))
        got, want = (mu, *grads), (jmu, *jgrads)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12)
    for k, (a, b) in enumerate(zip(got[1:], want[1:])):
        _close(a.numpy(), b, 1e-12, f"{name} {which} {w} partial {k}")


# ---- MLT shapes of any harmonic count ------------------------------------

@pytest.mark.parametrize("ps_model", ["ca1992", "gcpm"])
@pytest.mark.parametrize("n_harm", [0, 12, 24])
def test_any_harmonic_count_matches_jax(n_harm, ps_model):
    """The MLT plasmapause shape (_mlt_shape) and the effective parameters
    with their phi-slopes, ne_total_m3 at phi and the fused 3D chain with
    d mu/d phi at 0, 12 and 24 harmonics, float64, within 1e-12. With no
    harmonic the shape is the constant c0 = 1 (a tensor here, a Python
    float there) and d shape/d phi is 0; the trough still moves with
    local time."""
    kw = dict(b0=B0_3D, ps_mlt=True, ps_mlt_harmonics=n_harm,
              ps_model=ps_model)
    je, te = j_medium.make_env(**kw), medium.make_env(**kw)
    assert len(te.ps_mlt_c) == 1 + 2 * n_harm
    assert env_from_numpy(je._asdict()) == te
    r, th, ph, rr, rt, rp, f = _points(13)
    lat = np.pi / 2 - th
    got = medium._mlt_shape(torch.tensor(ph), te)
    want = j_medium._mlt_shape(jnp.asarray(ph), je)
    for what, a, b in zip(("shape", "dshape", "trough", "dtrough"), got,
                          want):
        b = np.broadcast_to(np.asarray(b), ph.shape)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(b).max()),
                                   err_msg=what)
    if n_harm == 0:
        assert (got[0] == 1.0).all() and (got[1] == 0.0).all()
    params = (medium.mlt_gcpm_params if ps_model == "gcpm"
              else medium.mlt_ps_params)(torch.tensor(ph), te,
                                         with_grads=True)
    j_params = (j_medium.mlt_gcpm_params if ps_model == "gcpm"
                else j_medium.mlt_ps_params)(jnp.asarray(ph), je,
                                             with_grads=True)
    for gs, ws in zip(params, j_params):
        for a, b in zip(gs, ws):
            b = np.broadcast_to(np.asarray(b), ph.shape)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                       atol=1e-12 * float(np.abs(b).max()))
    ne_t = medium.ne_total_m3(torch.tensor(r), torch.tensor(lat), te,
                              phi=torch.tensor(ph))
    ne_j = j_medium.ne_total_m3(jnp.asarray(r), jnp.asarray(lat), je,
                                phi=jnp.asarray(ph))
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=1e-12)
    pts = (r, th, ph, rr, rt, rp, f)
    mu, grads = fused.mu_and_grads_3d(*map(torch.tensor, pts), te)
    jmu, jgrads = jax.vmap(lambda *a: j_fused.mu_and_grads_3d(*a, je))(
        *map(jnp.asarray, pts))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-12)
    for k, (a, b) in enumerate(zip(grads, jgrads)):
        _close(a.numpy(), b, 1e-12, f"{n_harm} {ps_model} partial {k}")
    assert float(np.abs(np.asarray(jgrads[2])).max()) > 0.0   # d mu/d phi


@pytest.mark.parametrize("name", ["ca1992", "gcpm_smooth"])
def test_autodiff_3d_at_0_harmonics_matches_jax(name):
    """The autodiff set over the MLT medium with a constant plasmapause
    shape: the dual chain carries the shape without a tangent, and the
    gradients equal the JAX package's value_and_grad within 1e-12 of each
    partial's scale, torch.func.jvp of the port's chain bit for bit, and
    the fused chain within 1e-11 (the two sets' roundings)."""
    kw = dict(b0=B0_3D, ps_mlt=True, ps_mlt_harmonics=0)
    if name == "gcpm_smooth":
        kw.update(ps_model="gcpm", duct_amp=0.5, duct_l0=3.0, duct_w=0.1)
    else:
        kw.update(ps_smooth=0.05, ps_refill=0.5)
    je, te = j_medium.make_env(**kw), medium.make_env(**kw)
    pts = _points(17, n=64)
    args = tuple(map(torch.tensor, pts))
    mu, grads = gradients.mu_grads_3d(*args, te, "autodiff")
    jmu, jgrads = jax.vmap(lambda *a: j_grad.mu_grads_3d(*a, je,
                                                         "autodiff"))(
        *map(jnp.asarray, pts))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-12)
    for k, (a, b) in enumerate(zip(grads, jgrads)):
        _close(a.numpy(), b, 1e-12, f"{name} partial {k}")
    for k in range(len(args)):
        tang = tuple(torch.ones_like(a) if i == k else torch.zeros_like(a)
                     for i, a in enumerate(args))
        row = torch.func.jvp(lambda *a: dispersion.mu_3d(*a, te), args,
                             tang)[1]
        np.testing.assert_array_equal(grads[k].numpy(), row.numpy())
    _, fz = gradients.mu_grads_3d(*args, te)
    for k, (a, b) in enumerate(zip(grads, fz)):
        _close(a.numpy(), b.numpy(), 1e-11, f"{name} fused partial {k}")
    assert float(np.abs(np.asarray(jgrads[2])).max()) > 0.0


# ---- the local arc ceiling over any shell count --------------------------

SIX_SHELLS = ((2.5, 0.05), (3.0, 0.1), (3.5, 0.1), (5.0, 0.2), (6.0, 0.3))


def test_six_shell_local_ceiling_matches_jax():
    """The local arc ceiling over the knee and five more shells (past the
    four the kernel's parameters hold) in the latitude and colatitude
    frames' maps, float64, to the last bit but the cosine's rounding
    (1e-15), and the shells bind: dropping the last two moves it."""
    rng = np.random.default_rng(19)
    u = np.stack([rng.uniform(1.0, 6.0, 512), rng.uniform(-1.2, 1.2, 512),
                  rng.uniform(-1.0, 1.0, 512), np.zeros(512)], axis=1)
    for spec in (events.StopSpec(), events.StopSpec(lat_sign=-1.0,
                                                    lat_offset=np.pi / 2)):
        cfg = solve.SolverConfig(ds_local_knee=4.2, ds_local_frac=0.5,
                                 ds_local_shells=SIX_SHELLS)
        got = solve._local_arc_ceiling(torch.tensor(u), spec, cfg)
        want = jax.vmap(lambda uu: j_solve._local_arc_ceiling(
            uu, JStopSpec(*spec), JSolverConfig(*cfg)))(jnp.asarray(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15)
        four = solve._local_arc_ceiling(
            torch.tensor(u), spec,
            cfg._replace(ds_local_shells=SIX_SHELLS[:3]))
        assert int((four != got).sum()) > 10
        assert len(sc._shells(cfg)) == 6


# ---- the step chunk's plain version and small fans, end to end -----------

def test_step_chunk_over_six_shells_and_weights_matches_jax():
    """The step chunk (its plain version, the CPU's) with the local ceiling
    over six shells at ps_weight = de_weight = 0.5, against the JAX
    package's vmapped _step_one: 16 rays x 24 dopri5 steps, counters
    exactly, every float field within 1e-12; the wrapper passes the two
    shells past the kernel's parameters on (_overflow)."""
    je = j_medium.make_env_lat()._replace(ps_weight=0.5, de_weight=0.5)
    je = type(je)(*[v if isinstance(v, (str, tuple)) else float(v)
                    for v in je])
    rhs_fn = lambda u, ff: j_rhs.rhs_2d_lat(u, ff, je)  # noqa: E731
    cfg = JSolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4, ds_local_knee=4.2,
                        ds_local_frac=0.5, ds_local_shells=SIX_SHELLS)
    spec = JStopSpec(r_floor=1.0, t_max=5e8 / RE)
    n = 16
    u0 = jnp.stack([jnp.full((n,), (RE + 1e6) / RE),
                    jnp.linspace(0.5, 0.9, n), jnp.zeros((n,)),
                    jnp.zeros((n,))], axis=1)
    f = jnp.full((n,), 1000.0)
    carry0 = jax.vmap(lambda u, ff: j_solve.init_carry(rhs_fn, u, ff,
                                                       cfg))(u0, f)
    step = jax.jit(jax.vmap(lambda c, ff: j_solve._step_one(
        rhs_fn, c, ff, cfg=cfg, spec=spec, group_idx=3, adaptive=True,
        stepper="dopri5")))
    ref = carry0
    for _ in range(24):
        ref = step(ref, f)
    te, tcfg = env_from_numpy(je._asdict()), solver_config_from(cfg)
    assert sc.medium_code(te, tcfg) == sc.ANY
    ext = sc._overflow(te, tcfg, torch.float32, "cpu")
    assert ext[0] is None and ext[1].tolist() == [
        float(np.float32(x)) for x in (5.0, 0.2, 6.0, 0.3)]
    carry = carry_from_numpy({k: np.asarray(v) for k, v in
                              carry0._asdict().items()},
                             device="cpu", dtype=torch.float64)
    got = carry_to_numpy(sc.step_chunk(carry, torch.tensor(np.asarray(f)),
                                       te, tcfg, stop_spec_from(spec),
                                       stepper="dopri5", n_steps=24))
    for name in RayCarry._fields:
        want = np.asarray(getattr(ref, name))
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want, rtol=1e-12,
                                       atol=1e-12 if name == "u_lo" else 0,
                                       err_msg=name)


# small fans through both packages' rounds tracers on the CPU, float64:
# (preset, cut, medium fields, env fields, SolverConfig fields, grad_mode,
# base stepper, landing-L tolerance). The 2D fans run the dopri5 base: bs3's
# error estimate cancels to ~1e-9 of its terms and carries the two math
# libraries' last bits into the trajectory (measured here: 8.5e-10 and
# 1.0e-9 in landing L with bs3, 4e-14 with dopri5; tests/test_torch_
# slice3d.py). The 3D fans keep the preset's bs3: at the 3D launch's tiny
# first steps dopri5's estimate is the noisier one (5e-10 and 1.8e-9 with
# dopri5, 9e-11 and 3e-11 with bs3). The local ceiling carries those bits
# further, as its preset's float64 census shows (chip_smoke.py phase 15,
# held at 1e-8): its fan lands near the pole, where L = r / cos^2(lat)
# turns the packages' 2e-10 in latitude into 5.7e-9 in L (dopri5).
_CUT_2D = dict(lats=(0.8, 0.9, 1.0, 1.1), chis=(0.3, 0.5),
               freqs=(2000.0, 3000.0))
_CUT_3D = dict(lats=(0.8, 1.0), phis=(-2.0, 0.0, 2.0), chis=(-0.2, 0.2),
               freqs=(2000.0, 3000.0))
FANS = {
    "ps_half_lat": ("ensemble10k", _CUT_2D, {}, dict(ps_weight=0.5), {},
                    "fused", "dopri5", 1e-9),
    "de_half_lat": ("ensemble10k", _CUT_2D, dict(de_correction=True),
                    dict(de_weight=0.5), {}, "fused", "dopri5", 1e-9),
    "plume_12_harmonics": ("ensemble10k_plume", _CUT_3D,
                           dict(ps_mlt_harmonics=12), {}, {}, "fused", "bs3",
                           1e-9),
    "plume_24_harmonics_weights": ("ensemble10k_plume", _CUT_3D,
                                   dict(ps_mlt_harmonics=24,
                                        de_correction=True),
                                   dict(ps_weight=0.5, de_weight=0.5), {},
                                   "fused", "bs3", 1e-9),
    "plume_0_harmonics_autodiff": ("ensemble10k_plume", _CUT_3D,
                                   dict(ps_mlt_harmonics=0), {}, {},
                                   "autodiff", "bs3", 1e-9),
    "local_six_shells": ("ensemble10k_local", _CUT_2D, {}, {},
                         dict(ds_local_shells=SIX_SHELLS), "fused", "dopri5",
                         1e-8),
}


@pytest.mark.parametrize("case", sorted(FANS))
def test_fan_matches_jax(case):
    """Each case's cut fan (16-24 rays) through both packages' rounds
    tracers in one full-budget round (as run() traces a batch of at most
    64): statuses and step counters exactly, the landing L of the hits
    within the case's tolerance (FANS), every final state within 1e-7 of
    its component's scale (the wave-normal components carry the noise
    furthest: 2.4e-8 at most)."""
    name, cut, med, env_over, cfg_over, grad_mode, base, l_rtol = FANS[case]
    kw = dict(dtype="float64", grad_mode=grad_mode, base_stepper=base,
              **cut)
    jc, tc = j_config.preset(name, **kw), t_config.preset(name, **kw)
    jc = dataclasses.replace(jc, medium=dataclasses.replace(jc.medium,
                                                            **med))
    tc.medium = dataclasses.replace(tc.medium, **med)
    je = jc.medium.build()._replace(**env_over)
    te = tc.medium.build()._replace(**env_over)
    assert env_from_numpy(je._asdict()) == te
    tcfg = tc.solver()._replace(**cfg_over)
    jcfg = jc.solver()._replace(**cfg_over)
    u0, f = _build_u0(tc, te, np.float64, torch.device("cpu"))
    common = dict(frame=tc.frame, adaptive=tc.adaptive, stepper=tc.stepper,
                  max_steps=tc.max_steps, grad_mode=grad_mode, root=tc.root,
                  want_carry=False, base_stepper=tc.base_stepper,
                  round_steps=(tc.max_steps,))
    t_res = ensemble.make_rounds_tracer(
        te, device="cpu", dtype=torch.float64, cfg=tcfg, spec=tc.stop(),
        **common)(torch.tensor(u0), torch.tensor(f), np.ones(len(f), bool))
    j_res = j_ens.make_rounds_tracer(
        cast_env(je, np.float64), cfg=jcfg, spec=jc.stop(), **common)(
        u0, f, np.ones(len(f), bool))
    for field in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(np.asarray(getattr(t_res, field)),
                                      np.asarray(getattr(j_res, field)),
                                      err_msg=field)
    tu, ju = np.asarray(t_res.u), np.asarray(j_res.u)
    scale = np.abs(ju).max(axis=0)
    assert (np.abs(tu - ju) <= 1e-7 * scale).all()
    hit = np.asarray(j_res.status) == events.HIT_EARTH
    assert hit.sum() >= len(f) // 4
    trig = np.cos if tc.frame == "2d_lat" else np.sin
    land = [u[hit, 0] / trig(u[hit, 1]) ** 2 for u in (tu, ju)]
    np.testing.assert_allclose(land[0], land[1], rtol=l_rtol)


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if sys.argv[2:] == ["--nudge"]:
        from raytrace_tpu.integrate.events import STATUS_NAMES

        _, s64, _ = _jax_census(sys.argv[1], "float64")
        c_n, s_n, _ = _jax_census(sys.argv[1], "float64", nudge=True)
        moved = np.flatnonzero(s_n != s64)
        print(json.dumps({sys.argv[1]: dict(nudged=c_n, nudge_rays={
            int(i): STATUS_NAMES[int(s_n[i])] for i in moved},
            unnudged={int(i): STATUS_NAMES[int(s64[i])] for i in moved})}))
        raise SystemExit(0)
    c64, s64, l64 = _jax_census(sys.argv[1], "float64")
    c32, s32, l32 = _jax_census(sys.argv[1], "float32")
    hit = np.isfinite(l64) & np.isfinite(l32)
    print(json.dumps({sys.argv[1]: dict(
        float64=c64, float32=c32, status_match=float((s32 == s64).mean()),
        median_rel_dl=float(np.median(np.abs(l32[hit] - l64[hit])
                                      / l64[hit])))}))
