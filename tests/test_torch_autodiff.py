"""Port parity: the autodiff gradient set (grad_mode="autodiff").

The port computes it in forward mode: ops/dispersion.py's value chain once
on dual numbers (ops/dual.py), one tangent row per input, each op's
tangent by torch's forward-mode formula -- the arithmetic the step
kernel's AD instances (csrc/step_chunk.cu) perform. Held here on the CPU
in float64:
  - the gradient layer against the JAX package's jax.value_and_grad of the
    same mu at 1e-12, over the axisymmetric, full, multi-ion, MLT and
    non-axial media; against torch.func.jvp of the port's own chain bit
    for bit (the dual rules are torch's), and against the port's former
    reverse mode (torch.func.grad);
  - the step chunk's plain version against the JAX package's vmapped
    _step_one over its autodiff right-hand side (the setup of
    tests/test_pallas.py), and (slow) against the Pallas kernel in
    interpret mode;
  - cut fans through both packages' run() (2D lat, 3D, emic_heband):
    statuses exactly, final states within the JAX package's own one-ulp
    spread, landing statistics;
  - the kernel's medium code and what stays refused.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import config as j_config
from raytrace_tpu import run as j_run
from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate.solve import _step_one as j_step_one
from raytrace_tpu.integrate.solve import init_carry as j_init_carry
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import gradients as j_grad
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.constants import B0_2D, B0_3D
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig, init_carry
from raytrace_tpu_torch.interop import (
    carry_from_numpy, carry_to_numpy, env_from_numpy, solver_config_from,
    stop_spec_from,
)
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops import dispersion, gradients
from raytrace_tpu_torch.ops import rhs as t_rhs
from raytrace_tpu_torch.ops import step_chunk as sc
from raytrace_tpu_torch.parallel import ensemble
from raytrace_tpu_torch.run import run

_DUCT = dict(iono_mlt=True, duct_amp=0.5, duct_l0=3.0, duct_w=0.1)
# 2D media: (make_env keywords, root)
MEDIA_2D = {
    "axi": (dict(b0=B0_2D), 1.0),
    "de_iono_only": (dict(b0=B0_2D, plasmasphere_on=False,
                          de_correction=True), 1.0),
    "gcpm_duct_daynight": (dict(b0=B0_2D, ps_model="gcpm", **_DUCT), 1.0),
    "smooth_refill_q": (dict(b0=B0_2D, ps_smooth=0.05, ps_refill=0.5,
                             ps_refill_q=4.0, de_correction=True, **_DUCT),
                        1.0),
    "refill_const": (dict(b0=B0_2D, ps_refill=0.3), 1.0),
    "ions_emic": (dict(b0=B0_2D, eta_he=0.1, eta_o=0.05), -1.0),
}
# 3D media and fields
MEDIA_3D = {
    "dipole": dict(b0=B0_3D),
    "mlt": dict(b0=B0_3D, ps_mlt=True),
    "mlt_gcpm_duct": dict(b0=B0_3D, ps_mlt=True, ps_model="gcpm", **_DUCT),
    "mlt_smooth_refill": dict(b0=B0_3D, ps_mlt=True, ps_smooth=0.05,
                              ps_refill=0.5, ps_refill_q=4.0),
    "tilted_mlt": dict(b0=B0_3D, b_model="tilted", b_tilt=0.2,
                       b_tilt_phi=0.4, ps_mlt=True),
    "igrf_gcpm": dict(b_model="igrf", ps_model="gcpm", ps_mlt=True),
    "igrf_ions": dict(b_model="igrf", eta_he=0.1),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _points_2d(seed, n=24):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.05, 4.0, n), rng.uniform(-1.1, 1.1, n),
            rng.uniform(-1.2, 1.2, n), rng.uniform(300.0, 6000.0, n))


def _points_3d(seed, n=24):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.05, 4.0, n), rng.uniform(0.4, 2.7, n),
            rng.uniform(-3.0, 3.0, n), rng.uniform(-30.0, 30.0, n),
            rng.uniform(-30.0, 30.0, n), rng.uniform(-10.0, 10.0, n),
            rng.uniform(300.0, 6000.0, n))


def _assert_grads_close(got, want, rtol, what):
    """Each partial within rtol of its own largest magnitude over the
    points (a partial that crosses zero has no useful pointwise relative
    error)."""
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), (what, k)
        ok = np.isfinite(b)
        scale = max(float(np.abs(b[ok]).max(initial=0.0)), 1e-300)
        err = float(np.abs(a[ok] - b[ok]).max(initial=0.0)) / scale
        assert err <= rtol, (what, k, err)


def _jvp_rows(fn, args, env, root):
    """torch.func.jvp of the port's chain, one basis tangent at a time."""
    rows = []
    for k in range(len(args)):
        tang = tuple(torch.ones_like(a) if i == k else torch.zeros_like(a)
                     for i, a in enumerate(args))
        rows.append(torch.func.jvp(lambda *a: fn(*a, env, root), args,
                                   tang)[1])
    return rows


def _reverse(fn, args, env, root):
    def total(*a):
        mu = fn(*a, env, root)
        return mu.sum(), mu

    grads, mu = torch.func.grad(total, argnums=tuple(range(len(args))),
                                has_aux=True)(*args)
    return mu, grads


@pytest.mark.parametrize("name", sorted(MEDIA_2D))
@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
def test_gradients_2d_match_jax_and_torch(name, frame):
    kw, root = MEDIA_2D[name]
    je, te = j_medium.make_env(**kw), medium.make_env(**kw)
    pts = _points_2d(3)
    if frame == "2d_colat":
        pts = (pts[0], np.pi / 2.0 - pts[1], *pts[2:])
    args = tuple(torch.tensor(x) for x in pts)
    t_fn, j_fn, t_chain = {
        "2d_lat": (gradients.mu_grads_2d_lat, j_grad.mu_grads_2d_lat,
                   dispersion.mu_2d_lat),
        "2d_colat": (gradients.mu_grads_2d_colat, j_grad.mu_grads_2d_colat,
                     dispersion.mu_2d_colat),
    }[frame]
    mu, *grads = t_fn(*args, te, "autodiff", root)
    jmu, *jgrads = jax.vmap(lambda *a: j_fn(*a, je, "autodiff", root))(
        *map(jnp.asarray, pts))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-12)
    _assert_grads_close([g.numpy() for g in grads], jgrads, 1e-12,
                        f"{frame} {name} vs JAX")
    # the dual rules are torch's forward-mode formulas: equal bits
    for a, b in zip(grads, _jvp_rows(t_chain, args, te, root)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    rmu, rgrads = _reverse(t_chain, args, te, root)
    np.testing.assert_array_equal(mu.numpy(), rmu.numpy())
    _assert_grads_close([g.numpy() for g in grads],
                        [g.numpy() for g in rgrads], 1e-12,
                        f"{frame} {name} vs reverse mode")


@pytest.mark.parametrize("name", sorted(MEDIA_3D))
def test_gradients_3d_match_jax_and_torch(name):
    kw = MEDIA_3D[name]
    je, te = j_medium.make_env(**kw), medium.make_env(**kw)
    pts = _points_3d(5)
    args = tuple(torch.tensor(x) for x in pts)
    mu, grads = gradients.mu_grads_3d(*args, te, "autodiff")
    jmu, jgrads = jax.vmap(
        lambda *a: j_grad.mu_grads_3d(*a, je, "autodiff"))(
            *map(jnp.asarray, pts))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-12)
    # JAX's IGRF field is minus jax.grad of the potential, the port's the
    # closed form: equal values, other roundings, and the autodiff sets
    # over them still agree at 1e-12 of each partial's scale
    _assert_grads_close([g.numpy() for g in grads], jgrads, 1e-12,
                        f"3d {name} vs JAX")
    for a, b in zip(grads, _jvp_rows(dispersion.mu_3d, args, te, 1.0)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _, rgrads = _reverse(dispersion.mu_3d, args, te, 1.0)
    _assert_grads_close([g.numpy() for g in grads],
                        [g.numpy() for g in rgrads], 1e-12,
                        f"3d {name} vs reverse mode")


def test_field_aligned_3d_partials_nonfinite_in_both():
    """At a wave normal aligned with B to the last bit, sin psi =
    sqrt(|B x rho|^2) / ... is sqrt(0), whose tangent is 0/0: the r, theta
    and rho partials are NaN in both packages, so the right-hand side is
    not finite in either and the step rejects or retires the ray alike
    (integrate/solve.py's isfinite guard on the error). The packages part
    in the partials that reach sin psi through no non-zero path: forward
    mode carries the 0/0 into dmu/dphi and dmu/df as well, where JAX's
    reverse mode sends a zero cotangent and returns finite values (ROADMAP
    C). Off the field line every partial agrees."""
    kw = MEDIA_3D["dipole"]
    je, te = j_medium.make_env(**kw), medium.make_env(**kw)
    # at the equator B = (0, -b0 / r^3, 0) exactly: rho = (0, -20, 0) is
    # aligned to the last bit
    r, theta = np.array([2.0, 2.0]), np.full(2, np.pi / 2.0)
    pts = (r, theta, np.zeros(2), np.array([0.0, 20.0]),
           np.array([-20.0, 5.0]), np.zeros(2), np.full(2, 2000.0))
    _, grads = gradients.mu_grads_3d(*map(torch.tensor, pts), te,
                                     "autodiff")
    _, jgrads = jax.vmap(lambda *a: j_grad.mu_grads_3d(*a, je, "autodiff"))(
        *map(jnp.asarray, pts))
    got = np.stack([g.numpy() for g in grads])
    want = np.stack([np.asarray(g) for g in jgrads])
    assert np.isnan(got[:, 0]).all()
    assert np.isnan(want[[0, 1, 3, 4, 5], 0]).all()
    assert np.isfinite(want[[2, 6], 0]).all()
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-12, atol=1e-300)
    u = torch.tensor([[p[k] for p in pts[:6]] + [0.0] for k in range(2)])
    out = t_rhs.rhs_3d(u, torch.tensor(pts[6]), te, grad_mode="autodiff")
    ref = jax.vmap(lambda uu, ff: j_rhs.rhs_3d(uu, ff, je,
                                               grad_mode="autodiff"))(
        jnp.asarray(u.numpy()), jnp.asarray(pts[6]))
    assert not np.isfinite(out.numpy()[0]).all()
    assert not np.isfinite(np.asarray(ref)[0]).all()
    np.testing.assert_allclose(out.numpy()[1], np.asarray(ref)[1],
                               rtol=1e-12)


# ---- the step chunk's plain version ---------------------------------------

N_RAYS, N_STEPS = 16, 24


def _jax_setup(frame="2d_lat"):
    env = j_medium.make_env_lat()
    env = type(env)(*[v if isinstance(v, (str, tuple)) else float(v)
                      for v in env])
    rhs_fn = lambda u, ff: j_rhs.rhs_2d_lat(  # noqa: E731
        u, ff, env, grad_mode="autodiff")
    cfg = JSolverConfig(rtol=1e-6, atol=1e-10, dt0=1e-4)
    spec = JStopSpec(r_floor=1.0, t_max=5e8 / RE)
    n = N_RAYS
    u0 = jnp.stack([jnp.full((n,), (RE + 1e6) / RE),
                    jnp.linspace(0.5, 0.9, n), jnp.zeros((n,)),
                    jnp.zeros((n,))], axis=1)
    f = jnp.full((n,), 1000.0)
    carry0 = jax.vmap(lambda u, ff: j_init_carry(rhs_fn, u, ff, cfg))(u0, f)
    return env, rhs_fn, cfg, spec, carry0, f


def _port_args(env, cfg, spec, carry0, f):
    return (carry_from_numpy({k: np.asarray(v) for k, v in
                              carry0._asdict().items()},
                             device="cpu", dtype=torch.float64),
            torch.tensor(np.asarray(f)), env_from_numpy(env._asdict()),
            solver_config_from(cfg), stop_spec_from(spec))


# as tests/test_torch_step_chunk.py holds the fused set: dopri5 to 1e-12,
# bs3 (whose error estimate amplifies the two math libraries' last bits)
# to 1e-6; the integer fields exactly
@pytest.mark.parametrize("stepper,rtol", [("dopri5", 1e-12), ("bs3", 1e-6)])
def test_step_chunk_autodiff_matches_jax_steps(stepper, rtol):
    env, rhs_fn, cfg, spec, carry0, f = _jax_setup()
    step = jax.jit(jax.vmap(partial(j_step_one, rhs_fn, cfg=cfg, spec=spec,
                                    group_idx=3, adaptive=True,
                                    stepper=stepper)))
    ref = carry0
    for _ in range(N_STEPS):
        ref = step(ref, f)
    carry, ft, te, tcfg, tspec = _port_args(env, cfg, spec, carry0, f)
    assert sc.medium_code(te, tcfg, "autodiff") == sc.AD
    calls = sc.step_chunk_reference.calls
    got = carry_to_numpy(sc.step_chunk(carry, ft, te, tcfg, tspec,
                                       stepper=stepper, n_steps=N_STEPS,
                                       grad_mode="autodiff"))
    assert sc.step_chunk_reference.calls == calls + 1
    for name in got:
        want = np.asarray(getattr(ref, name))
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got[name], want, err_msg=name)
            continue
        np.testing.assert_allclose(got[name], want, rtol=rtol,
                                   atol=1e-12 if name == "u_lo" else 0.0,
                                   err_msg=name)


@pytest.mark.slow  # the JAX Pallas kernel in interpret mode, as test_pallas
def test_step_chunk_autodiff_matches_pallas_interpret():
    from raytrace_tpu.ops import pallas_stepper

    env, rhs_fn, cfg, spec, carry0, f = _jax_setup()
    chunk = pallas_stepper.make_pallas_chunk(rhs_fn, cfg, spec, 3, True,
                                             N_STEPS, interpret=True)
    ref = chunk(carry0, f)
    carry, ft, te, tcfg, tspec = _port_args(env, cfg, spec, carry0, f)
    got = carry_to_numpy(sc.step_chunk(carry, ft, te, tcfg, tspec,
                                       stepper="dopri5", n_steps=N_STEPS,
                                       grad_mode="autodiff"))
    for name in got:
        np.testing.assert_allclose(
            got[name], np.asarray(getattr(ref, name)), rtol=1e-12,
            atol=1e-12 if name == "u_lo" else 0.0, err_msg=name)


# ---- whole slices through both packages' run() ---------------------------

# preset -> the cut: a few launch values and a phase-path budget (RE)
SLICES = {
    "ensemble10k": dict(lats=(0.5, 0.8), chis=(-0.3, 0.2),
                        freqs=(1000.0, 4000.0), t_max=20.0, max_steps=512),
    # low launches: every ray lands within ~500 attempts
    "ensemble10k_3d": dict(lats=(0.3, 0.4), phis=(0.0,), chis=(-0.2, 0.2),
                           freqs=(2000.0,), max_steps=1024),
    "emic_heband": dict(lats=(0.0, 0.3), freqs=(1.0,), t_max=0.5,
                        max_steps=256),
}


def _fields(out):
    valid = np.asarray(out["valid"])
    res = out["result"]
    return tuple(np.asarray(getattr(res, k))[valid]
                 for k in ("status", "n_accept", "n_reject", "u"))


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_autodiff_matches_jax_run(name):
    """The cut preset with grad_mode="autodiff" through both packages'
    run() in float64 on the CPU: the port's census equals the JAX
    package's, each ray's status too (a chaotic ray, one the JAX package's
    own one-ulp nudge moves, may end in either JAX run's status), final
    states within ten times the nudge's spread or 1e-8, and the landing
    statistics of the census equal."""
    cut = dict(SLICES[name], dtype="float64", grad_mode="autodiff")
    base = j_config.preset(name, **cut)
    nudged = dict(cut, lats=tuple(np.nextafter(np.asarray(base.lats,
                                                          np.float64),
                                               np.inf)))
    j_out = j_run.run(base)
    want = _fields(j_out)
    spread = _fields(j_run.run(j_config.preset(name, **nudged)))
    calls = sc.step_chunk_reference.calls
    out = run(preset(name, **cut), device="cpu")
    assert sc.step_chunk_reference.calls > calls
    got = _fields(out)
    st = want[0]
    regular = st == spread[0]
    np.testing.assert_array_equal(got[0][regular], st[regular])
    assert np.all((got[0] == st) | (got[0] == spread[0]))
    if regular.all():
        for k in ("n_hit_earth", "n_max_phase_time", "n_dt_underflow",
                  "n_max_steps"):
            assert int(out["stats"][k]) == int(j_out["stats"][k]), k
    held = regular & np.isin(st, (events.MAX_PHASE_TIME, events.HIT_EARTH))
    assert held.any(), st
    scale = np.maximum(np.abs(want[3][held]).max(axis=0), 1e-300)
    err = float(np.max(np.abs(got[3][held] - want[3][held]) / scale))
    own = float(np.max(np.abs(spread[3][held] - want[3][held]) / scale))
    assert err <= max(10.0 * own, 1e-8), (err, own)
    if name == "ensemble10k_3d":
        assert int(out["stats"]["n_hit_earth"]) == st.size
    if int(out["stats"]["n_hit_earth"]) and regular.all():
        np.testing.assert_allclose(float(out["stats"]["median_landing_l"]),
                                   float(j_out["stats"]["median_landing_l"]),
                                   rtol=1e-8)


def test_sensitivity_nests_over_the_forward_mode_rhs():
    """run(sensitivity_rays=N) with the autodiff set: the variational
    system's jvp nests over the forward-mode right-hand side."""
    conf = preset("ensemble10k", lats=(0.8,), chis=(0.3,), freqs=(2000.0,),
                  max_steps=8, t_max=0.5, sensitivity_rays=1,
                  grad_mode="autodiff")
    out = run(conf, device="cpu")
    amp = out["stats"]["sensitivity_amplification"]
    assert amp.size == 1 and np.isfinite(amp).all()


def test_cli_runs_the_autodiff_set_on_the_cpu(tmp_path, capsys):
    """python -m raytrace_tpu_torch <config.json> --device cpu with
    grad_mode="autodiff" in the config: the run and its record."""
    from raytrace_tpu_torch.__main__ import main

    path = tmp_path / "cut.json"
    path.write_text(preset("ensemble10k", lats=(0.8,), chis=(0.3,),
                           freqs=(2000.0,), max_steps=8, t_max=0.5,
                           grad_mode="autodiff").to_json())
    assert main([str(path), "--device", "cpu", "--float64", "--out",
                 str(tmp_path / "out")]) == 0
    assert "1 rays" in capsys.readouterr().out
    rec = (tmp_path / "out" / "ensemble10k_record.json").read_text()
    assert '\\"grad_mode\\": \\"autodiff\\"' in rec


# ---- medium codes and refusals --------------------------------------------


def test_medium_code_and_refusals():
    """Every medium and field under the autodiff set takes the AD
    instances, with legacy_freq_state in 2D; the kernel's parameters carry
    no reference-set flag for them. What stays refused: legacy_freq_state
    in 3D, the 2D frames over a non-axial field, an unknown mode."""
    cfg, local = SolverConfig(), preset("ensemble10k_local").solver()
    for kw, _ in MEDIA_2D.values():
        env = medium.make_env(**kw)
        for c in (cfg, local):
            assert sc.medium_code(env, c, "autodiff") == sc.AD
            assert sc.medium_code(env, c, "autodiff", True) == sc.AD
    for kw in MEDIA_3D.values():
        assert sc.medium_code(medium.make_env(**kw), cfg, "autodiff") == sc.AD
    env = medium.make_env(b0=B0_2D)
    params = sc._params(env, cfg, StopSpec(), 1.0, "autodiff", True)
    assert params.ref_grads == 0.0 and params.legacy_freq == 1.0
    with pytest.raises(ValueError, match="unknown grad_mode"):
        sc.medium_code(env, cfg, "finite_difference")
    u0 = torch.tensor([[2.0, 0.8, 0.3, 30.0, 30.0, 0.0, 0.0]] * 2,
                      dtype=torch.float64)
    f = torch.full((2,), 2000.0, dtype=torch.float64)
    plume = medium.make_env(b0=B0_3D, ps_mlt=True)
    carry = init_carry(t_rhs.frame_rhs("3d", plume, grad_mode="autodiff")[0],
                       u0, f, cfg)
    with pytest.raises(ValueError, match="legacy_freq_state"):
        sc.step_chunk(carry, f, plume, cfg, StopSpec(), stepper="bs3",
                      n_steps=2, frame="3d", grad_mode="autodiff",
                      legacy_freq_state=True)
    tilted = medium.make_env(b0=B0_3D, b_model="tilted", b_tilt=0.2)
    u2 = torch.tensor([[2.0, 0.8, 0.3, 0.0]] * 2, dtype=torch.float64)
    carry2 = init_carry(t_rhs.frame_rhs("2d_lat", medium.make_env(b0=B0_2D),
                                        grad_mode="autodiff")[0], u2, f, cfg)
    with pytest.raises(ValueError, match="3D-only"):
        sc.step_chunk(carry2, f, tilted, cfg, StopSpec(), stepper="bs3",
                      n_steps=2, grad_mode="autodiff")
    with pytest.raises(ValueError, match="3D-only"):
        gradients.mu_grads_2d_lat(u2[:, 0], u2[:, 1], u2[:, 2], f, tilted,
                                  "autodiff")
    # the MLT plasmapause needs a harmonic in the AD instances' chain (the
    # value chain's mlt_ps_params takes a tensor shape)
    flat = medium.make_env(b0=B0_3D, ps_mlt=True, ps_mlt_harmonics=0)
    with pytest.raises(ValueError, match="harmonic"):
        sc.step_chunk(carry, f, flat, cfg, StopSpec(), stepper="bs3",
                      n_steps=2, frame="3d", grad_mode="autodiff")
    # the rounds tracer takes the set in every frame
    ensemble.make_rounds_tracer(plume, device="cpu", dtype=torch.float64,
                                frame="3d", grad_mode="autodiff")
    # a field over the 3D frame runs
    out = sc.step_chunk(
        init_carry(t_rhs.frame_rhs("3d", tilted, grad_mode="autodiff")[0],
                   u0, f, cfg), f, tilted, cfg, StopSpec(), stepper="bs3",
        n_steps=2, frame="3d", grad_mode="autodiff")
    assert (out.n_accept + out.n_reject == 2).all()
