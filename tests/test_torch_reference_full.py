"""Port parity for the reference scripts' modes over the full and extended
media (the step kernel's ALTX instances), float64 on the CPU, against
the JAX package: grad_mode="reference" over the MLT-resolved
plasmasphere, GCPM with the duct and the day/night ionosphere, the
smoothed and refilled plasmapause and the local arc ceiling, and
legacy_freq_state over He+ and O+; per point, through trace (the
kernel's plain version) and through the rounds tracer; and the medium
codes and refusals. Inputs come from numpy seeds; each comparison states
its tolerance.

The trap the 3D reference set holds: the JAX package's closed form reads
the density without longitude (ops/gradients.py:161-169 calls
medium.ne_total_m3 without phi), while mu and dmu/dphi carry the
MLT-resolved density at phi."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import trace as j_trace
from raytrace_tpu.models import cast_env
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.ops import gradients as j_gradients
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu.parallel import ensemble as j_ensemble
from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig, init_carry, trace
from raytrace_tpu_torch.models import make_env
from raytrace_tpu_torch.ops import analytic, fused, gradients, rhs
from raytrace_tpu_torch.ops import step_chunk as sc
from raytrace_tpu_torch.parallel import ensemble
from raytrace_tpu_torch.run import _build_u0

jax.config.update("jax_enable_x64", True)

B0_2D = 3.0696381e-5
B0_3D = 3.12e-5
R0 = (RE + 1.0e6) / RE
# the media (make_env keywords of both packages)
_DUCT = dict(iono_mlt=True, duct_amp=0.5, duct_l0=3.0, duct_w=0.1)
MEDIA_2D = {
    "gcpm+duct+daynight": dict(ps_model="gcpm", **_DUCT),
    "smooth+refill_q+daynight": dict(ps_smooth=0.05, ps_refill=0.5,
                                     ps_refill_q=4.0, iono_mlt=True),
}
MEDIA_3D = {
    "plume": dict(ps_mlt=True),
    "gcpm_mlt+duct": dict(ps_model="gcpm", ps_mlt=True, **_DUCT),
    "smooth_mlt": dict(ps_smooth=0.05, ps_refill=0.5, ps_mlt=True),
}
IONS = dict(eta_he=0.1, eta_o=0.02)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(*xs):
    return tuple(torch.tensor(x) for x in xs)


def _scaled(got, want):
    """Worst difference against each component's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _states_3d(seed, n=128):
    """Points with phi off the anchor meridian (|phi| >= 0.3)."""
    rng = np.random.default_rng(seed)
    rho = rng.normal(size=(3, n))
    rho[2, ::4] = 0.0
    phi = rng.uniform(0.3, 3.0, n) * rng.choice([-1.0, 1.0], n)
    return (rng.uniform(1.05, 4.0, n), rng.uniform(0.3, 2.8, n), phi, *rho,
            rng.uniform(500.0, 8000.0, n))


@pytest.mark.parametrize("medium", sorted(MEDIA_3D))
def test_reference_3d_mlt_off_meridian_matches_jax(medium):
    """mu_grads_3d in reference mode at points with phi != 0: mu and all
    seven partials within 1e-12 of each partial's largest magnitude (dmu/dr
    exactly 0). Negative control: the closed form over the chain's
    MLT-resolved density (what the axisymmetric instance's closed form
    would take if lifted onto this medium as it stands) misses the rho
    partials by far more."""
    je = j_make_env(b0=B0_3D, **MEDIA_3D[medium])
    te = make_env(b0=B0_3D, **MEDIA_3D[medium])
    pts = _states_3d(80)
    mu_j, g_j = jax.vmap(lambda *a: j_gradients.mu_grads_3d(
        *a, je, "reference"))(*map(jnp.asarray, pts))
    mu_t, g_t = gradients.mu_grads_3d(*_t(*pts), te, grad_mode="reference")
    assert _scaled(mu_t.numpy(), mu_j) <= 1e-12
    assert bool((g_t[0] == 0).all())
    for k in range(1, 7):
        assert _scaled(g_t[k].numpy(), g_j[k]) <= 1e-12, k
    # the density the closed form takes is the chain's at the base
    # parameters, not its MLT-resolved one at phi
    r, theta, phi, rr, rt, rp, f = _t(*pts)
    (mu, _), (ne_mlt, bm, cospsi, br, bt) = fused.mu_and_grads_3d_medium(
        r, theta, phi, rr, rt, rp, f, te)
    psi = torch.arccos(cospsi)
    _, d_wrong = analytic.mu_and_dmudpsi(ne_mlt, bm, f, psi)
    wrong = analytic.kimura_dmudrho(mu, d_wrong, psi,
                                    (br, bt, torch.zeros_like(br)),
                                    (rr, rt, rp))
    miss = max(_scaled(w.numpy(), g_j[3 + k]) for k, w in enumerate(wrong))
    assert miss > 1e-4, miss


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
@pytest.mark.parametrize("medium", sorted(MEDIA_2D))
def test_reference_2d_full_media_match_jax(frame, medium):
    """The 2D reference set over GCPM with the duct and the day/night
    ionosphere and over the smoothed, refilled plasmapause: dmu/dr exactly
    0, mu and the other partials within 1e-12 of each one's largest
    magnitude (the 2D frames trace the phi = 0 meridian, where the chain's
    density is the one the closed form reads)."""
    je = j_make_env(b0=B0_2D, **MEDIA_2D[medium])
    te = make_env(b0=B0_2D, **MEDIA_2D[medium])
    rng = np.random.default_rng(81)
    n = 128
    r, lat = rng.uniform(1.05, 4.0, n), rng.uniform(-1.0, 1.0, n)
    chi, f = rng.uniform(-1.0, 1.0, n), rng.uniform(500.0, 8000.0, n)
    ang = lat if frame == "2d_lat" else np.pi / 2 - lat
    jfn = (j_gradients.mu_grads_2d_lat if frame == "2d_lat"
           else j_gradients.mu_grads_2d_colat)
    tfn = (gradients.mu_grads_2d_lat if frame == "2d_lat"
           else gradients.mu_grads_2d_colat)
    want = jax.vmap(lambda *a: jfn(*a, je, "reference"))(
        *map(jnp.asarray, (r, ang, chi, f)))
    got = tfn(*_t(r, ang, chi, f), te, grad_mode="reference")
    assert bool((got[1] == 0).all())
    for k in (0, 2, 3, 4):
        assert _scaled(got[k].numpy(), want[k]) <= 1e-12, k


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
@pytest.mark.parametrize("root", [1.0, -1.0])
def test_legacy_rhs_over_ions_matches_jax(frame, root):
    """The legacy right-hand sides (frequency f + T) over He+ and O+, the
    whistler and the EMIC root: within 1e-10 of each component's largest
    magnitude (the tolerance of the protons-only legacy test), and legacy
    is live."""
    je, te = (j_make_env(b0=B0_2D, **IONS), make_env(b0=B0_2D, **IONS))
    rng = np.random.default_rng(82)
    n = 128
    r, lat = rng.uniform(1.5, 3.0, n), rng.uniform(-0.4, 0.4, n)
    chi = rng.uniform(-0.5, 0.5, n)
    f = (rng.uniform(500.0, 8000.0, n) if root > 0
         else rng.uniform(0.5, 2.0, n))
    T = rng.uniform(0.0, 0.5, n)
    ang = lat if frame == "2d_lat" else np.pi / 2 - lat
    u = np.stack([r, ang, chi, T], 1)
    jfn = j_rhs.rhs_2d_lat if frame == "2d_lat" else j_rhs.rhs_2d_colat
    want = np.asarray(jax.vmap(lambda uu, ff: jfn(
        uu, ff, je, legacy_freq_state=True, root=root))(
        jnp.asarray(u), jnp.asarray(f)))
    fn, _ = rhs.frame_rhs(frame, te, root=root, legacy_freq_state=True)
    got = fn(*_t(u, f)).numpy()
    ok = np.isfinite(want).all(axis=1)
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), ok)
    scale = np.abs(want[ok]).max(axis=0)
    assert float(np.max(np.abs(got[ok] - want[ok]) / scale)) <= 1e-10
    clean = rhs.frame_rhs(frame, te, root=root)[0](*_t(u, f)).numpy()
    assert not np.allclose(clean[ok], got[ok], rtol=1e-6)


# ---- trace legs and the rounds tracer ------------------------------------

# (preset, overrides, mode keywords, every): a few rays of each path of the
# ALTX instances, traced to 2 RE of phase path; the modes' keywords as
# trace takes them
CASES = {
    "plume_ref": ("ensemble10k_plume", {}, dict(grad_mode="reference"),
                  1700),
    "gcpm_2d_ref_legacy": (
        "ensemble10k", dict(medium_kw=MEDIA_2D["gcpm+duct+daynight"]),
        dict(grad_mode="reference", legacy_freq_state=True), 1700),
    "local_ref": ("ensemble10k_local", {}, dict(grad_mode="reference"),
                  1700),
    "emic_legacy": ("emic_heband", {}, dict(legacy_freq_state=True), 8),
}
T_MAX = 2.0


def _case(name):
    """(JAX config, port config, u0, f, (JAX env, port env), mode
    keywords) of a case, float64; u0 is the JAX package's launch (the
    port's on-shell rho agrees to 1e-14)."""
    from raytrace_tpu import config as j_config
    from raytrace_tpu import run as j_run

    pname, over, modes, every = CASES[name]
    over = dict(over, t_max=T_MAX)
    med = over.pop("medium_kw", None)
    jconf = j_config.preset(pname, dtype="float64", **over)
    tconf = preset(pname, dtype="float64", **over)
    if med is not None:
        for conf in (jconf, tconf):
            for k, v in med.items():
                setattr(conf.medium, k, v)
    u0, f = j_run._build_u0(jconf, np.float64)
    tu0, _ = _build_u0(tconf, tconf.medium.build(), np.float64,
                       torch.device("cpu"))
    np.testing.assert_allclose(tu0, u0, rtol=1e-14)
    je = cast_env(jconf.medium.build(), np.float64)
    return (jconf, tconf, u0[::every], f[::every],
            (je, tconf.medium.build()), modes)


def _nudge(u0):
    u = u0.copy()
    u[:, 1] = np.nextafter(u[:, 1], np.inf)
    return u


def _hold(got, want, nudged):
    """The port's final (status, n_accept, n_reject, u) against the JAX
    package's, in the band of the JAX package's own one-ulp spread (its
    run with every launch latitude one ulp up). A regular ray (the nudge
    keeps its status and counters) must keep the JAX package's status; if
    it ran out its phase budget or landed (a state at the same t or r in
    both packages), its state within 1e-12 of each component's largest
    magnitude; its counters may differ by a borderline accept/reject, as
    the two packages' mu differ in the last ulps (autodiff there, the
    fused chain here). A chaotic ray (the modes' wedges: the nudge moves
    its status or counters) must end in the status of either JAX run. At
    most two rays of a case are chaotic, and one ray at least is held to
    its state."""
    st, ju = np.asarray(want[0]), np.asarray(want[3])
    regular = np.ones(st.shape[0], bool)
    for k in range(3):
        regular &= np.asarray(want[k]) == np.asarray(nudged[k])
    assert (~regular).sum() <= 2, regular
    gs = np.asarray(got[0])
    np.testing.assert_array_equal(gs[regular], st[regular])
    assert np.all((gs == st) | (gs == np.asarray(nudged[0])))
    held = regular & np.isin(st, (events.MAX_PHASE_TIME, events.HIT_EARTH))
    assert held.any()
    scale = np.maximum(np.abs(ju[held]).max(axis=0), 1e-300)
    err = np.abs(np.asarray(got[3])[held] - ju[held]) / scale
    assert float(err.max()) <= 1e-12, err.max(axis=1)


def _fields(res):
    return tuple(np.asarray(getattr(res, k))
                 for k in ("status", "n_accept", "n_reject", "u"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_full_media_matches_jax(name):
    """A few rays of each ALTX path through trace() (the kernel's plain
    version), dopri5 at rtol 1e-9 (the presets' other settings, the local
    arc ceiling included) to 2 RE of phase path, held by _hold; the
    launch's medium code is ALTX. (States are compared at the phase
    budget: after a fixed count of attempts the modes' steps, which the
    error estimate turns last ulps into, put rays elsewhere on their
    paths.)"""
    jconf, tconf, u0, f, (je, te), modes = _case(name)
    cfg = tconf.solver()._replace(rtol=1e-9, atol=1e-14)
    spec = tconf.stop()
    assert sc.medium_code(te, cfg, modes.get("grad_mode", "fused"),
                          modes.get("legacy_freq_state", False)) == sc.ALTX
    jfn, gidx = j_ensemble._frame_rhs(
        jconf.frame, je, modes.get("grad_mode", "fused"), jconf.root,
        modes.get("legacy_freq_state", False))

    def j_run(u):
        return _fields(j_trace(jfn, jnp.asarray(u), jnp.asarray(f),
                               cfg=JSolverConfig(**cfg._asdict()),
                               spec=JStopSpec(**spec._asdict()),
                               group_idx=gidx, max_steps=128, chunk=32))

    got = trace(te, *_t(u0, f), frame=tconf.frame, cfg=cfg, spec=spec,
                stepper="dopri5", max_steps=128, chunk=32, root=tconf.root,
                **modes)
    _hold(_fields(got), j_run(u0), j_run(_nudge(u0)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rounds_tracer_full_media_matches_jax(name):
    """The same rays through both packages' rounds tracers (the bs3 base,
    the stiff pool on, rounds of 64, rtol 1e-9) to 2 RE of phase path,
    held by _hold."""
    jconf, tconf, u0, f, (je, te), modes = _case(name)
    cfg = tconf.solver()._replace(rtol=1e-9, atol=1e-14)
    spec = tconf.stop()
    valid = np.ones(u0.shape[0], bool)
    kw = dict(frame=tconf.frame, stepper="auto", base_stepper="bs3",
              max_steps=128, round_steps=64, bucket_floor=8,
              root=tconf.root, **modes)
    j_tracer = j_ensemble.make_rounds_tracer(
        je, cfg=JSolverConfig(**cfg._asdict()),
        spec=JStopSpec(**spec._asdict()), **kw)
    t_out = ensemble.make_rounds_tracer(
        te, device="cpu", dtype=torch.float64, cfg=cfg, spec=spec,
        **kw)(u0, f, valid)
    _hold(_fields(t_out), _fields(j_tracer(u0, f, valid)),
          _fields(j_tracer(_nudge(u0), f, valid)))


def test_medium_codes_and_refusals():
    """Every protons-only centred-dipole medium takes ALTX under the
    reference set (ALT the axisymmetric one), every 2D medium under
    legacy_freq_state, multi-ion included; the JAX package's ValueErrors
    stay: the reference set over He+/O+ or a non-axial field, legacy in
    3D (in the kernel's checks too, on the CPU, where the plain version
    would otherwise run)."""
    cfg = SolverConfig()
    local = preset("ensemble10k_local").solver()
    for kw in list(MEDIA_2D.values()) + list(MEDIA_3D.values()):
        env = make_env(b0=B0_3D, **kw)
        assert sc.medium_code(env, cfg, "reference") == sc.ALTX
        assert sc.medium_code(env, cfg, "fused", True) == sc.ALTX
        assert sc.medium_code(env, cfg) in (sc.FULL, sc.EXT)
    axi = make_env(b0=B0_2D)
    assert sc.medium_code(axi, cfg, "reference") == sc.ALT
    assert sc.medium_code(axi, local, "reference") == sc.ALTX
    ions = make_env(b0=B0_2D, **IONS)
    assert sc.medium_code(ions, cfg, "fused", True) == sc.ALTX
    with pytest.raises(ValueError, match="protons-only"):
        sc.medium_code(ions, cfg, "reference")
    tilted = make_env(b0=B0_3D, b_model="tilted", b_tilt=0.2, ps_mlt=True)
    with pytest.raises(ValueError, match="centered-dipole"):
        sc.medium_code(tilted, cfg, "reference")
    with pytest.raises(NotImplementedError, match="B7"):
        sc.medium_code(axi, cfg, "autodiff")
    plume = make_env(b0=B0_3D, ps_mlt=True)
    u0 = torch.tensor([[R0, 0.8, 0.3, 30.0, 30.0, 0.0, 0.0]] * 2,
                      dtype=torch.float64)
    f = torch.full((2,), 2000.0, dtype=torch.float64)
    carry = init_carry(rhs.frame_rhs("3d", plume)[0], u0, f, cfg)
    with pytest.raises(ValueError, match="legacy_freq_state"):
        sc.step_chunk(carry, f, plume, cfg, StopSpec(), stepper="bs3",
                      n_steps=2, frame="3d", legacy_freq_state=True)
