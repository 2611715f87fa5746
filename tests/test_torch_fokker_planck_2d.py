"""Port parity for raytrace_tpu_torch.fokker_planck_2d, float64 on the CPU.

The port writes A f out as the adjoint stencil D^T W D of the JAX
module's energy; here it is held to autograd of a torch copy of that
energy and to the JAX module's apply_operator_2d (jax.grad) at 1e-12 of
the largest value, and the operator's fields to the JAX module's at
1e-12. The eleven cases of tests/test_fokker_planck_2d.py run against
the port at their own tolerances. Then a small evolution on a cut of
examples/chorus_acceleration.py's tensor (12 x 14 cells, 40 CN steps,
save_every with a remainder) against the JAX module: the field within
1e-10 of its largest value and each step's CG iteration count equal to
that of the JAX module's _pcg called step by step; float32 against the
JAX module's float32 on the same (float32) operator. The plain version
on the CPU is what these run; the kernel of csrc/cn_pcg_2d.cu is held to
it on the card (tests/test_torch_cuda.py, chip_smoke.py phase 30).

Run as a script, this file prints the JAX package's numbers of the
examples' whole chains (chip_smoke.py's FP2D_PINS): `PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_fokker_planck_2d.py [--out
x.npz]` (~45 s; --out also saves the tensors and every snapshot)."""

import dataclasses
import functools
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import diffusion as j_diff
from raytrace_tpu import fokker_planck_2d as J
from raytrace_tpu.constants import FCE_E
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu_torch import fokker_planck as t_fp1
from raytrace_tpu_torch import fokker_planck_2d as T
from raytrace_tpu_torch import fp2d_examples as fx
from raytrace_tpu_torch import interop

jax.config.update("jax_enable_x64", True)

FIELDS = ("k_a", "k_lc", "k_p", "r_a", "r_x", "r_p", "mass", "diag", "dpc")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err / scale)


def _random_psd(na, npp, seed, marginal=False):
    rng = np.random.default_rng(seed)
    a11 = rng.uniform(0.3, 3.0, (na, npp))
    a22 = rng.uniform(0.3, 3.0, (na, npp))
    if marginal:
        sgn = np.where(rng.uniform(size=(na, npp)) < 0.5, -1.0, 1.0)
        return a11, sgn * np.sqrt(a11 * a22), a22
    a12 = rng.uniform(-0.95, 0.95, (na, npp)) * np.sqrt(a11 * a22)
    return a11, a12, a22


def _both_ops(tensor3, na, npp, **kw):
    g = J.make_grid_2d(np.radians(8.0), na, 0.5, 4.0, npp)
    gt = T.make_grid_2d(np.radians(8.0), na, 0.5, 4.0, npp)
    gc = kw.pop("g_centers", None)
    oj = J.make_operator_2d(g, *tensor3, g_centers=(
        None if gc is None else jnp.asarray(gc)), **kw)
    ot = T.make_operator_2d(gt, *tensor3, g_centers=gc, device="cpu", **kw)
    return oj, ot


def _dense(op, na, npp):
    n = na * npp
    eye = torch.eye(n, dtype=torch.float64).reshape(n, na, npp)
    return T.apply_operator_2d(op, eye).reshape(n, n).T.numpy()


# ---- the grid and the operator against the JAX module --------------------

def test_grid_and_unit_helpers_match_jax():
    g = J.make_grid_2d(np.radians(9.0), 11, 0.3, 5.0, 7)
    gt = T.make_grid_2d(np.radians(9.0), 11, 0.3, 5.0, 7)
    gl = T.make_grid_2d(np.radians(9.0), 11, 0.3, 5.0, 7, log_p=False)
    gjl = J.make_grid_2d(np.radians(9.0), 11, 0.3, 5.0, 7, log_p=False)
    for f in dataclasses.fields(J.Grid2D):
        np.testing.assert_array_equal(getattr(gt, f.name),
                                      getattr(g, f.name))
        np.testing.assert_array_equal(getattr(gl, f.name),
                                      getattr(gjl, f.name))
    e = np.array([30.0, 300.0, 3000.0])
    np.testing.assert_allclose(T.p_from_energy(e), J.p_from_energy(e),
                               rtol=1e-15)
    np.testing.assert_allclose(T.energy_from_p(g.p_c), J.energy_from_p(g.p_c),
                               rtol=1e-15)
    ba = {"daa": np.array([1.0, 2.0]), "dap": np.array([3e-22, -1e-22]),
          "dpp": np.array([4e-44, 5e-44])}
    for got, want in zip(T.tensor_from_bounce(
            {k: torch.as_tensor(v) for k, v in ba.items()}),
            J.tensor_from_bounce(ba)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


@pytest.mark.parametrize("loss_cone", ["absorbing", "reflecting"])
@pytest.mark.parametrize("g_override", [False, True], ids=["G", "G=override"])
def test_operator_fields_and_apply_match_jax(loss_cone, g_override):
    na, npp = 10, 9
    ten = _random_psd(na, npp, 1)
    gc = (np.random.default_rng(4).uniform(0.5, 2.0, (na, npp))
          if g_override else None)
    oj, ot = _both_ops(ten, na, npp, loss_cone=loss_cone, g_centers=gc)
    for k in FIELDS:
        _close(getattr(ot, k).numpy(), np.asarray(getattr(oj, k)), 1e-12, k)
    assert (ot.da, ot.n_a, ot.n_p) == (oj.da, oj.n_a, oj.n_p)
    f = np.random.default_rng(5).standard_normal((na, npp))
    _close(T.apply_operator_2d(ot, f).numpy(),
           np.asarray(J.apply_operator_2d(oj, jnp.asarray(f))), 1e-12,
           "A f")
    _close(float(T.content_2d(ot, f)), float(J.content_2d(oj, f)), 1e-12)


@pytest.mark.parametrize("case", ["random", "marginal", "reflecting",
                                  "diagonal"])
def test_stencil_is_the_energy_gradient(case):
    """A f written out by hand against autograd of the energy (the JAX
    module's definition of A), on several operators and fields."""
    na, npp = 9, 11
    ten = _random_psd(na, npp, 2, marginal=case == "marginal")
    if case == "diagonal":
        ten = (ten[0], np.zeros_like(ten[0]), ten[2])
    kw = {"loss_cone": "reflecting"} if case == "reflecting" else {}
    _, ot = _both_ops(ten, na, npp, **kw)
    for seed in range(3):
        f = torch.tensor(np.random.default_rng(seed).standard_normal(
            (na, npp)), requires_grad=True)
        grad = torch.autograd.grad(T._energy(f, ot), f)[0]
        _close(T.apply_operator_2d(ot, f.detach()).numpy(), grad.numpy(),
               1e-12, case)


def test_interop_carries_the_jax_operator():
    ten = _random_psd(6, 5, 3)
    oj, ot = _both_ops(ten, 6, 5)
    op = interop.op2d_from_numpy(oj, device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(op, k).numpy(),
                                      np.asarray(getattr(oj, k)))
    assert (op.da, op.n_a, op.n_p) == (oj.da, oj.n_a, oj.n_p)
    op32 = interop.op2d_from_numpy(dataclasses.asdict(oj), device="cpu",
                                   dtype=torch.float32)
    assert op32.mass.dtype == torch.float32 and op32.da == oj.da


def test_refusals_and_the_device_convention():
    g = T.make_grid_2d(np.radians(8.0), 4, 0.5, 2.0, 3)
    ones = np.ones((4, 3))
    with pytest.raises(ValueError, match="loss_cone"):
        T.make_operator_2d(g, ones, 0 * ones, ones, loss_cone="open",
                           device="cpu")
    if not torch.cuda.is_available():
        # numpy goes to the card by default; nothing falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_operator_2d(g, ones, 0 * ones, ones)
    op = T.make_operator_2d(g, torch.ones(4, 3), torch.zeros(4, 3),
                            torch.ones(4, 3))
    assert op.mass.device.type == "cpu" and op.mass.dtype == torch.float32
    # the kernel's wrapper takes the card's tensors only, and names its
    # grid limit
    from raytrace_tpu_torch.ops import cn_pcg_2d

    with pytest.raises(ValueError, match="CUDA"):
        cn_pcg_2d.cn_pcg_2d(torch.ones(4, 3), op, 1.0, 2, 0, 1e-6, 10)
    big = dataclasses.replace(op, n_a=600, n_p=600)
    with pytest.raises(ValueError, match="300368 cells"):
        cn_pcg_2d.cn_pcg_2d(torch.ones(600, 600), big, 1.0, 2, 0, 1e-6, 10)
    assert cn_pcg_2d.max_cells(torch.float64) == 150176


# ---- the eleven cases of tests/test_fokker_planck_2d.py ------------------

def test_operator_symmetric_and_psd():
    na, npp = 10, 9
    g = T.make_grid_2d(np.radians(8.0), na, 0.5, 4.0, npp)
    ten = _random_psd(na, npp, 1)
    op = T.make_operator_2d(g, *ten, device="cpu")
    a = _dense(op, na, npp)
    assert np.abs(a - a.T).max() <= 1e-13 * np.abs(a).max()
    ev = np.linalg.eigvalsh(0.5 * (a + a.T))
    assert ev.min() > 0.0
    op_r = T.make_operator_2d(g, *ten, loss_cone="reflecting", device="cpu")
    a_r = _dense(op_r, na, npp)
    ev_r = np.linalg.eigvalsh(0.5 * (a_r + a_r.T))
    assert ev_r.min() > -1e-12 * ev_r.max()
    assert np.abs(a_r.sum(axis=0)).max() < 1e-12 * np.abs(a_r).max()
    # the dense matrix is the JAX module's
    oj, _ = _both_ops(ten, na, npp)
    dense_j = np.stack([np.asarray(J.apply_operator_2d(
        oj, jnp.asarray(np.eye(na * npp)[k].reshape(na, npp)))).ravel()
        for k in range(na * npp)], axis=1)
    _close(a, dense_j, 1e-13)


def test_conservation_reflecting():
    g = T.make_grid_2d(np.radians(10.0), 16, 0.3, 3.0, 12)
    rng = np.random.default_rng(2)
    a11 = rng.uniform(0.5, 2.0, (16, 12))
    a22 = rng.uniform(0.5, 2.0, (16, 12))
    a12 = rng.uniform(-0.8, 0.8, (16, 12)) * np.sqrt(a11 * a22)
    op = T.make_operator_2d(g, a11, a12, a22, loss_cone="reflecting",
                            device="cpu")
    f0 = rng.uniform(0.5, 1.5, (16, 12))
    f1 = T.evolve_cn_2d(f0, op, 0.02, 40, cg_tol=1e-13)
    n0 = float(T.content_2d(op, f0))
    n1 = float(T.content_2d(op, f1))
    assert abs(n1 - n0) < 1e-11 * n0


def test_absorbing_wall_loses_particles():
    g = T.make_grid_2d(np.radians(10.0), 16, 0.3, 3.0, 12)
    a11 = np.full((16, 12), 1.0)
    zero = np.zeros((16, 12))
    op = T.make_operator_2d(g, a11, zero, zero, device="cpu")
    f0 = np.ones((16, 12))
    f1 = T.evolve_cn_2d(f0, op, 0.005, 60)
    assert float(T.content_2d(op, f1)) < 0.9 * float(T.content_2d(op, f0))
    assert float(f1.min()) > -1e-9


def test_reduces_to_1d_solver():
    """D_ap = D_pp = 0 and p-independent D_aa: every p row evolves as the
    port's 1D solver (same G, same walls)."""
    a_lc = np.radians(12.0)
    n_a, n_p = 48, 6
    g2 = T.make_grid_2d(a_lc, n_a, 0.5, 2.0, n_p)
    centers, faces, da = t_fp1.make_grid(a_lc, n_a, device="cpu")
    centers, faces = centers.numpy(), faces.numpy()
    daa_a = 0.02 + 0.01 * np.sin(3.0 * centers) ** 2
    op = T.make_operator_2d(
        g2, np.broadcast_to(daa_a[:, None], (n_a, n_p)),
        np.zeros((n_a, n_p)), np.zeros((n_a, n_p)), device="cpu")
    f0_a = np.sin(centers - a_lc) + 0.2
    f0 = np.broadcast_to(f0_a[:, None], (n_a, n_p))
    dt, n_steps = 0.4, 25
    f2d = T.evolve_cn_2d(f0, op, dt, n_steps, cg_tol=1e-13).numpy()

    def g_of(a):
        return t_fp1.bounce_time_factor(a, device="cpu").numpy() \
            * np.sin(a) * np.cos(a)

    g_c = g_of(centers)
    g_f = np.maximum(g_of(faces), 1e-12)
    d_faces = np.concatenate([daa_a[:1], 0.5 * (daa_a[1:] + daa_a[:-1]),
                              daa_a[-1:]])
    tri = t_fp1.build_operator(d_faces, g_c, g_f, da, device="cpu")
    f1d = t_fp1.evolve_cn(f0_a, tri, dt, n_steps, device="cpu").numpy()
    for j in range(n_p):
        np.testing.assert_allclose(f2d[:, j], f1d, rtol=1e-12, atol=1e-14)


def test_gaussian_covariance_growth():
    n_a, n_p = 96, 96
    g = T.make_grid_2d(0.2, n_a, 0.0, 1.0, n_p, log_p=False)
    d = np.array([[1.0, 0.45], [0.45, 0.5]]) * 1e-4
    ones = np.ones((n_a, n_p))
    op = T.make_operator_2d(g, d[0, 0] * ones, d[0, 1] * ones,
                            d[1, 1] * ones, loss_cone="reflecting",
                            g_centers=ones, device="cpu")
    x0, y0 = g.alpha_c[n_a // 2], g.p_c[n_p // 2]
    sig = 0.06
    xx, yy = np.meshgrid(g.alpha_c - x0, g.p_c - y0, indexing="ij")
    f0 = np.exp(-(xx**2 + yy**2) / (2 * sig**2))
    t_end = 20.0
    f1 = T.evolve_cn_2d(f0, op, 0.5, int(t_end / 0.5),
                        cg_tol=1e-12).numpy()

    def cov(f):
        w = f / f.sum()
        mx, my = (w * xx).sum(), (w * yy).sum()
        c = (w * (xx - mx) * (yy - my)).sum()
        return np.array([[(w * (xx - mx) ** 2).sum(), c],
                         [c, (w * (yy - my) ** 2).sum()]])

    np.testing.assert_allclose(cov(f1) - cov(f0), 2.0 * d * t_end,
                               rtol=0.02)


def test_momentum_diffusion_accelerates():
    g = T.make_grid_2d(np.radians(15.0), 24, 0.3, 5.0, 48)
    n_a, n_p = 24, 48
    zero = np.zeros((n_a, n_p))
    op = T.make_operator_2d(g, zero, zero, np.full((n_a, n_p), 3e-3),
                            loss_cone="reflecting", device="cpu")
    f0 = np.exp(-((g.p_c[None, :] - 0.5) / 0.15) ** 2) * np.ones((n_a, 1))
    f1 = T.evolve_cn_2d(f0, op, 5.0, 40, cg_tol=1e-12).numpy()
    mass = op.mass.numpy()
    w0, w1 = f0 * mass, f1 * mass
    p_mean0 = (w0 * g.p_c[None, :]).sum() / w0.sum()
    p_mean1 = (w1 * g.p_c[None, :]).sum() / w1.sum()
    assert p_mean1 > p_mean0 + 0.05
    np.testing.assert_allclose(w1.sum(axis=1) / w1.sum(),
                               w0.sum(axis=1) / w0.sum(), rtol=1e-6)


def test_unit_helpers_roundtrip():
    e = np.array([30.0, 300.0, 3000.0])
    np.testing.assert_allclose(T.energy_from_p(T.p_from_energy(e)), e,
                               rtol=1e-12)


def test_psd_at_exactly_marginal_tensor():
    na, npp = 12, 11
    g = T.make_grid_2d(np.radians(8.0), na, 0.4, 3.0, npp)
    ten = _random_psd(na, npp, 7, marginal=True)
    op = T.make_operator_2d(g, *ten, device="cpu")
    a = _dense(op, na, npp)
    ev = np.linalg.eigvalsh(0.5 * (a + a.T))
    assert ev.min() > -1e-13 * ev.max()
    f0 = np.random.default_rng(8).uniform(0.0, 1.0, (na, npp))
    f1 = T.evolve_cn_2d(f0, op, 0.5, 200, cg_tol=1e-12)
    assert torch.isfinite(f1).all()
    assert float(f1.abs().max()) < 2.0


def test_checkerboard_mode_is_damped():
    na, npp = 20, 18
    g = T.make_grid_2d(np.radians(8.0), na, 0.4, 3.0, npp)
    daa = np.full((na, npp), 1.0)
    dpp = np.full((na, npp), 1e-5)
    op = T.make_operator_2d(g, daa, np.sqrt(daa * dpp), dpp,
                            loss_cone="reflecting", device="cpu")
    ii, jj = np.meshgrid(np.arange(na), np.arange(npp), indexing="ij")
    checker = (-1.0) ** (ii + jj)
    f0 = 1.0 + 0.2 * checker
    f1 = T.evolve_cn_2d(f0, op, 0.05, 80, cg_tol=1e-12).numpy()
    amp0 = np.abs((f0 * checker).mean())
    amp1 = np.abs((f1 * checker).mean())
    assert amp1 < 0.02 * amp0
    assert np.abs(f1 - 1.0).max() < 0.05


def test_preconditioner_diag_matches_hessian():
    na, npp = 7, 6
    g = T.make_grid_2d(np.radians(8.0), na, 0.5, 4.0, npp)
    daa = np.full((na, npp), 1.0)
    dpp = np.full((na, npp), 1e-5)
    op = T.make_operator_2d(g, daa, np.sqrt(daa * dpp), dpp, device="cpu")
    true_diag = np.diag(_dense(op, na, npp)).reshape(na, npp)
    np.testing.assert_allclose(op.diag.numpy(), true_diag, rtol=5e-3)
    rng = np.random.default_rng(3)
    daa = rng.uniform(0.5, 2.0, (na, npp))
    dpp = rng.uniform(0.5, 2.0, (na, npp))
    dap = rng.uniform(-0.95, 0.95, (na, npp)) * np.sqrt(daa * dpp)
    op = T.make_operator_2d(g, daa, dap, dpp, device="cpu")
    true_diag = np.diag(_dense(op, na, npp)).reshape(na, npp)
    rel = np.abs(op.diag.numpy() - true_diag) / np.abs(true_diag)
    assert rel.max() < 0.15
    assert rel[1:-1, 1:-1].max() < 1e-6


def test_save_every_remainder_still_evolved():
    g = T.make_grid_2d(np.radians(8.0), 6, 0.5, 3.0, 5)
    rng = np.random.default_rng(5)
    daa = rng.uniform(0.5, 2.0, (6, 5))
    op = T.make_operator_2d(g, daa, np.zeros((6, 5)), np.zeros((6, 5)),
                            device="cpu")
    f0 = rng.uniform(0.5, 1.5, (6, 5))
    f_plain = T.evolve_cn_2d(f0, op, 0.05, 7, cg_tol=1e-12)
    f_chunk, snaps = T.evolve_cn_2d(f0, op, 0.05, 7, save_every=3,
                                    cg_tol=1e-12)
    assert snaps.shape[0] == 2
    np.testing.assert_allclose(f_chunk.numpy(), f_plain.numpy(), rtol=1e-9)
    assert T.evolve_cn_2d.cg_iterations.shape == (7,)


# ---- evolutions against the JAX module -----------------------------------

# the cut of examples/chorus_acceleration.py: its L, spectra and seed on a
# 12 x 14 grid, the bounce average at n_lat 12 / n_grid 96, 40 CN steps of
# 120 s with 3 snapshots (every 13 steps: a remainder of 1)
CUT = dict(fx.CHORUS, n_a=12, n_p=14, n_steps=40, n_snaps=3,
           ba=dict(n_lat=12, n_grid=96, n_bisect=26, momentum_units="mc"))


def _jax_ns():
    """The JAX package's side of the examples' 2D chain (fp2d_examples):
    jitted bounce_averaged_jax, numpy in and out."""
    def bounce_averaged(e, a, l_shell, env, spec, **kw):
        fn = jax.jit(functools.partial(j_diff.bounce_averaged_jax,
                                       l_shell=l_shell, env=env, spec=spec,
                                       **kw))
        return {k: np.asarray(v) for k, v in
                fn(jnp.asarray(e), jnp.asarray(a)).items()}

    def evolve(f0, op, dt, n, every):
        f_end, snaps = J.evolve_cn_2d(jnp.asarray(f0), op, dt, n,
                                      save_every=every)
        return np.asarray(f_end), np.asarray(snaps)

    env = j_medium.make_env_lat()
    return SimpleNamespace(
        env=env,
        fce=FCE_E * float(j_medium.b_mag(CUT["l_shell"], 0.0, env)),
        WaveSpectrum=j_diff.WaveSpectrum, bounce_averaged=bounce_averaged,
        make_grid_2d=J.make_grid_2d, p_from_energy=J.p_from_energy,
        energy_from_p=J.energy_from_p, make_operator_2d=J.make_operator_2d,
        evolve_cn_2d=evolve, content_2d=lambda op, f: float(J.content_2d(
            op, jnp.asarray(f))), mass=lambda op: np.asarray(op.mass))


def _port_ns():
    """The port's side on the CPU (fx.fp2d_for's recipe)."""
    return fx.fp2d_for(torch.device("cpu"), torch.float64)


@functools.lru_cache(maxsize=None)
def _cut_setup():
    k = _jax_ns()
    grid, e_c, f0, chorus, emic = fx.fp2d_grid(k, CUT)
    t_ch, t_em = fx.fp2d_tensors(k, grid, e_c, chorus, emic, CUT)
    return grid, e_c, f0, t_ch, t_em


def test_cut_tensors_match_jax():
    """The port's bounce_averaged (momentum_units='mc') on the cut grid
    against the JAX module's bounce_averaged_jax: 1e-9 of each
    component's largest value (the bisected resonances, PR 10's band)."""
    grid, e_c, _, t_ch, t_em = _cut_setup()
    k = _port_ns()
    g, e, _, chorus, emic = fx.fp2d_grid(k, CUT)
    np.testing.assert_array_equal(e, e_c)
    assert abs(k.fce / _jax_ns().fce - 1.0) < 1e-14
    g_ch, g_em = fx.fp2d_tensors(k, g, e, chorus, emic, CUT)
    for got, want in zip(g_ch + g_em, t_ch + t_em):
        assert np.abs(want).max() > 0.0
        _close(got, want, 1e-9)


def _jax_counts(oj, f0, dt, n_steps, tol, dtype):
    """Each step's iteration count from the JAX module's _pcg called step
    by step (evolve_cn_2d's step), and the residual norm it stopped at
    beside its eps."""
    half = 0.5 * dt
    m_inv = 1.0 / (oj.mass + half * oj.diag)

    def apply_h(x):
        return oj.mass * x + half * J._apply_a(x, oj)

    @jax.jit
    def step(f):
        b = oj.mass * f - half * J._apply_a(f, oj)
        x, k = J._pcg(apply_h, b, f, m_inv, tol, 500)
        r = b - apply_h(x)
        return x, k, jnp.sqrt((r * r).sum()), tol * jnp.maximum(
            jnp.sqrt((b * b).sum()), 1e-300)

    f, out = jnp.asarray(f0, dtype), []
    for _ in range(n_steps):
        f, k, rn, eps = step(f)
        out.append((int(k), float(rn), float(eps)))
    return np.asarray(f), out


@pytest.mark.parametrize("which", ["chorus", "sum"])
def test_cut_evolution_matches_jax(which):
    """The cut's evolution from the same (JAX) tensor through both
    packages: snapshots and end state within 1e-10 of the largest value,
    content_2d to 1e-12, and every step's CG count equal to JAX's _pcg
    count."""
    grid, e_c, f0, t_ch, t_em = _cut_setup()
    ten = t_ch if which == "chorus" else tuple(
        a + b for a, b in zip(t_ch, t_em))
    oj = J.make_operator_2d(grid, *ten)
    op = interop.op2d_from_numpy(oj, device="cpu")
    every = CUT["n_steps"] // CUT["n_snaps"]
    fe_j, sn_j = J.evolve_cn_2d(jnp.asarray(f0), oj, CUT["dt"],
                                CUT["n_steps"], save_every=every)
    fe_t, sn_t = T.evolve_cn_2d(f0, op, CUT["dt"], CUT["n_steps"],
                                save_every=every)
    assert sn_t.shape == (3, 12, 14)
    _close(fe_t.numpy(), np.asarray(fe_j), 1e-10, "f_end")
    _close(sn_t.numpy(), np.asarray(sn_j), 1e-10, "snaps")
    _close(float(T.content_2d(op, fe_t)), float(J.content_2d(oj, fe_j)),
           1e-12)
    counts = T.evolve_cn_2d.cg_iterations.tolist()
    f_j, ref = _jax_counts(oj, f0, CUT["dt"], CUT["n_steps"], 1e-10,
                           jnp.float64)
    _close(f_j, np.asarray(fe_j), 1e-14, "the step loop is evolve_cn_2d")
    for step, (got, (k, rn, eps)) in enumerate(zip(counts, ref)):
        # where the counts part, JAX's residual stopped within rounding of
        # eps: the stop test sat on the line
        assert got == k or abs(rn - eps) <= 1e-6 * eps, (step, got, k, rn,
                                                         eps)
    assert counts == [k for k, _, _ in ref]
    assert min(counts) > 20


def test_cut_evolution_float32_matches_jax_float32():
    """Float32 through both packages on one float32 operator (the JAX
    operator's fields cast): the two float32 runs part by rounding in the
    reductions, 1.1e-6 of the largest value measured, held at 1e-5; each
    is ~1e-4 from float64 (measured 6e-5), held at 1e-3."""
    grid, e_c, f0, t_ch, _ = _cut_setup()
    oj = J.make_operator_2d(grid, *t_ch)
    oj32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), oj)
    op32 = interop.op2d_from_numpy(oj, device="cpu", dtype=torch.float32)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(op32, k).numpy(),
                                      np.asarray(getattr(oj32, k)))
    f32 = f0.astype(np.float32)
    fj = np.asarray(J.evolve_cn_2d(jnp.asarray(f32), oj32, CUT["dt"],
                                   CUT["n_steps"]))
    ft = T.evolve_cn_2d(torch.as_tensor(f32), op32, CUT["dt"],
                        CUT["n_steps"])
    assert ft.dtype == torch.float32 and fj.dtype == np.float32
    _close(ft.numpy(), fj, 1e-5, "float32")
    f64 = np.asarray(J.evolve_cn_2d(jnp.asarray(f0), oj, CUT["dt"],
                                    CUT["n_steps"]))
    _close(ft.numpy(), f64, 1e-3, "float32 against float64")
    _, ref = _jax_counts(oj32, f32, CUT["dt"], CUT["n_steps"], 3e-6,
                         jnp.float32)
    got = T.evolve_cn_2d.cg_iterations.numpy()
    assert np.abs(got - np.array([k for k, _, _ in ref])).max() <= 2


@pytest.mark.parametrize("unroll", [1, 3, 8])
def test_masked_unrolled_iterations_change_nothing(unroll):
    """The plain version's masked CG: any number of iterations a pass
    (the CUDA graph's unroll) and graph=True off the card give the same
    values bit for bit."""
    grid, _, f0, t_ch, _ = _cut_setup()
    op = interop.op2d_from_numpy(J.make_operator_2d(grid, *t_ch),
                                 device="cpu")
    want = T.evolve_cn_2d_reference(f0, op, CUT["dt"], 12, save_every=5,
                                    graph=False, unroll=1)
    counts = T.evolve_cn_2d.cg_iterations.clone()
    got = T.evolve_cn_2d_reference(f0, op, CUT["dt"], 12, save_every=5,
                                   graph=True, unroll=unroll)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(T.evolve_cn_2d.cg_iterations, counts)


def test_chain_recipe_runs_on_the_port():
    """fx.fp2d_chain over the port on the CPU (the recipe phase
    30 runs on the card) against the JAX module's on the cut: every
    number within 1e-10 of its largest value."""
    grid, e_c, f0, t_ch, t_em = _cut_setup()
    got = fx.fp2d_chain(_port_ns(), grid, e_c, f0, t_ch, t_em, CUT)
    want = fx.fp2d_chain(_jax_ns(), grid, e_c, f0, t_ch, t_em,
                                 CUT)
    for name in ("chorus", "sum"):
        for key in ("rows80", "snaps", "f_end", "gain", "content", "prof3",
                    "trapped"):
            _close(got[name][key], want[name][key], 1e-10, (name, key))


def main():
    """Print the JAX package's float64 numbers of the examples' 2D chain
    at their sizes (chip_smoke.py's FP2D_PINS)."""
    def fmt(a):
        return "[" + ", ".join(f"{float(x):.12e}" for x in np.ravel(a)) + "]"

    import time

    k = _jax_ns()
    conf = fx.CHORUS
    grid, e_c, f0, chorus, emic = fx.fp2d_grid(k, conf)
    t0 = time.perf_counter()
    t_ch, t_em = fx.fp2d_tensors(k, grid, e_c, chorus, emic, conf)
    t1 = time.perf_counter()
    out = fx.fp2d_chain(k, grid, e_c, f0, t_ch, t_em, conf)
    print(f"# tensors {t1 - t0:.1f} s, evolutions "
          f"{out['walls']['chorus']:.1f} / {out['walls']['sum']:.1f} s")
    if len(sys.argv) > 2 and sys.argv[1] == "--out":
        np.savez(sys.argv[2], t_ch=np.stack(t_ch), t_em=np.stack(t_em),
                 snaps_ch=out["chorus"]["snaps"],
                 snaps_sum=out["sum"]["snaps"])
    print("FP2D_PINS = dict(")
    for name in ("chorus", "sum"):
        o = out[name]
        # every snapshot's 80 deg row of chorus_acceleration's run, the
        # last one of belt_competition's combined run
        rows = o["rows80"] if name == "chorus" else o["rows80"][-1:]
        print(f"    {name}=dict(")
        print(f"        gain={fmt(o['gain'])},")
        print(f"        content={o['content']:.12e},")
        print(f"        trapped={fmt(o['trapped'])},")
        print(f"        prof3={fmt(o['prof3'])},")
        print("        rows80=[" + ",\n                ".join(
            fmt(r) for r in rows) + "]),")
    print(")")


if __name__ == "__main__":
    sys.exit(main())
