"""Port parity for integrate/saving.py: the diagnostics save_fns of every
frame and field, trajectory_xy, stream_trajectory and
resample_trajectory, against the JAX package (float64 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import saving as j_saving
from raytrace_tpu.models import medium as j_medium
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu_torch.integrate import saving
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig, trace
from raytrace_tpu_torch.models import medium
from raytrace_tpu_torch.ops.rhs import frame_rhs

R0 = (RE + 1.0e6) / RE


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _states(frame, n=64, seed=50):
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.02, 3.5, n)
    f = rng.uniform(500.0, 8000.0, n)
    if frame == "3d":
        u = np.stack([r, rng.uniform(0.3, 2.8, n), rng.uniform(-3, 3, n),
                      *rng.normal(size=(3, n)), np.zeros(n)], 1)
    else:
        ang = (rng.uniform(-1.2, 1.2, n) if frame == "2d_lat"
               else rng.uniform(0.4, 2.7, n))
        u = np.stack([r, ang, rng.uniform(-0.5, 0.5, n), np.zeros(n)], 1)
    return u, f


# the closed form and the vector geometry in both packages' op orders:
# the (B, 4) extras agree to 1e-10 (the trajectory channel's band)
@pytest.mark.parametrize("frame,kw", [
    ("2d_lat", dict(b0=3.0696381e-5)),
    ("2d_colat", dict(b0=3.0696381e-5, plasmasphere_on=False)),
    ("3d", {}),
    ("3d", dict(b_model="tilted", b_tilt=0.2007, b_tilt_phi=1.0)),
    ("3d", dict(b_model="igrf")),
    ("3d", dict(ps_mlt=True, duct_amp=0.5)),
])
def test_save_fn_matches_jax(frame, kw):
    u, f = _states(frame)
    j_env = j_medium.make_env(**kw)
    env = medium.make_env(**kw)
    ref = np.asarray(jax.vmap(j_saving.save_fn_for(frame, j_env))(
        jnp.asarray(u), jnp.asarray(f)))
    got = saving.save_fn_for(frame, env)(torch.from_numpy(u),
                                         torch.from_numpy(f))
    assert tuple(got.shape) == ref.shape == (u.shape[0], 4)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-300)
    # batched over any leading shape: (S, B, n) snapshots at once
    got3 = saving.save_fn_for(frame, env)(
        torch.from_numpy(u).reshape(4, -1, u.shape[1]),
        torch.from_numpy(f).reshape(4, -1))
    np.testing.assert_array_equal(got3.reshape(-1, 4).numpy(), got.numpy())


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat"])
def test_trajectory_xy_matches_jax(frame):
    u, _ = _states(frame, n=12)
    traj = u.reshape(3, 4, 4)
    jx, jy = j_saving.trajectory_xy(jnp.asarray(traj), frame)
    for arg in (traj, torch.from_numpy(traj)):
        x, y = saving.trajectory_xy(arg, frame)
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-15)
        np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-15)


# one ray of the rounds tests' fan (test_torch_rounds.py::_fan)
U0 = np.array([[R0, 1.0, 0.5, 0.0]])
F = np.array([3000.0])
CFG = dict(rtol=1e-5, atol=1e-8, dt0=1e-4)
SPEC = dict(r_floor=1.0, t_max=5e9 / RE)


def test_stream_trajectory_matches_single_shot_and_jax():
    """Chunked host-offloaded capture: bit for bit the single-shot
    trajectory (exact resume from each chunk's carry), and the JAX
    package's stream_trajectory at dopri5's band."""
    env = medium.make_env_lat()
    kw = dict(cfg=SolverConfig(**CFG), spec=StopSpec(**SPEC),
              stepper="dopri5", save_fn=saving.save_fn_for("2d_lat", env))
    res, traj = saving.stream_trajectory(
        env, torch.from_numpy(U0), torch.from_numpy(F), chunk_steps=64,
        n_chunks=2, save_every=16, **kw)
    one = trace(env, torch.from_numpy(U0), torch.from_numpy(F),
                max_steps=128, save_every=16, **kw)
    assert traj["u"].shape == (128 // 16, 1, 4)
    for k, v in one.traj.items():
        np.testing.assert_array_equal(traj[k], v.numpy(), err_msg=k)
    np.testing.assert_array_equal(res.u.numpy(), one.u.numpy())

    j_env = j_medium.make_env_lat()
    j_res, j_traj = j_saving.stream_trajectory(
        lambda u, ff: j_rhs.rhs_2d_lat(u, ff, j_env), jnp.asarray(U0),
        jnp.asarray(F), cfg=JSolverConfig(**CFG), spec=JStopSpec(**SPEC),
        chunk_steps=64, n_chunks=2, save_every=16,
        save_fn=j_saving.save_fn_for("2d_lat", j_env))
    assert set(traj) == set(j_traj)
    np.testing.assert_array_equal(traj["status"], j_traj["status"])
    for k in ("u", "t"):
        np.testing.assert_allclose(traj[k], j_traj[k], rtol=1e-12)
    np.testing.assert_allclose(traj["extras"], j_traj["extras"], rtol=1e-10)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(j_res.u),
                               rtol=1e-12)


def test_resample_trajectory_matches_jax():
    """The Hermite resampling of one recorded trajectory through both
    packages (the port's right-hand side in one batched call): equal to
    1e-12, exact at the snapshots, clamped past the span."""
    rng = np.random.default_rng(51)
    u_s = np.cumsum(rng.normal(scale=1e-3, size=(12, 3, 4)), 0) + np.array(
        [1.5, 0.7, 0.1, 0.0])
    t_s = np.cumsum(rng.uniform(0.01, 0.02, size=(12, 3)), 0)
    t_s[8:, 2] = t_s[7, 2]      # ray 2 stopped: a frozen-t tail
    traj = {"u": u_s, "t": t_s}
    f = np.array([1000.0, 2000.0, 3000.0])
    u0 = np.array([[1.5, 0.7, 0.1, 0.0]] * 3)
    tq = np.concatenate([np.linspace(0.0, 0.3, 40), [1e9]])
    j_env = j_medium.make_env_lat()
    rhs_fn, _ = frame_rhs("2d_lat", medium.make_env_lat())
    for start in (None, u0):
        got = saving.resample_trajectory(rhs_fn, traj, f, tq, u0=start)
        ref = j_saving.resample_trajectory(
            lambda u, ff: j_rhs.rhs_2d_lat(u, ff, j_env), traj, f, tq,
            u0=start)
        assert got.shape == ref.shape == (3, tq.size, 4)
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    got = saving.resample_trajectory(rhs_fn, traj, f, t_s[3:6, 0])
    np.testing.assert_allclose(got[0], u_s[3:6, 0], rtol=1e-14)
    # past ray 2's span: its last snapshot before the frozen tail
    far = saving.resample_trajectory(rhs_fn, traj, f, [1e9])
    np.testing.assert_array_equal(far[2, 0], u_s[7, 2])
