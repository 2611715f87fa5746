"""Port parity for the rounds tracer in the reference scripts' modes
(grad_mode="reference", and legacy_freq_state in the 2D frames), float64
on the CPU, against the JAX package: 8 rays x 512 attempts in each frame.
The modes' layers are held in tests/test_torch_reference_mode.py."""

import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.models import cast_env
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.parallel import ensemble as j_ensemble
from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig
from raytrace_tpu_torch.models import make_env
from raytrace_tpu_torch.parallel import ensemble
from raytrace_tpu_torch.run import _build_u0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# 8 rays of each frame (the 3D ones on the dispersion surface), 512
# attempts in rounds of 128 on the bs3 base
def _fan(frame):
    lats = tuple(np.linspace(0.75, 1.05, 4))
    if frame == "3d":
        conf = preset("ensemble10k_3d", dtype="float64", lats=lats,
                      chis=(-0.3, 0.3), freqs=(2000.0,))
        u0, f = _build_u0(conf, conf.medium.build(), np.float64,
                          torch.device("cpu"))
        return u0, f, conf.medium.b0
    u0, f = ensemble.build_launch(ensemble.LaunchSpec(
        lats=lats, chis=(0.3, 0.5), freqs=(2000.0,)), np.float64)
    if frame == "2d_colat":
        u0[:, 1] = np.pi / 2 - u0[:, 1]
    return u0, f, 3.0696381e-5


@pytest.mark.parametrize("frame", ["2d_lat", "2d_colat", "3d"])
def test_rounds_tracer_reference_mode_matches_jax(frame):
    """The rounds tracer on 8 rays x 512 bs3 attempts (rtol 1e-7) in
    reference mode (with legacy_freq_state in the 2D frames): statuses
    exactly; step counters equal and states within 2e-7 of each
    component's largest magnitude on at least 7 of the 8 rays. The
    reference set's wedges make single rays chaotic: bs3's error estimate
    turns the two math libraries' last-ulp differences into dt (ROADMAP
    C), and the JAX package moves one of its own 3D rays here onto
    another accept/reject path, 1.4e-3 away, when the launch latitudes
    move by one ulp."""
    u0, f, b0 = _fan(frame)
    valid = np.ones(u0.shape[0], bool)
    lat_sign, lat_offset = (1.0, 0.0) if frame == "2d_lat" else (
        -1.0, np.pi / 2)
    cfg = dict(rtol=1e-7, atol=1e-12, dt0=1e-4)
    spec = dict(r_floor=1.0, t_max=5e9 / RE, lat_sign=lat_sign,
                lat_offset=lat_offset)
    kw = dict(frame=frame, stepper="auto", base_stepper="bs3",
              max_steps=512, round_steps=128, bucket_floor=8,
              grad_mode="reference", legacy_freq_state=frame != "3d")
    j_out = j_ensemble.make_rounds_tracer(
        cast_env(j_make_env(b0=b0), np.float64), cfg=JSolverConfig(**cfg),
        spec=JStopSpec(**spec), **kw)(u0, f, valid)
    t_out = ensemble.make_rounds_tracer(
        make_env(b0=b0), device="cpu", dtype=torch.float64,
        cfg=SolverConfig(**cfg), spec=StopSpec(**spec), **kw)(u0, f, valid)
    np.testing.assert_array_equal(t_out.status, np.asarray(j_out.status))
    same = np.ones(u0.shape[0], bool)
    for name in ("n_accept", "n_reject"):
        same &= getattr(t_out, name) == np.asarray(getattr(j_out, name))
    ju = np.asarray(j_out.u)
    scale = np.maximum(np.abs(ju).max(axis=0), 1e-300)
    err = np.max(np.abs(t_out.u - ju) / scale, axis=1)
    agree = same & (err <= 2e-7)
    assert agree.sum() >= 7, (same, err)
