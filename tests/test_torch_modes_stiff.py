"""Port parity for the remaining run modes of the ray path, float64 on
the CPU, against the JAX package: the rounds tracer's stiff pool on ros2x
(this file) and continue_until_done through run() (tests/test_torch_modes_continue.py)."""

import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.models import cast_env
from raytrace_tpu.models import make_env as j_make_env
from raytrace_tpu.parallel import ensemble as j_ensemble
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig
from raytrace_tpu_torch.models import make_env
from raytrace_tpu_torch.parallel import ensemble

B0_2D = 3.0696381e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_stiff_pool_handoff_ros2x():
    """Mirror of test_rounds.py::test_auto_stepper_pool_handoff at a small
    size (a 3e8 m phase budget, rounds of 128): the switch threshold forced low so rays move to the ros2x pool;
    pool membership, statuses and counters equal the JAX run's, states to
    1e-12, and the physics equals the pure-dopri5 run within the
    cross-method tolerance."""
    u0, f = ensemble.build_launch(
        ensemble.LaunchSpec(lats=tuple(np.linspace(0.6, 0.9, 4))),
        np.float64)
    u0, f, valid = ensemble.pad_batch(u0, f)
    cfg = dict(rtol=1e-6, atol=1e-10, dt0=1e-4)
    spec = dict(r_floor=1.0, t_max=3e8 / RE)
    kw = dict(max_steps=1024, round_steps=128, bucket_floor=8)
    auto = dict(stepper="auto", stiff_stepper="ros2x", stiff_switch=0.001,
                stiff_unswitch=0.0)
    jres = j_ensemble.make_rounds_tracer(
        cast_env(j_make_env(b0=B0_2D), np.float64),
        cfg=JSolverConfig(**cfg), spec=JStopSpec(**spec), **auto, **kw)
    j_out = jres(u0, f, valid)
    tres = ensemble.make_rounds_tracer(
        make_env(b0=B0_2D), device="cpu", dtype=torch.float64,
        cfg=SolverConfig(**cfg), spec=StopSpec(**spec), **auto, **kw)
    t_out = tres(u0, f, valid)
    assert tres.last_stiff.any()
    np.testing.assert_array_equal(tres.last_stiff, jres.last_stiff)
    assert "ros2x" in [r["stepper"] for r in tres.last_rounds]
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(t_out, name),
                                      np.asarray(getattr(j_out, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t_out.u, np.asarray(j_out.u), rtol=1e-12)
    dp5 = ensemble.make_rounds_tracer(
        make_env(b0=B0_2D), device="cpu", dtype=torch.float64,
        cfg=SolverConfig(**cfg), spec=StopSpec(**spec), stepper="dopri5",
        **kw)(u0, f, valid)
    np.testing.assert_array_equal(t_out.status[valid], dp5.status[valid])
    np.testing.assert_allclose(t_out.u[valid, :2], dp5.u[valid, :2],
                               rtol=5e-3, atol=5e-3)
