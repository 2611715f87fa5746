"""Port parity for the remaining run modes of the ray path, float64 on
the CPU, against the JAX package: the rounds tracer's stiff pool on ros2x
(tests/test_torch_modes_stiff.py) and continue_until_done through run() (this file)."""

import numpy as np
import pytest
import torch

import raytrace_tpu.config as j_config
import raytrace_tpu.run as j_run
import raytrace_tpu_torch.config as t_config
import raytrace_tpu_torch.run as t_run
from raytrace_tpu_torch.integrate import events


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# 4 rays of mr_fan_3d (one launch latitude, two longitudes, two
# frequencies) with a budget of 96 steps: the rounds run ends every ray at
# MAX_STEPS, and the continuations (dopri5, as under stepper="auto" in the
# JAX package) carry them on
CUT_MR = dict(lats=(1.05,), phis=(0.0, 1.5), chis=(-0.1,),
              freqs=(800.0, 1400.0), max_steps=96, max_continuations=2,
              continue_until_done=True, dtype="float64")


def test_continue_until_done_matches_jax_run():
    """continue_until_done through both packages' run() on a cut mr_fan_3d:
    statuses and counters equal after the rounds run and after the
    continuations, final states at rtol 1e-9 (dopri5 at the rounds run's
    bs3-conditioned hand-off, ROADMAP C)."""
    j_out = j_run.run(j_config.preset("mr_fan_3d", **CUT_MR))
    t_out = t_run.run(t_config.preset("mr_fan_3d", **CUT_MR), device="cpu")
    base = t_run.run(t_config.preset(
        "mr_fan_3d", **dict(CUT_MR, continue_until_done=False)),
        device="cpu")
    assert (base["result"].status == events.MAX_STEPS).all()
    jr, tr = j_out["result"], t_out["result"]
    n = 4
    for name in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(tr, name)[:n],
                                      np.asarray(getattr(jr, name))[:n],
                                      err_msg=name)
    steps = tr.n_accept[:n] + tr.n_reject[:n]
    # one round of 96 attempts, then two continuations of 128 (the budget
    # rounded up to trace's chunk of 64)
    assert (steps > 96).all() and (steps <= 96 + 2 * 128).all()
    ju = np.asarray(jr.u)[:n]
    scale = np.abs(ju).max(axis=0)
    scale[scale == 0] = 1.0
    assert float(np.max(np.abs(tr.u[:n] - ju) / scale)) <= 1e-9
    assert tr.carry is not None
