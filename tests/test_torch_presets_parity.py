"""Port parity for the presets that no other test runs against the JAX
package: 3d, knee_3d, ensemble3d, mr_fan, lat_fan and knee, each cut to a
few rays and a phase-path budget, through both packages' run() on the CPU
in float64. Statuses are held exactly and final states within the JAX
package's own one-ulp spread: the same run with every launch latitude
one ulp up (the bs3 base's error estimate turns last-ulp differences
into ~1e-8 in the trajectories of two correct implementations, ROADMAP
C)."""

import numpy as np
import pytest
import torch

from raytrace_tpu import config as j_config
from raytrace_tpu import run as j_run
from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.run import run

# preset -> the cut: a few of its launch values, a phase-path budget (RE)
# that the rays reach within a few hundred attempts, and a step budget for
# the rays that wedge
CUTS = {
    "3d": dict(t_max=60.0),
    "knee_3d": dict(lats=(0.9, 1.15), freqs=(1000.0,), t_max=30.0),
    "ensemble3d": dict(lats=(0.45, 1.1), freqs=(500.0, 8000.0),
                       t_max=30.0),
    "mr_fan": dict(lats=(0.0, 0.5), chis=(-0.9,), freqs=(600.0, 1200.0),
                   t_max=30.0),
    "lat_fan": dict(lats=(0.5, 1.0), chis=(-0.3, 0.3), t_max=30.0),
    "knee": dict(lats=(0.9, 1.15), chis=(0.0,), freqs=(500.0, 2000.0),
                 t_max=30.0),
}
MAX_STEPS = 1024


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fields(out):
    valid = np.asarray(out["valid"])
    res = out["result"]
    return tuple(np.asarray(getattr(res, k))[valid]
                 for k in ("status", "n_accept", "n_reject", "u"))


@pytest.mark.parametrize("name", sorted(CUTS))
def test_preset_matches_jax_within_its_one_ulp_spread(name):
    """run() of the cut preset in both packages (float64, CPU). A regular
    ray (the JAX package's one-ulp nudge keeps its status) keeps the JAX
    package's status, and where it landed or ran out its phase budget (a
    state at the same r or t) its final state lies within ten times the
    nudge's largest spread over the case's rays, or 1e-8 of each
    component's largest magnitude where that is larger; step counters are
    not held (a borderline accept or reject goes either way under the
    nudge too). A chaotic ray ends in the status of either JAX run."""
    cut = dict(CUTS[name], dtype="float64", max_steps=MAX_STEPS)
    nudged = {k: tuple(np.nextafter(np.asarray(v, np.float64), np.inf))
              for k, v in cut.items() if k == "lats"}
    if not nudged:
        base = j_config.preset(name)
        nudged = {"lats": tuple(np.nextafter(np.asarray(base.lats,
                                                        np.float64),
                                             np.inf))}
    want = _fields(j_run.run(j_config.preset(name, **cut)))
    spread = _fields(j_run.run(j_config.preset(name, **{**cut, **nudged})))
    got = _fields(run(preset(name, **cut), device="cpu"))
    st = want[0]
    regular = st == spread[0]
    assert regular.any()
    np.testing.assert_array_equal(got[0][regular], st[regular])
    assert np.all((got[0] == st) | (got[0] == spread[0]))
    held = regular & np.isin(st, (events.MAX_PHASE_TIME, events.HIT_EARTH))
    assert held.any(), st
    scale = np.maximum(np.abs(want[3][held]).max(axis=0), 1e-300)
    err = float(np.max(np.abs(got[3][held] - want[3][held]) / scale))
    own = float(np.max(np.abs(spread[3][held] - want[3][held]) / scale))
    assert err <= max(10.0 * own, 1e-8), (err, own)
