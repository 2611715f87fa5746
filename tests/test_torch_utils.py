"""Port parity for utils/debug.py and utils/profiling.py against the JAX
package's (float64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.integrate.solve import TraceResult as JTraceResult
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.utils import debug as j_debug
from raytrace_tpu.utils import profiling as j_profiling
from raytrace_tpu_torch.integrate.solve import TraceResult
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.utils import debug, profiling


@pytest.mark.parametrize("args,root", [
    ((1.16, 0.785, 0.0, 1000.0), 1.0),     # the whistler root: evanescent
    ((2.0, 0.3, 0.1, 3000.0), -1.0),
    ((3.0, 0.2, 0.0, 20000.0), -1.0),      # evanescent on the other root
])
def test_checked_mu_matches_jax(args, root):
    j_err, j_mu = j_debug.checked_mu_2d_lat(*args, j_make_env_lat(),
                                            root=root)
    err, mu = debug.checked_mu_2d_lat(*args, make_env_lat(), root=root)
    np.testing.assert_allclose(float(mu), float(j_mu), rtol=1e-14)
    if j_err.get() is None:
        assert err.get() is None
        err.throw()
    else:
        # the JAX message ends with checkify's own suffix
        assert j_err.get().startswith(err.get())
        with pytest.raises(ValueError, match="evanescent root"):
            err.throw()


def test_nan_gate_raises_at_the_first_nan():
    x = torch.tensor([1.0, -1.0], dtype=torch.float64)
    torch.sqrt(x)               # outside the gate: NaN passes silently
    with debug.nan_gate():
        torch.sqrt(x.abs())
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)


def test_profiling_matches_jax(tmp_path):
    rng = np.random.default_rng(52)
    acc = rng.integers(0, 1000, 16).astype(np.int32)
    rej = rng.integers(0, 100, 16).astype(np.int32)
    valid = np.arange(16) < 13
    z = np.zeros(16)
    j_res = JTraceResult(u=z, t=z, status=z, n_accept=jnp.asarray(acc),
                         n_reject=jnp.asarray(rej))
    res = TraceResult(u=z, t=z, status=z, n_accept=torch.from_numpy(acc),
                      n_reject=torch.from_numpy(rej))
    assert profiling.ray_steps_per_sec(res, 0.5, valid) == (
        j_profiling.ray_steps_per_sec(j_res, 0.5, valid))
    holder = profiling.Timing()
    with profiling.timed(holder):
        torch.ones(8).sum()
    assert holder.wall_s is not None and holder.wall_s >= 0.0
    path = tmp_path / "trace.json"
    with profiling.device_trace(str(path)):
        torch.ones(64).cumsum(0)
    assert path.exists() and path.stat().st_size > 0
