"""The CUDA step kernel against its plain PyTorch version on the card.

Marked `gpu`: on a machine without a CUDA device every test here skips.
On the card: `python -m pytest tests/test_torch_cuda.py -m gpu -q
--noconftest` (tests/conftest.py imports jax, which a machine with only
the port need not have)."""

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.config import preset
from raytrace_tpu_torch.constants import RE
from raytrace_tpu_torch.integrate import events
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import (
    RayCarry, SolverConfig, init_carry, trace,
)
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.ops import rhs
from raytrace_tpu_torch.ops import step_chunk as sc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("stepper", ["bs3", "dopri5"])
def test_kernel_matches_plain_version_float64(cuda, stepper):
    env = make_env_lat()
    ens = preset("ensemble10k", dtype="float64")
    cfg, spec = ens.solver(), ens.stop()
    rng = np.random.default_rng(50)
    n = 256
    u0 = torch.tensor(np.stack([np.full(n, (RE + 1e6) / RE),
                                rng.uniform(0.45, 1.1, n),
                                rng.uniform(-0.5, 0.5, n), np.zeros(n)], 1),
                      device=cuda)
    f = torch.tensor(rng.uniform(500.0, 8000.0, n), device=cuda)
    carry = init_carry(lambda u, ff: rhs.rhs_2d_lat(u, ff, env), u0, f, cfg)
    launches = sc.step_chunk.launches
    got = sc.step_chunk(carry, f, env, cfg, spec, stepper=stepper, n_steps=1)
    assert sc.step_chunk.launches == launches + 1
    ref = sc.step_chunk_reference(carry, f, env, cfg, spec, stepper=stepper,
                                  n_steps=1)
    torch.cuda.synchronize()
    for name in RayCarry._fields:
        a, b = getattr(got, name).cpu(), getattr(ref, name).cpu()
        if a.dtype == torch.int32:
            assert torch.equal(a, b), name
        elif name == "u_lo":
            assert float((a - b).abs().max()) <= 1e-12
        else:
            # per component against its largest magnitude over the batch;
            # the floor keeps an all-zero column (T at launch) at 0, not NaN
            scale = b.abs().amax(dim=0) if b.dim() == 2 else b.abs()
            scale = scale.clamp_min(torch.finfo(b.dtype).tiny)
            assert float(((a - b).abs() / scale).max()) <= 1e-12, name


def test_canonical_ray_through_the_kernel(cuda):
    res = trace(make_env_lat(),
                torch.tensor([[(RE + 1e6) / RE, np.pi / 4, 0.0, 0.0]],
                             dtype=torch.float64, device=cuda),
                torch.tensor([1000.0], dtype=torch.float64, device=cuda),
                cfg=SolverConfig(rtol=1e-7, atol=1e-12, dt0=1e-4),
                spec=StopSpec(r_floor=1.0, t_max=5e9 / RE),
                stepper="dopri5", max_steps=40000)
    assert int(res.status[0]) == events.HIT_EARTH
    u = res.u[0].cpu().numpy()
    assert abs(u[0] - 1.0) <= 1e-12
    assert abs(np.degrees(u[1]) - 2.747) <= 0.01
    assert abs(u[3] - 3.1251) <= 0.001
    assert abs(int(res.n_accept[0]) - 4135) <= 0.02 * 4135
