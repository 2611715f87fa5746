"""Port parity for parallel/checkpoint.py and utils/runrecord.py: a
checkpoint written by either package resumes in the other (the .npz
layout of the JAX package), and the run record has the JAX record's
keys (float64 on the CPU)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.integrate import trace as j_trace
from raytrace_tpu.models import make_env_lat as j_make_env_lat
from raytrace_tpu.ops import rhs as j_rhs
from raytrace_tpu.parallel import checkpoint as j_checkpoint
from raytrace_tpu.utils import write_run_record as j_write_run_record
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig, trace
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.parallel import checkpoint
from raytrace_tpu_torch.parallel.ensemble import LaunchSpec, build_launch
from raytrace_tpu_torch.utils import write_run_record

U0, F = build_launch(LaunchSpec(lats=(1.0, 1.1), chis=(0.5,),
                                freqs=(3000.0,)), np.float64)
CFG = dict(rtol=1e-5, atol=1e-8, dt0=1e-4)
SPEC = dict(r_floor=1.0, t_max=5e9 / RE)
KW = dict(stepper="dopri5", chunk=16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _j_trace(max_steps, carry0=None):
    env = j_make_env_lat()
    return j_trace(lambda u, ff: j_rhs.rhs_2d_lat(u, ff, env),
                   jnp.asarray(U0), jnp.asarray(F), cfg=JSolverConfig(**CFG),
                   spec=JStopSpec(**SPEC), max_steps=max_steps,
                   carry0=carry0, **KW)


def _t_trace(max_steps, carry0=None):
    return trace(make_env_lat(), torch.from_numpy(U0), torch.from_numpy(F),
                 cfg=SolverConfig(**CFG), spec=StopSpec(**SPEC),
                 max_steps=max_steps, carry0=carry0, **KW)


def _same(t_res, j_res):
    for k in ("status", "n_accept", "n_reject"):
        np.testing.assert_array_equal(getattr(t_res, k).numpy(),
                                      np.asarray(getattr(j_res, k)), err_msg=k)
    np.testing.assert_allclose(t_res.u.numpy(), np.asarray(j_res.u),
                               rtol=1e-12)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run cut at 128 steps, its checkpoint, and its
    resume from that checkpoint."""
    path = tmp_path_factory.mktemp("ck") / "jax.npz"
    part = _j_trace(128)
    j_checkpoint.save_carry(path, part.carry, step=128,
                            meta={"preset": "fan", "lats": (1.0, 1.1)})
    j_carry, _, _ = j_checkpoint.load_carry(path)
    return path, part, _j_trace(128, jax.tree.map(jnp.asarray, j_carry))


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    path, _, j_resumed = jax_run
    carry, step, meta = checkpoint.load_carry(path, device="cpu")
    assert step == 128
    assert str(meta["preset"]) == "fan"
    np.testing.assert_array_equal(meta["lats"], (1.0, 1.1))
    assert carry.status.dtype == torch.int32
    assert carry.u.dtype == torch.float64
    _same(_t_trace(128, carry), j_resumed)
    # numpy without a device, as the JAX package returns it
    np_carry, _, _ = checkpoint.load_carry(path)
    j_carry, _, _ = j_checkpoint.load_carry(path)
    for k in checkpoint.CARRY_FIELDS:
        np.testing.assert_array_equal(getattr(np_carry, k),
                                      getattr(j_carry, k))


def test_port_checkpoint_loads_in_jax(jax_run, tmp_path):
    j_path, _, j_resumed_own = jax_run
    t_part = _t_trace(128)
    path = tmp_path / "port.npz"
    checkpoint.save_carry(path, t_part.carry, step=128,
                          meta={"preset": "fan", "lats": (1.0, 1.1)})
    with np.load(path) as z, np.load(j_path) as zj:
        assert sorted(z.files) == sorted(zj.files)
        for name in z.files:
            assert z[name].dtype == zj[name].dtype, name
            assert z[name].shape == zj[name].shape, name
    j_carry, step, meta = j_checkpoint.load_carry(path)
    assert step == 128 and str(meta["preset"]) == "fan"
    j_resumed = _j_trace(128, jax.tree.map(jnp.asarray, j_carry))
    carry, _, _ = checkpoint.load_carry(path, device="cpu")
    resumed = _t_trace(128, carry)
    _same(resumed, j_resumed)
    _same(resumed, j_resumed_own)


def test_run_record_has_the_jax_keys(jax_run, tmp_path):
    res = _t_trace(128)
    env, cfg, spec = make_env_lat(), SolverConfig(), StopSpec(**SPEC)
    rec = write_run_record(str(tmp_path / "port.json"), env=env, cfg=cfg,
                           spec=spec, launch=LaunchSpec(), result=res,
                           stats={"n": np.int64(2)}, extra={"note": "x"})
    j_res = jax_run[1]
    j_rec = j_write_run_record(
        str(tmp_path / "jax.json"), env=j_make_env_lat(),
        cfg=JSolverConfig(), spec=JStopSpec(**SPEC), launch=LaunchSpec(),
        result=j_res, stats={"n": np.int64(2)}, extra={"note": "x"})
    loaded = json.loads((tmp_path / "port.json").read_text())
    assert loaded.keys() == j_rec.keys() == rec.keys()
    assert loaded["env"].keys() == j_rec["env"].keys()
    assert loaded["solver"] == json.loads(json.dumps(j_rec["solver"]))
    assert loaded["stop"] == json.loads(json.dumps(j_rec["stop"]))
    assert loaded["launch"] == json.loads(json.dumps(j_rec["launch"]))
    assert loaded["result"] == json.loads(json.dumps(j_rec["result"]))
    assert loaded["backend"] == "cpu" and loaded["n_devices"] == 1
    assert loaded["stats"] == {"n": 2} and loaded["extra"] == {"note": "x"}
