"""Port parity: the scale-out over processes (raytrace_tpu_torch/parallel/
distributed.py and mesh.py) against the JAX package's
parallel/distributed.py, on the CPU.

The slicing, padding and recombination are host arithmetic and must be
the JAX package's exactly; at one process the whole multi-process path in
float64 is the JAX package's to its float64 tolerance; and a real
2-process gloo run's global statistics are the JAX package's
combine_stat_rows over the port's own per-process rows, exactly."""

import json
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from raytrace_tpu.constants import RE
from raytrace_tpu.integrate import SolverConfig as JSolverConfig
from raytrace_tpu.integrate import StopSpec as JStopSpec
from raytrace_tpu.models import cast_env, make_env_lat as j_make_env_lat
from raytrace_tpu.parallel import distributed as j_dist
from raytrace_tpu.parallel import mesh as j_mesh
from raytrace_tpu_torch.integrate.events import StopSpec
from raytrace_tpu_torch.integrate.solve import SolverConfig
from raytrace_tpu_torch.models.medium import make_env_lat
from raytrace_tpu_torch.parallel import LaunchSpec, build_launch, mesh
from raytrace_tpu_torch.parallel import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("P", range(1, 9))
def test_process_slice_matches_jax(P):
    """Every ray is owned by exactly one process, and the slices are the
    JAX package's for every n in 0..40."""
    for n in range(41):
        seen = []
        for i in range(P):
            got = dist.process_slice(n, i, P)
            assert got == j_dist.process_slice(n, i, P), (n, i)
            seen.extend(range(*got))
        assert seen == list(range(n))


@pytest.mark.parametrize("P", range(1, 9))
def test_local_launch_matches_jax(P, monkeypatch):
    """local_launch pads for one device a process: the JAX package's
    local_launch with one local device, array for array, for every n in
    0..40."""
    monkeypatch.setattr(jax, "local_devices", lambda: jax.devices()[:1])
    rng = np.random.default_rng(40 + P)
    for n in range(41):
        u0 = rng.normal(size=(n, 4))
        f = rng.uniform(500, 8000, n)
        valid = rng.uniform(size=n) < 0.8
        for i in range(P):
            got = dist.local_launch(u0, f, valid, process_index=i,
                                    process_count=P)
            ref = j_dist.local_launch(u0, f, valid, process_index=i,
                                      process_count=P)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
            assert got[0].shape[0] % 8 == 0


def _rows(rng, n_rows, zero_hits=()):
    keys = ("n_hit_earth", "n_dt_underflow", "mean_landing_l",
            "mean_group_delay_s", "median_landing_l", "median_group_delay_s",
            "total_accepted_steps", "total_rejected_steps")
    rows = []
    for i in range(n_rows):
        hits = 0.0 if i in zero_hits else float(rng.integers(1, 500))
        row = {k: float(rng.uniform(0.5, 9.0)) for k in keys}
        row.update(n_hit_earth=hits,
                   total_accepted_steps=float(rng.integers(0, 1 << 30)))
        if not hits:
            row.update(mean_landing_l=0.0, median_landing_l=0.0,
                       mean_group_delay_s=0.0, median_group_delay_s=0.0)
        rows.append(row)
    return rows


@pytest.mark.parametrize("n_rows,zero_hits", [
    (1, ()), (2, ()), (5, ()), (8, (3, 7)), (3, (0, 1, 2)), (2, (1,)),
])
def test_combine_stat_rows_matches_jax(n_rows, zero_hits):
    """Random rows and rows of processes that hit nothing (an empty tail
    rank weighs 0 in the median; all-zero weights give 0.0): the JAX
    package's combination, exactly."""
    rng = np.random.default_rng(7 * n_rows + len(zero_hits))
    rows = _rows(rng, n_rows, zero_hits)
    got = dist.combine_stat_rows(rows)
    assert got == j_dist.combine_stat_rows(rows)
    if len(zero_hits) == n_rows:
        assert got["median_landing_l"] == 0.0


def test_weighted_median_matches_jax():
    rng = np.random.default_rng(12)
    for size in (0, 1, 2, 7, 64):
        v = rng.normal(size=size)
        w = rng.integers(0, 4, size).astype(float)
        assert dist._weighted_median(v, w) == j_dist._weighted_median(v, w)


def test_single_process_matches_jax():
    """At one process the path is the rounds tracer plus a pass-through of
    the statistics: the port's float64 run against the JAX package's,
    counts equal, means and medians to 1e-8."""
    spec = LaunchSpec(lats=tuple(np.linspace(0.6, 0.9, 4)), chis=(0.0,),
                      freqs=(1000.0, 2000.0))
    u0, f = build_launch(spec, np.float64)
    kw = dict(max_steps=600, round_steps=256, chunk=64, bucket_floor=8)
    res, v_l, got = dist.trace_ensemble_multihost(
        make_env_lat(), u0, f, device="cpu", tracer_kw=dict(
            cfg=SolverConfig(rtol=1e-5, atol=1e-8, dt0=1e-4),
            spec=StopSpec(r_floor=1.0, t_max=5e8 / RE), **kw))
    assert res.u.dtype == np.float64 and v_l.sum() == 8
    _, _, ref = j_dist.trace_ensemble_multihost(
        cast_env(j_make_env_lat(), np.float64), u0, f, tracer_kw=dict(
            cfg=JSolverConfig(rtol=1e-5, atol=1e-8, dt0=1e-4),
            spec=JStopSpec(r_floor=1.0, t_max=5e8 / RE), **kw))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if k.startswith(("mean_", "median_")):
            assert got[k] == pytest.approx(float(v), rel=1e-8), k
        else:
            assert got[k] == float(v), k


def test_ensure_initialized_single_process(monkeypatch):
    """No group is opened for a single-process run, with or without
    torchrun's environment; a multi-process run without a rank or a
    coordinator is refused."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    dist.ensure_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    dist.ensure_initialized()
    assert not torch.distributed.is_initialized()
    assert (dist.rank(), dist.world_size()) == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank"):
        dist.ensure_initialized()
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="host:port"):
        dist.ensure_initialized()
    assert dist.aggregate_stats({"n_hit_earth": 3, "median_landing_l": 2.5}
                                ) == {"n_hit_earth": 3.0,
                                      "median_landing_l": 2.5}


def test_local_device_and_pad_rays(monkeypatch):
    """local_device names the caller's device, else this rank's card, and
    without a card and a named device raises; pad_rays is the JAX
    package's arithmetic over the processes."""
    assert mesh.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.local_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device() == torch.device("cuda", 1)
    for n in (0, 1, 8, 9, 63, 65):
        for parts in (1, 2, 8):
            fake_mesh = types.SimpleNamespace(devices=np.empty(parts))
            assert mesh.pad_rays(n, parts) == j_mesh.pad_rays(n, fake_mesh)


def test_two_real_processes():
    """A real 2-process gloo run: two subprocesses open a group against a
    localhost coordinator, trace their slices of one global grid on the
    CPU and gather their statistics. Both print the same GLOBAL, which is
    the JAX package's combine_stat_rows over the two LOCAL rows exactly;
    the medians lie between the per-process ones, and every valid ray was
    traced somewhere."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    worker = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(port), "2", str(i)],
                         env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dec = json.JSONDecoder()
    local, glob = {}, {}
    for out in outs:
        for line in out.splitlines():
            for tag, into in (("LOCAL ", local), ("GLOBAL ", glob)):
                if tag in line:
                    _, pid, payload = line[line.index(tag):].split(" ", 2)
                    into[int(pid)] = dec.raw_decode(payload)[0]
    assert set(local) == {0, 1} and set(glob) == {0, 1}
    assert glob[0] == glob[1]
    assert glob[0] == j_dist.combine_stat_rows([local[0], local[1]])
    meds = [local[i]["median_landing_l"] for i in (0, 1)]
    if min(meds) > 0:
        assert min(meds) <= glob[0]["median_landing_l"] <= max(meds)
    total = sum(v for k, v in glob[0].items()
                if k.startswith("n_") and k != "n_retrograde_t")
    assert total == 8


def test_cli_multihost_single_process(tmp_path, capsys, monkeypatch):
    """--multihost without torchrun's environment is a single-process
    pass-through: the local line and a GLOBAL whose statistics are run()'s
    on the same config."""
    import raytrace_tpu_torch.config as t_config
    from raytrace_tpu_torch.__main__ import main as t_main
    from raytrace_tpu_torch.run import run as t_run

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    cfg = t_config.preset("ensemble10k", lats=(0.8, 0.9), chis=(0.5,),
                          freqs=(3000.0,), max_steps=128, dtype="float64")
    path = tmp_path / "tiny.json"
    cfg.to_json(str(path))
    assert t_main([str(path), "--device", "cpu", "--multihost"]) == 0
    out = capsys.readouterr().out
    assert "ensemble10k[0/1] on cpu: 2 local rays" in out
    glob = json.loads(out.split("GLOBAL ", 1)[1].splitlines()[0])
    ref = t_run(cfg, device="cpu")["stats"]
    assert glob.keys() == ref.keys()
    for k, v in ref.items():
        assert glob[k] == pytest.approx(float(v), rel=1e-15, abs=0), k
