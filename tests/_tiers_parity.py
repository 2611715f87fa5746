"""Shared pieces of the physics tiers' parity tests (test_torch_growth,
test_torch_diffusion, test_torch_fokker_planck, test_torch_tiers_chain):
each test runs one case -- a function of a package namespace -- through
the JAX package and through the port on the CPU, and compares the
results as numpy."""

import inspect
from types import SimpleNamespace

import numpy as np
import torch


def to_numpy(x):
    """Tensors, JAX arrays and containers of them as numpy (floats,
    strings and dataclasses pass through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


class Side:
    """A package's module whose functions return numpy: the port's run on
    the CPU (device='cpu' wherever the function takes a device)."""

    def __init__(self, mod, port):
        self._mod, self._port = mod, port

    def __getattr__(self, name):
        obj = getattr(self._mod, name)
        if not callable(obj) or isinstance(obj, type):
            return obj
        params = inspect.signature(obj).parameters.values()
        takes_device = self._port and any(
            p.name == "device" or p.kind is p.VAR_KEYWORD for p in params)

        def call(*args, **kw):
            if takes_device:
                kw.setdefault("device", "cpu")
            return to_numpy(obj(*args, **kw))

        return call


def namespace(port, **mods):
    """SimpleNamespace of Sides over the given modules."""
    return SimpleNamespace(port=port, **{k: Side(m, port)
                                        for k, m in mods.items()})


def assert_same(got, want, rtol, path="result"):
    """Recursive comparison: bool and integer arrays exactly, floats to
    rtol (NaN and inf in the same places), dataclasses and containers
    field by field."""
    if isinstance(want, dict):
        assert set(got) >= set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], rtol, f"{path}[{k!r}]")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rtol, f"{path}[{i}]")
        return
    if hasattr(want, "__dataclass_fields__"):
        for k in want.__dataclass_fields__:
            assert_same(getattr(got, k), getattr(want, k), rtol,
                        f"{path}.{k}")
        return
    if isinstance(want, str):
        assert got == want, path
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=path)
        return
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=rtol, atol=0.0, err_msg=path)
