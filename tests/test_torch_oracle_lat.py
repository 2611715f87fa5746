"""The port's float64 trace against the C++ oracle: the canonical
RayTrace_lat ray (tests/test_native.py::test_native_trace_parity, its
bands). The cases are in tests/_oracle_parity.py."""

import pytest
import torch

import _oracle_parity as oracle


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_canonical_2d_ray_lands_with_the_oracle():
    oracle.canonical_2d()
