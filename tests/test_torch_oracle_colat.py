"""The port's float64 trace against the C++ oracle: RayMain's ray in the
colatitude frame and the ducted ray through He+/O+
(tests/test_native.py::test_native_colat_trace_parity and
::test_native_trace_parity_duct_multiion, their bands). The cases are in
tests/_oracle_parity.py."""

import pytest
import torch

import _oracle_parity as oracle


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_raymain_colat_ray_lands_with_the_oracle():
    oracle.raymain_colat()


def test_duct_multiion_ray_lands_with_the_oracle():
    oracle.duct_multiion()
