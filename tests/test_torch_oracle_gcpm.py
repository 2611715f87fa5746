"""The port's float64 trace against the C++ oracle: a 3D ray through the
GCPM plasmasphere (tests/test_native.py::
test_native_3d_trajectory_parity_tilted_gcpm, its bands). The cases are
in tests/_oracle_parity.py."""

import pytest
import torch

import _oracle_parity as oracle


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_gcpm_ray_lands_with_the_oracle():
    oracle.field_3d("gcpm")
