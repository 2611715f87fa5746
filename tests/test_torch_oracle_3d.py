"""The port's float64 trace against the C++ oracle in the 3D frame:
config 4 with its negative group delay and a tilted-dipole ray
(tests/test_native.py::test_native_3d_trajectory_parity and
::test_native_3d_trajectory_parity_tilted_gcpm, their bands). The cases
are in tests/_oracle_parity.py."""

import pytest
import torch

import _oracle_parity as oracle


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_config4_ray_lands_with_the_oracle():
    oracle.config4_3d()


def test_tilted_dipole_ray_lands_with_the_oracle():
    oracle.field_3d("tilted")
