"""Shared test helpers.

Multi-device tests need >=2 devices; tests/conftest.py gives the CPU
backend 8 virtual devices, and scripts/test_cpu.sh runs the suite the
same way. This mirrors the reference's testing split: serial runs
everywhere, `mpiexec -n 2..5` runs on hosts that have MPI (SURVEY.md §4).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

multidev = pytest.mark.skipif(
    jax.device_count() < 2,
    reason="needs >=2 devices (run via scripts/test_cpu.sh for the 8-dev CPU mesh)",
)


def mesh_1d(n: int = None, axis: str = "rows") -> Mesh:
    devs = jax.devices()
    n = n or min(8, len(devs))
    return Mesh(np.array(devs[:n]), (axis,))
