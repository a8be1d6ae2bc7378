"""Test configuration.

Tests run on CPU with 8 virtual devices — the analog of the
reference's mpiuni / oversubscribed-localhost-MPI testing strategy
(SURVEY.md §4): distributed correctness is exercised without a cluster.
fp64 is enabled so convergence histories can be compared bit-for-
iteration against the reference's golden outputs.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# if a pytest plugin imported jax before this conftest, the JAX_PLATFORMS
# env assignment above came too late — force the platform through the
# config as well
jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", True)

# ---------------------------------------------------------------------------
# XLA's CPU compiler segfaults (backend_compile_and_load) when compiling
# the large IMEX/Rosenbrock while_loop programs late in a single long
# pytest process (~550 accumulated jitted executables) — reproducibly at
# tests/test_ts_imex.py in a full run, never standalone. Bound the
# compiler's accumulated state by dropping compiled-executable caches
# between test modules; per-module recompiles on CPU are cheap.
# ---------------------------------------------------------------------------
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
