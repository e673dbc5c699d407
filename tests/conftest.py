"""Test config: the CPU backend with 8 virtual devices, unless the
environment names other platforms.

Tests exercise numerics + sharding on a virtual 8-device CPU mesh
(SURVEY.md §4: multi-process CPU simulation is the "fake backend" for
distributed tests).  Tests marked ``gpu`` need the card; their ``gpu``
fixture skips them where JAX finds none.  On a machine with the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (multi-process spawns etc.)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (use the gpu fixture, which skips "
                   "where JAX finds none)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as ex:
        pytest.skip(f"no GPU: {ex}")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The suite compiles several hundred XLA CPU programs; with every
    executable kept alive by jax's C++-level caches, the LLVM JIT state
    eventually corrupts and backend_compile segfaults deterministically
    around test ~177 (reproduced twice, crash inside
    jax/_src/compiler.py backend_compile_and_load; every module passes in
    isolation).  Dropping the caches at module boundaries keeps the live
    executable count bounded; intra-module caching (where the reuse is)
    is unaffected.
    """
    yield
    jax.clear_caches()
