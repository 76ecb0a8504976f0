"""Test environment: force CPU with 8 virtual devices BEFORE jax import.

This is the analog of "test multi-node without a cluster" (SURVEY.md §4):
all multi-device sharding tests run on a virtual CPU mesh. Tests that need
a GPU carry the `gpu` marker and skip here (the `on_gpu` fixture decides at
run time, never at import, so every xdist worker collects the same tests).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running e2e tests (minutes); always part of "
        "the default run, deselectable with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (on the card: "
        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")


@pytest.fixture
def on_gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (backend is {jax.default_backend()!r})")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
