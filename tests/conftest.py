"""Test environment: the CPU backend with 8 virtual devices, unless
``JAX_PLATFORMS`` names another platform.

Multi-device sharding is validated on a simulated mesh
(xla_force_host_platform_device_count=8), the capability the reference
entirely lacks (SURVEY.md §4). Tests that need an NVIDIA GPU carry the
``gpu`` marker and skip without one; on a machine with the card run them
with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if jax.default_backend() == "cpu":
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture()
def gpu_device():
    """The first GPU, decided when the test runs (never at import)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (run on the card with "
                    "JAX_PLATFORMS=cuda,cpu)")


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
