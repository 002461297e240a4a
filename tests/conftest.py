"""Test configuration.

By default everything runs on an 8-device virtual CPU mesh (multi-device
sharding tests use XLA's host-platform device-count override, SURVEY.md §4)
and Pallas kernels run in interpret mode.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere.  They are run on
the card by ``python chip_smoke.py`` (phase 2), which sets
``VK3D_TESTS_ON_GPU=1`` so this file leaves the platform alone.
"""

import os

ON_GPU = os.environ.get("VK3D_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run by chip_smoke.py)"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is an NVIDIA GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run by chip_smoke.py on the card")
