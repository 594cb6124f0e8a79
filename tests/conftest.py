"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices (the sharding
tests exercise mesh logic without several cards).  Tests marked ``gpu``
need the card; they are collected in every run and skip (from the
``gpu_device`` fixture) unless the run was started for the card with
PSE_TESTS_ON_GPU=1, as chip_smoke.py does:

    PSE_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
"""

import os

import pytest

ON_GPU = os.environ.get("PSE_TESTS_ON_GPU") == "1"

if not ON_GPU:
    # For any subprocesses spawned by tests too.
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The card, or a skip when this run is not on one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with PSE_TESTS_ON_GPU=1 on the card)")
    return dev
