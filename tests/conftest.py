"""Shared test configuration.

Tests run on a virtual 8-device CPU mesh.  The host-device-count flag must
be in place before the CPU backend initialises, hence everything happens
here at conftest import time.  Subprocesses the tests spawn (CLI runs,
distributed workers) inherit ``JAX_PLATFORMS=cpu``.

Tests marked ``gpu`` need the compiled kernels on a card: they skip on the
CPU, and ``chip_smoke.py`` runs them on the GPU with ``JAX_PLATFORMS=cuda``.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest  # noqa: E402

REF_TESTS = "/root/reference/tests"


@pytest.fixture
def ref_tests_dir():
    return REF_TESTS


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")
