"""Test configuration: the JAX parts run on a virtual 8-device CPU mesh.

Multi-device sharding logic is checked against XLA's host-platform
device emulation.  Must run before jax is imported.

ZKLAIM_TEST_PLATFORM=gpu runs the suite on the GPU instead; tests
marked `gpu` (which take the `gpu` fixture) run only there:

    ZKLAIM_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu
"""

import os

_PLATFORM = os.environ.get("ZKLAIM_TEST_PLATFORM", "cpu")

if _PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

from zklaim_tpu.utils.jaxconfig import setup_cache

if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")

# CPU: disables the persistent cache (XLA:CPU serialization crash);
# GPU: keeps compiled programs where utils.jaxconfig says.
setup_cache()

import random

import pytest


@pytest.fixture
def rng():
    return random.Random(20260817)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU.  Decided here, when
    the test runs, never at import or collection time."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (ZKLAIM_TEST_PLATFORM=gpu)")
