"""Test harness: the CPU backend with 8 virtual devices, so multi-device
sharding paths are exercised without cards.

The platform defaults to ``cpu``; card-only tests carry the ``gpu`` marker
and run on an NVIDIA GPU with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``. Whether a card is present is decided inside the ``gpu`` fixture,
never at import time."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Persistent compile cache: the suite is dominated by XLA compiles; cached
# repeat runs are several times faster. Keyed per machine — XLA:CPU AOT
# results from a different host's ISA fail to load (or SIGILL).
from jrc.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest -m gpu tests/")
    return jax.devices()[0]
