"""Test configuration: CPU-only JAX.

The tests run on the CPU (``JAX_PLATFORMS=cpu``). Multi-device sharding
tests run in a subprocess (see test_sharding.py): XLA's virtual CPU
device count is fixed when the backend starts, so it cannot be raised
from inside this interpreter.

Tests that need a GPU carry the ``gpu`` marker and skip here; they are
decided inside the test (``require_gpu``), never at import time.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture
def require_gpu():
    """Skip the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
