"""Test env: force an 8-virtual-device CPU platform before first backend use.

Multi-device sharding tests run on fake CPU devices (SURVEY.md section 5,
item 3). Importing pytest already imports jax (plugin entry points), so
JAX_PLATFORMS is read before this file runs; hence XLA_FLAGS (read lazily
at backend creation) plus a platform override via jax.config, which works
any time before first backend use. Set SERT_TEST_PLATFORM=cuda to run the
suite on the card; tests marked ``gpu`` run only there (the ``gpu``
fixture below decides, never an import-time check).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("SERT_TEST_PLATFORM", "cpu"))


@pytest.fixture
def gpu():
    """Skip unless the suite runs on a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: SERT_TEST_PLATFORM=cuda python -m pytest "
                    "tests/ -m gpu, on the card")
