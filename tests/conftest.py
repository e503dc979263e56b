"""Test configuration: the CPU with 8 virtual devices unless told otherwise.

The suite runs on the CPU by default, with an 8-device virtual platform
for the sharding tests; Pallas kernels run there inside
``ops.pallas_walk.interpret_mode()``. ``JAX_PLATFORMS=cuda`` runs it on a
GPU instead, as does a process that already opened one (``chip_smoke.py``
runs the ``gpu``-marked tests that way; they skip elsewhere).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs, never at
    import, so every worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
