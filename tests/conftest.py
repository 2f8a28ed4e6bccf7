"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

The platform comes from ``JAX_PLATFORMS`` when it is set and is pinned to
the CPU otherwise, both in the environment and in ``jax.config`` (backends
are not initialized yet when this conftest is imported).

Tests that need the GPU are marked ``gpu`` and take the ``gpu`` fixture,
which skips them when JAX finds no GPU. On a machine with the card they run
with ``JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_hw.py -q``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if jax.config.jax_platforms != os.environ["JAX_PLATFORMS"]:
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# NB: do NOT enable jax_compilation_cache_dir on the CPU path — on XLA:CPU
# the AOT serialization path it triggers made the train step several times
# slower and never hit across processes. utils/compile_cache.py gates this.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one; run with "
        "JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_hw.py)"
    )


@pytest.fixture(scope="session")
def gpu():
    """Skips the test unless JAX's default device is a GPU. Decided when a
    test asks for it, never at import or collection."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on a machine "
                    "with the card")
    return jax.devices()[0]
