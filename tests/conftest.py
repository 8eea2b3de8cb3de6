"""Test config: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding logic is validated on a forced host-platform
device mesh.  Tests marked `gpu` need the card (the CUDA column kernel
has no CPU mode); they skip here and run on a GPU host with

    HISTORIAN_TEST_GPU=1 python -m pytest -m gpu tests/
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("HISTORIAN_TEST_GPU") != "1":
    # through the config API so it holds even if JAX was imported first
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REFERENCE_DATA = "/root/reference/data"


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: HISTORIAN_TEST_GPU=1 python -m pytest -m gpu tests/")


@pytest.fixture
def ref_data():
    return REFERENCE_DATA
