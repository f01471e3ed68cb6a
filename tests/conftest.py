"""Test configuration: run everything on the CPU with 8 virtual devices, so
the sharding tests get a multi-device mesh.

Tests that need a GPU carry the `gpu` marker; the `gpu_device` fixture skips
them when JAX sees no GPU.
"""

import os

# the CPU unless the caller names a platform (`JAX_PLATFORMS=cuda,cpu` runs
# the `gpu` tests on a card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from misaki_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run on the card: see README)")
    return devices[0]
