"""Test configuration: virtual 8-device CPU mesh (SURVEY.md §4.2 item 4).

Tests run on the CPU; all multi-device/sharding logic is validated on
fake CPU devices via --xla_force_host_platform_device_count. This must be
set before jax initializes, hence the env mutation at import time (pytest
imports conftest before test modules import jax).

Tests that only a GPU can run carry the ``gpu`` marker and skip here;
``chip_smoke.py`` runs those paths on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.device_count() == 8, (
    f"tests need the fake 8-device CPU mesh, got {jax.devices()}"
)

from gym_futbol_tpu.utils.cache import enable_compilation_cache  # noqa: E402

# Persistent XLA compile cache: the physics program's compile cost grows
# steeply with body count (5v5 ~3min on CPU); pay it once per machine.
enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other platforms"
    )


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default devices are GPUs (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
