import os
import sys

import pytest

# Tests run on the CPU with 8 virtual devices, so multi-device sharding
# logic is exercised without a card.  The platform is pinned before any
# computation.  Card-only tests (marker `gpu`) take the `gpu_device`
# fixture, which skips them here; chip_smoke.py runs them on the card.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from raytrace_tpu.utils.paths import ASSETS_DIR  # noqa: E402

enable_compilation_cache()

#: The reference project's scenes, as far as the repository ships them.
REFERENCE_ASSETS = ASSETS_DIR


def reference_asset(name: str) -> str:
    """Path of a reference scene in assets/; skips the calling test when
    the scene is not shipped yet (ROADMAP B1)."""
    path = os.path.join(REFERENCE_ASSETS, name)
    if not os.path.exists(path):
        pytest.skip(f"scene {name} is not in assets/ yet (ROADMAP B1)")
    return path


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip where JAX has none (decided here,
    at run time, never while a module is imported)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("card-only test: no GPU device (run chip_smoke.py on "
                    "a machine with an NVIDIA GPU)")
    return devs[0]
