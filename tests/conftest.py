import os

# Tests run on the CPU with a virtual 8-device mesh, so the multi-device
# sharding paths compile and execute without accelerators. jax may already
# be imported (and have read JAX_PLATFORMS) by the time conftest runs, so the
# platform is also set through jax.config; the backend itself is not
# initialized until first use. Checks that need the GPU carry the ``gpu``
# marker and run on the card through ``chip_smoke.py``.
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# The persistent compilation cache follows the package's rule
# (dgl_jax.compile_cache_dir): JAX_COMPILATION_CACHE_DIR when set, else the
# checkout's .jax_cache. The suite is compile-bound on the CPU.
os.environ.setdefault("JAX_PERSISTENT_CACHE_ENABLE_XLA_CACHES", "all")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (runs on the card through chip_smoke.py)")
    return devices[0]
