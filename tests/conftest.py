import os

import pytest

# Tests run on a virtual 8-device CPU mesh whether or not a GPU is
# attached; the multi-device sharding path is validated on this mesh
# (and on real cards by `chip_smoke.py --multi`). Only an explicit
# JAX_PLATFORMS=cuda keeps the GPU, for the tests marked gpu.
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (the tests marked
    gpu; on a card: JAX_PLATFORMS=cuda pytest -m gpu tests/)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
