"""Test configuration: deterministic 8-device virtual CPU mesh.

All unit tests run on the CPU with 8 virtual devices so sharding logic is
exercised without accelerator hardware; tests marked `gpu` need the card
and skip here. x64 is enabled so tests can hold f64 golden values;
library code still requests f32 explicitly.
"""
import os

# CPU unless the caller picked a platform (`JAX_PLATFORMS=cuda,cpu
# pytest -m gpu` runs the card's tests)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)
# persistent compilation cache (utils/cache.py), read-only: the suite
# looks entries up but never writes them, because serializing the
# largest engine executable crashed the CPU backend (reproduced 3x with
# a fresh and a shared directory, alone and in the suite).
from cmvs_pmvs_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(read_only=True)

import numpy as np
import pytest

# build the native extension once so its tests and fast paths run in CI
try:
    import cmvs_pmvs_tpu._native  # noqa: F401
except ImportError:
    import subprocess
    import pathlib
    _root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run(["bash", str(_root / "native" / "build.sh")],
                   check=False, capture_output=True)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
