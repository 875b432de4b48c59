"""Where the persistent XLA compilation cache lives.

Every entry point (the CLI mains, chip_smoke.py, bench.py, the tests)
calls `enable_compile_cache` once before its first compile. A cold
`pmvs3` run compiles every engine phase; with the cache a second run of
the same scene shape loads the executables instead.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: a fixed path (it is part of the cache key, so a
# moving directory never hits); listed in .gitignore
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(read_only: bool = False) -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and no
    directory is set here. Otherwise the cache goes to DEFAULT_DIR.
    `read_only`: look entries up but never write one (an unreachable
    minimum compile time); the test suite uses it because serializing
    the largest engine executable has crashed the CPU backend.
    """
    import jax
    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    if read_only:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          1.0e9)
    return path
