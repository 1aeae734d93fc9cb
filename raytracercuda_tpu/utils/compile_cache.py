"""Persistent XLA compile cache location.

A fixed path is part of the cache's key: a directory that moves never
hits.  Entry points (`chip_smoke.py`, `bench.py`, `scripts/bench_configs.py`
and the GPU test tier) call `configure_compile_cache` before compiling.
"""

from __future__ import annotations

import os

#: ``<repo>/.jax_cache`` (listed in ``.gitignore``).
DEFAULT_CACHE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache"))


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache is `DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
