"""The one place that sets up JAX's persistent compilation cache.

Every entry point (CLIs, bench.py, chip_smoke.py, __graft_entry__.py)
calls :func:`enable_compile_cache` before its first compile. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads that directory itself
and this helper sets no other. Otherwise the cache goes to the fixed
``<repo>/.jax_cache`` (gitignored): the directory is part of what a
later process must find again, so it is never built from a temporary
name, a PID or a time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    cache_dir = os.environ.get(ENV_VAR) or REPO_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
