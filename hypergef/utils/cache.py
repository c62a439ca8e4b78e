"""Where JAX keeps its persistent compilation cache.

The cache key includes the directory, so the directory must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
itself), otherwise ``.jax_cache`` at the root of this checkout.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.
    Call from an entry point before the first compilation."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
