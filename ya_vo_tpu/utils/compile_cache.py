"""Where JAX keeps its persistent compilation cache, for every entry point.

`JAX_COMPILATION_CACHE_DIR` wins when it is set. Otherwise the cache lives
in `<checkout>/.jax_cache`, a path computed from this file's location, so
it is the same for every process that runs this checkout (the path is
part of the cache key: a directory that moves never hits).
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX's persistent cache at `cache_dir()`; returns the path."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
