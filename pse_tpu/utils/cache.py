"""Persistent XLA compilation cache.

The step is a large XLA program; a cold compile takes tens of seconds to
minutes.  The persistent cache makes repeat runs (same shapes/config) start
in seconds.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here.  Otherwise the cache lives at a fixed path inside
the checkout (``<checkout>/.jax_cache``, git-ignored): the path is part of
the cache key, so a directory that moved would never hit.
"""

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on for every compile; returns its path."""
    import jax

    path = os.environ.get(CACHE_ENV)
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
