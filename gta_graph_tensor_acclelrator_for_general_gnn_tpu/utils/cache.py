"""JAX's persistent compilation cache, in one place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache goes to one fixed directory inside
the checkout (``.jax_cache/``, listed in ``.gitignore``): the path is part of
the cache's key, so a directory that moves between runs never hits.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``$JAX_COMPILATION_
    CACHE_DIR`` (left to JAX) or :data:`CACHE_DIR`; returns the directory.
    Call before the first compilation."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR
