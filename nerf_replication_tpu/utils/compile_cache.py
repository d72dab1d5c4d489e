"""Persistent XLA compilation cache.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (the path is part of the cache key, so a
directory that moves never hits).
"""

from __future__ import annotations

import os

_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent cache at the checkout's directory unless the
    environment names one. Returns the directory in use (None on CPU,
    where nothing is cached). Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    # CPU AOT cache entries embed machine-feature flags that can differ
    # between processes and fail on reload — only cache accelerator
    # compiles, where they save minutes
    if jax.default_backend() == "cpu":
        return None
    os.makedirs(_DEFAULT, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _DEFAULT)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return _DEFAULT
