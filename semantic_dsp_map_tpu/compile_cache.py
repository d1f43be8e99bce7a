"""The persistent XLA compilation cache, set in one place for every entry
point (bench.py, chip_smoke.py, the replay CLI and the tests).

The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and in
the checkout's own ``.jax_cache/`` (git-ignored) otherwise.  A fixed path
matters: the path is part of the cache key, so a moving directory never
hits.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at :func:`cache_dir`; returns the path."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
