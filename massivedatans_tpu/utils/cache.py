"""Persistent XLA compilation cache setup.

Engine step graphs take seconds to minutes to compile; a disk cache
amortizes that across processes. Called by the CLI, bench and
``chip_smoke.py``.

Where the cache lives: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets no directory. Otherwise the cache is the fixed
directory ``.jax_cache/`` at the root of the checkout (git-ignored): a
fixed path, because the path is part of what makes a cache hit. The cache
stays off where ``jax_enable_compilation_cache`` is false (the test suite
sets that).
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("massivedatans_tpu")

DEFAULT_CACHE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    ".jax_cache"))


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns its directory,
    or None when the cache is disabled or unavailable."""
    import jax

    if not jax.config.jax_enable_compilation_cache:
        return None
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    try:
        if not cache_dir:
            cache_dir = DEFAULT_CACHE_DIR
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except OSError as e:  # read-only checkout: compile every time
        log.warning("compilation cache unavailable: %s", e)
        return None
    return cache_dir
