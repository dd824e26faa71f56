"""Where the persistent compilation cache goes."""

import os

import jax
import pytest

from massivedatans_tpu.utils import cache

_KEYS = ("jax_enable_compilation_cache", "jax_compilation_cache_dir",
         "jax_persistent_cache_min_compile_time_secs",
         "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture
def cache_enabled():
    """Turn the cache on for one test (the suite keeps it off)."""
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    jax.config.update("jax_enable_compilation_cache", True)
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_directory_is_left_to_jax(cache_enabled, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_directory_is_fixed_inside_checkout(cache_enabled,
                                                    monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert cache.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_disabled_cache_is_left_off(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert not jax.config.jax_enable_compilation_cache
    assert cache.enable_compilation_cache() is None
