"""The one compile-cache helper: JAX_COMPILATION_CACHE_DIR wins, and
without it the cache sits at the fixed <repo>/.jax_cache."""

import os

import jax
import pytest

from avxwindowfmindex_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    saved = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_dir_is_honoured(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_fixed_repo_dir_without_env(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # the same path in every process: nothing built from a pid or time
    assert compile_cache.enable_compile_cache() == want
