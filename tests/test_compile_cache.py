"""The persistent compilation cache rule (utils/compile_cache.py)."""

import os

import jax

from whvi_tpu.utils import enable_compile_cache
from whvi_tpu.utils.compile_cache import DEFAULT_CACHE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured_and_config_left_alone(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_dir_at_checkout_root(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
