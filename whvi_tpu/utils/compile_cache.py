"""Where JAX keeps its persistent compilation cache.

A cache entry is keyed by, among other things, the cache directory, so
a directory that moves between runs never hits. The rule is therefore
fixed: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
this module sets nothing; otherwise the cache lives in ``.jax_cache/``
at the root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the fixed directory
    unless ``JAX_COMPILATION_CACHE_DIR`` names one; returns the
    directory in use. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
