"""Placement of JAX's persistent compilation cache.

The cache key includes the directory, so the cache lives at one fixed path:
``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself and this
module sets nothing), else ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Enable the persistent compilation cache; return its directory."""
    path = os.environ.get(ENV)
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
