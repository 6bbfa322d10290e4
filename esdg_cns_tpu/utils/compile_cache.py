"""Persistent XLA compilation cache: one rule for every entry point.

``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it at import, and
no other directory is set here.  Unset: the cache goes to
``<repo>/.jax_cache`` (listed in .gitignore), a fixed path so that
repeated runs from one checkout hit it.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
