"""Persistent XLA compilation cache.

Compiling the full path-tracing program takes tens of seconds; the
persistent cache lets every later process on the same machine start in
seconds. The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set,
else a fixed ``.jax_cache`` in the checkout, which git ignores. A fixed
path matters:
the directory is part of what the cache is keyed on. Call once before the
first jit.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV) or CHECKOUT_DIR


def enable_compilation_cache() -> str:
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
