"""Persistent XLA compile cache at a fixed path.

The fused device program is large and compiles once per (B, L) bucket
(engine/seed_device.py).  JAX keeps compiled programs across processes
when a cache directory is set, and the directory is part of what a later
process must find again, so it never moves.

``ensure_compile_cache`` runs before the device path's first compile:

  * ``JAX_COMPILATION_CACHE_DIR`` set (even to "", which turns the cache
    off): JAX already reads it, and nothing is set here;
  * otherwise the cache goes to ``<checkout>/.jax_cache`` (listed in
    ``.gitignore``).
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def ensure_compile_cache() -> str | None:
    """Place JAX's compile cache; returns the directory in use (None/"" =
    no persistent cache)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env is not None:
        return env
    import jax

    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return jax.config.jax_compilation_cache_dir
