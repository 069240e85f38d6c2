"""Persistent XLA compilation cache.

JAX's persistent compilation cache keys serialized executables by HLO
fingerprint, so repeated processes (bench runs, test drives, the app) pay
each compile once per machine instead of once per process. The geodesic
kernel's Triton compile and XLA's autotuning are the bulk of a cold start.

Every entry point calls `enable_compile_cache()`. The directory is
`JAX_COMPILATION_CACHE_DIR` when that is set, and otherwise the fixed
`<repo>/.jax_cache/` (gitignored): the path is part of what makes a later
process find the cache, so it does not move.
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The compile-cache directory (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point jax at the persistent compile cache; returns the directory."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return path
