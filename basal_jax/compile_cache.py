"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX itself reads
it, and no other directory is set in code.  Otherwise the cache lives at
one fixed path inside the checkout, ``<repo>/.jax_cache`` (gitignored):
the directory is part of the cache's key, so a path that moved between
runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[1] / ".jax_cache"


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()`` and cache
    every entry (the extension kernels compile in well under a second, so
    JAX's default thresholds would skip them).  Idempotent; returns the
    directory."""
    import jax
    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return d
