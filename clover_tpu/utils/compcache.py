"""Persistent XLA compilation cache for repeated harness runs.

The reference pays zero compile cost (C++ AOT); here every jitted
chain/kernel costs seconds of XLA compilation per process.  JAX's
persistent compilation cache lets later invocations reuse them.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already points
``jax_compilation_cache_dir`` there and :func:`enable` keeps it; otherwise
the cache lives at ``<checkout>/.jax_cache``.  Opt-out: set
CLOVER_NO_COMPCACHE=1 (or pass enable(None)).
"""

from __future__ import annotations

import os

_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable(path: str | None = _DEFAULT) -> str | None:
    """Point jax at a persistent compilation cache directory.

    No-op when CLOVER_NO_COMPCACHE is set or path is None; a cache dir
    that is already configured (JAX_COMPILATION_CACHE_DIR) is kept.
    Returns the active cache dir.
    """
    import jax

    if path is None or os.environ.get("CLOVER_NO_COMPCACHE"):
        return None
    current = jax.config.jax_compilation_cache_dir
    if not current:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        current = path
    # Cache every compile that takes measurable time (default threshold
    # is 1s; the kernel and solver chains all clear it, but small eager
    # helpers benefit too).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return current
