"""Process-wide JAX configuration for device-path entry points.

Compiling the sketch and index programs takes seconds per shape; the
persistent compilation cache makes that a one-time cost.  Every entry
point that can touch a device (CLI device backends, the device index)
calls :func:`enable_compile_cache` first — it is idempotent and cheap.
"""
from __future__ import annotations

import os

_DONE = False


def enable_compile_cache() -> None:
    """Keep compiled programs in ``JAX_COMPILATION_CACHE_DIR`` when it is
    set (JAX reads it itself), else in ``<checkout>/.jax_cache``.

    Every program is cached, however fast it compiled: a run loads a dozen
    small programs, and recompiling each costs more than loading it.
    """
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    cache = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".jax_cache",
    )
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        return  # read-only install: run without a persistent cache
    jax.config.update("jax_compilation_cache_dir", cache)
