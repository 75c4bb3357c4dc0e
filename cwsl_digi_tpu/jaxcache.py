"""Persistent XLA compilation cache.

The decode programs take long to compile; the persistent cache makes that a
one-time cost per cache directory.  Call :func:`enable` before the first jit
(App, bench.py, chip_smoke.py and the tests do).

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set, used as
given (JAX reads the variable itself); otherwise ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = str(DEFAULT_DIR)
        DEFAULT_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
