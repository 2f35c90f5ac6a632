"""Where JAX's persistent compilation cache lives.

Every entry point (``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``, ``benchmarks/*``, ``tests/conftest.py``) calls
:func:`enable_compile_cache` once, before its first compile.
"""

from __future__ import annotations

import os
import pathlib

import jax

# Inside the checkout and listed in .gitignore. Fixed, because the
# cache directory is part of what a later run must find again.
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".cache" / "jax"


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this function sets nothing. Otherwise the cache goes to
    :data:`CACHE_DIR`, keeping programs that took at least
    ``min_compile_time_secs`` to compile.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    return str(CACHE_DIR)
