"""Persistent XLA compilation cache for the entry scripts.

``simulate_jit`` compiles a whole schedule as one program, which takes
tens of seconds at a million cells. The entry scripts (``chip_smoke.py``,
``bench.py``) call :func:`enable_compile_cache` before their first
compilation so that a second run in the same checkout loads the program
instead of compiling it again. The package never calls it on import.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[3]


def compile_cache_dir(environ=os.environ, checkout: Path = CHECKOUT) -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` when set, else
    the fixed ``.jax_cache`` directory of the checkout. The path is part
    of what makes a cache hit possible, so it never depends on the
    process, the time or a temporary directory."""
    return environ.get(ENV) or str(checkout / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no other directory is configured. Must run before the process's
    first compilation: JAX decides once whether the cache is in use."""
    path = compile_cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
