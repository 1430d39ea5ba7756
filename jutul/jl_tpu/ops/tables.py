"""Static-table registry: keep big index arrays out of the HLO.

The assembly engine precomputes large index tables (gather maps, ELL
columns, stencils — O(100 MB) at 1M cells). Closing over them inside jit
embeds them as HLO constants, which explodes the serialized program and
bloats compile time. This registry lets the same code run in two modes:

- unbound (default, small models/tests): ``table(key)`` returns the numpy
  array as a jnp constant — simple, no plumbing;
- bound (production/bench): the caller fetches ``device_tables()`` once,
  passes them as a jit ARGUMENT, and wraps the traced call in
  ``bind(tables)`` so every ``table(key)`` resolves to the traced array.

Counterpart note: the reference's analogous precomputed ``jacobian_
positions`` (ad/ad.jl:103) live in ordinary Julia arrays; XLA's
trace-and-embed model is what makes this registry necessary here.
"""

from __future__ import annotations

from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np

_registry: dict[str, np.ndarray] = {}
_ctx: dict | None = None


def register(key: str, arr) -> str:
    """Store a host-side table; returns the key for later lookup."""
    _registry[key] = np.asarray(arr)
    return key


def table(key: str):
    """Fetch a table for use in traced code: the bound (traced) version if
    inside ``bind``, else the registered numpy array."""
    if _ctx is not None and key in _ctx:
        return _ctx[key]
    return _registry[key]


def has(key: str) -> bool:
    return key in _registry


def device_tables(prefix: str | None = None) -> dict:
    """All registered tables (optionally filtered by key prefix) as jnp
    arrays — pass this dict as a jit argument and ``bind`` it."""
    return {k: jnp.asarray(v) for k, v in _registry.items()
            if prefix is None or k.startswith(prefix)}


@contextmanager
def bind(tables: dict):
    global _ctx
    old = _ctx
    _ctx = tables if old is None else {**old, **tables}
    try:
        yield
    finally:
        _ctx = old
