"""Precision control for the framework.

The reference (Jutul.jl) is Float64 throughout; Julia gives it that for free.
On an accelerator float64 runs at a fraction of the float32 rate and
doubles the bytes every bandwidth-bound stage moves, so precision is a
first-class, explicit choice here:

- ``float_type()`` — the working dtype for states/residuals/Jacobians.
- x64 is enabled at import so CPU conformance tests can run at reference
  precision; GPU runs may select float32 with iterative refinement.

Reference behavior being reproduced: Jutul's ``float_type(context)``
(src/context.jl:12-92).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Enable x64 mode once, at package import. Individual models choose their
# working dtype; enabling x64 merely *allows* float64, it does not force it.
jax.config.update("jax_enable_x64", True)

# Default dot/einsum precision may run float32 contractions in TF32 on the
# GPU's tensor cores (about three decimal digits). For an implicit-solver
# framework every matmul-shaped contraction sits on a Jacobian or
# preconditioner path, where silent input rounding degrades Newton/Krylov
# convergence RATES while leaving answers correct — a failure invisible
# to correctness tests. Full f32 precision is the framework-wide default;
# the few matmuls here are bandwidth-bound, so the extra passes are free.
jax.config.update("jax_default_matmul_precision", "highest")

_DEFAULT_FLOAT = jnp.float64
_DEFAULT_INT = jnp.int32


def float_type():
    return _DEFAULT_FLOAT


def int_type():
    return _DEFAULT_INT


def set_default_float(dtype) -> None:
    global _DEFAULT_FLOAT
    _DEFAULT_FLOAT = jnp.dtype(dtype)


class default_float:
    """Context manager to temporarily change the working float dtype."""

    def __init__(self, dtype):
        self.dtype = jnp.dtype(dtype)
        self._saved = None

    def __enter__(self):
        global _DEFAULT_FLOAT
        self._saved = _DEFAULT_FLOAT
        _DEFAULT_FLOAT = self.dtype
        return self.dtype

    def __exit__(self, *exc):
        global _DEFAULT_FLOAT
        _DEFAULT_FLOAT = self._saved
        return False
