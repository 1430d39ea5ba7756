"""Execution contexts.

Counterpart of the reference context system (reference:
src/core_types/contexts/ — ``DefaultContext`` default.jl:2,
``ParallelCSRContext`` csr.jl:3, ``SingleCUDAContext`` cuda.jl:2 (vestigial);
``transfer``/``float_type``/``index_type`` src/context.jl:12-92,
``select_contexts`` :96; matrix layouts core_types.jl:101-165).

Mapping to this framework:
- DefaultContext        -> CPUContext (f64, debugging/conformance)
- ParallelCSRContext    -> CPUContext too — XLA's own threading replaces
                           Polyester @batch loops (SURVEY §2.8)
- SingleCUDAContext     -> GPUContext (f32 working precision on the card)
- matrix layouts        -> the single BlockELL layout; ``as_adjoint`` maps
                           to transposed operators (ell_rmatvec)
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class JutulContext:
    float_dtype: object = np.float64
    index_dtype: object = np.int32
    platform: str = "cpu"

    def float_type(self):
        return self.float_dtype

    def index_type(self):
        return self.index_dtype

    def transfer(self, x):
        """Move an array to this context's device (reference transfer);
        raises when no device of the context's platform is attached."""
        devs = [d for d in jax.devices() if d.platform == self.platform]
        if not devs:
            raise RuntimeError(
                f"{type(self).__name__}: no {self.platform!r} device "
                f"attached (JAX sees {[d.platform for d in jax.devices()]})")
        arr = jnp.asarray(x, dtype=self.float_dtype
                          if np.issubdtype(np.asarray(x).dtype, np.floating)
                          else None)
        return jax.device_put(arr, devs[0])


@dataclass(frozen=True)
class DefaultContext(JutulContext):
    """CPU, float64 — conformance/debug runs (reference DefaultContext)."""


@dataclass(frozen=True)
class CPUContext(JutulContext):
    pass


@dataclass(frozen=True)
class GPUContext(JutulContext):
    """GPU, float32 working precision (the reference's SingleCUDAContext,
    realized)."""

    float_dtype: object = np.float32
    platform: str = "gpu"


def select_contexts(kind: str = "default") -> JutulContext:
    """reference select_contexts (src/context.jl:96).

    ``"auto"`` picks GPUContext when a GPU is attached, else
    DefaultContext — the recommended entry point for portable scripts.
    """
    if kind == "auto":
        has_gpu = any(d.platform == "gpu" for d in jax.devices())
        return GPUContext() if has_gpu else DefaultContext()
    if kind in ("default", "cpu", "csr"):
        return DefaultContext()
    if kind in ("gpu", "cuda"):
        return GPUContext()
    raise ValueError(f"unknown context kind {kind!r}")
