"""Native (C++) runtime components, loaded via ctypes.

The reference leans on native libraries for partitioning (Metis/KaHyPar)
and AMG (HYPRE/AMGCL); the device compute path here is XLA, but host-side
graph work (partitioning, RCM reordering) stays native C++ for speed at
1M+ cells. Build is on-demand (g++ -O3, generic x86-64/aarch64 code)
with a pure-numpy fallback if no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import platform
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_LIB = None
_TRIED = False


_FLAGS = ("-O3", "-shared", "-fPIC")


def _host_tag() -> str:
    """Machine architecture and host name: a library built on one host
    is never loaded on another."""
    return f"{platform.machine()}-{platform.node()}"


def artifact_name(src: bytes, flags=_FLAGS, host: str | None = None) -> str:
    """Library file name keyed by the source, the build flags and the
    host. The key is a hash, so a stale or foreign .so can never be
    picked up (git does not preserve mtimes, so an mtime check alone
    could load an unreviewable binary after a fresh clone)."""
    h = hashlib.sha256(src)
    h.update(" ".join(flags).encode())
    h.update((host if host is not None else _host_tag()).encode())
    return f"libjutul_native_{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    src = _HERE / "partitioner.cpp"
    out = _HERE / artifact_name(src.read_bytes())
    if out.exists():
        return out
    try:
        subprocess.run(
            ["g++", *_FLAGS, "-o", str(out), str(src)],
            check=True, capture_output=True, timeout=120,
        )
        return out
    except Exception:
        return None


def get_lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build()
        if path is not None:
            lib = ctypes.CDLL(str(path))
            lib.jutul_partition.restype = ctypes.c_int
            lib.jutul_partition.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.jutul_rcm.restype = ctypes.c_int
            lib.jutul_rcm.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
    return _LIB


def native_partition(neighbors, n_cells: int, n_blocks: int,
                     weights=None) -> np.ndarray | None:
    """C++ graph partition; None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nb = np.ascontiguousarray(np.asarray(neighbors, dtype=np.int64))
    out = np.zeros(n_cells, dtype=np.int64)
    wptr = None
    if weights is not None:
        w = np.ascontiguousarray(np.asarray(weights, dtype=np.float64))
        wptr = w.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.jutul_partition(
        nb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nb.shape[0], n_cells, n_blocks, wptr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


def native_rcm(neighbors, n_cells: int) -> np.ndarray | None:
    """Reverse Cuthill-McKee permutation (new->old), or None."""
    lib = get_lib()
    if lib is None:
        return None
    nb = np.ascontiguousarray(np.asarray(neighbors, dtype=np.int64))
    out = np.zeros(n_cells, dtype=np.int64)
    rc = lib.jutul_rcm(
        nb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nb.shape[0], n_cells,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


def native_aggregate(ell_cols, n: int) -> np.ndarray | None:
    """C++ greedy aggregation over an ELL sparsity; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jutul_aggregate"):
        return None
    cols = np.ascontiguousarray(np.asarray(ell_cols, dtype=np.int64))
    out = np.zeros(n, dtype=np.int64)
    lib.jutul_aggregate.restype = ctypes.c_int64
    lib.jutul_aggregate.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    n_agg = lib.jutul_aggregate(
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, cols.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n_agg <= 0:
        return None
    return out
