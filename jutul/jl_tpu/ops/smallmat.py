"""Small dense block operations without LAPACK.

The block sizes in FV Jacobians are tiny (1-4: #equations per cell), and
batched ``jnp.linalg.inv``/``lu`` calls on millions of tiny matrices are
slow library calls. These closed-form/Gauss-Jordan formulas keep block
inversion elementwise, fused, with no LAPACK custom calls (counterpart of the
reference's StaticArrays SMatrix inverses, StaticCSR/ilu0.jl).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def block_inv(A):
    """Batched inverse of (..., b, b) for small b (closed forms for b<=3,
    Gauss-Jordan with partial-pivot-free scaling for larger)."""
    b = A.shape[-1]
    if b == 1:
        return 1.0 / A
    if b == 2:
        a = A[..., 0, 0]
        bb = A[..., 0, 1]
        c = A[..., 1, 0]
        d = A[..., 1, 1]
        det = a * d - bb * c
        inv_det = 1.0 / det
        out = jnp.stack([
            jnp.stack([d, -bb], axis=-1),
            jnp.stack([-c, a], axis=-1),
        ], axis=-2)
        return out * inv_det[..., None, None]
    if b == 3:
        a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a02 * a21 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c10 = a12 * a20 - a10 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a02 * a10 - a00 * a12
        c20 = a10 * a21 - a11 * a20
        c21 = a01 * a20 - a00 * a21
        c22 = a00 * a11 - a01 * a10
        det = a00 * c00 + a01 * c10 + a02 * c20
        adj = jnp.stack([
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ], axis=-2)
        return adj / det[..., None, None]
    # general small b: Gauss-Jordan without pivoting (FV diagonal blocks are
    # strongly diagonally dominant after assembly)
    eye = jnp.broadcast_to(jnp.eye(b, dtype=A.dtype), A.shape)
    M = jnp.concatenate([A, eye], axis=-1)  # (..., b, 2b)

    def elim(k, M):
        pivot = M[..., k, :] / M[..., k, k][..., None]
        M = M.at[..., k, :].set(pivot)
        factors = M[..., :, k]
        update = M - factors[..., None] * pivot[..., None, :]
        row_k = pivot
        mask = (jnp.arange(b) == k)[..., None]
        return jnp.where(mask, row_k, update)

    M = jax.lax.fori_loop(0, b, elim, M)
    return M[..., :, b:]


def bmm(A, B):
    """Batched small-block matmul (..., i, j) @ (..., j, k) WITHOUT
    dot_general: tiny contraction dims are no shape for a matrix unit;
    broadcast-multiply-reduce stays elementwise and fuses."""
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def bmv(A, x):
    """Batched small-block matvec (..., i, j) @ (..., j), elementwise."""
    return jnp.sum(A * x[..., None, :], axis=-1)


def block_solve(A, x):
    """Solve A y = x for batched small blocks: y = inv(A) @ x."""
    return bmv(block_inv(A), x)
