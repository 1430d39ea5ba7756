"""Block-ELL sparse matrix: the framework's Jacobian format.

JAX-native replacement for the reference's CSC/CSR/block-CSR Jacobians
(reference: src/core_types/core_types.jl:101-165 matrix layouts,
src/StaticCSR/mat.jl StaticSparsityMatrixCSR, src/linsolve/default.jl
LinearizedSystem). Rationale: ELL with a fixed number of slots per row and
dense (neq × ndof) blocks gives static shapes, coalesced gathers, and SpMV as
one batched multiply-reduce that XLA fuses — no indirection-chasing CSR
row loops.

Structure (static, numpy, built once per model):
- ``cols``  (n, S) int32: column cell of each slot; slot 0 is the diagonal;
  padded slots point at the row itself and carry zero blocks.
- ``slot_of``: maps (row, col) -> slot, exposed through precomputed
  per-contribution scatter maps (see ``slots_for``).

Data (traced): ``blocks`` (n, S, neq, ndof).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True, eq=False)  # identity eq/hash: one instance per model,
# and it rides as pytree aux data (array-valued fields break field-wise eq)
class ELLStructure:
    n_rows: int
    cols: np.ndarray  # (n, S) int32
    n_slots: int

    # sorted (row*n + col) keys and their slots, for vectorized lookup
    _keys: np.ndarray = None
    _slots: np.ndarray = None
    # optional tables-registry key for cols (set via register_cols) so jit
    # users can pass cols as an argument instead of an HLO constant
    cols_key: str = None

    def register_cols(self, key: str) -> None:
        from . import tables as _tbl

        _tbl.register(key, self.cols)
        object.__setattr__(self, "cols_key", key)

    def cols_t(self):
        """cols for traced code: bound table if registered, else numpy."""
        if self.cols_key is not None:
            from . import tables as _tbl

            return _tbl.table(self.cols_key)
        return self.cols

    def transpose_idx(self):
        """Flat (n*S) gather table mapping each slot of A^T to its source
        slot in A: T_blocks[i, s] = blocks[j, s*]^T with j = cols[i, s] and
        cols[j, s*] == i. Requires a structurally symmetric pattern (mesh
        face stencils are, by construction: every (i->j) edge has (j->i)).
        Padded slots map to themselves (their blocks are zero). Host-built
        once, registered in the table registry like ``matvec_idx``."""
        from . import tables as _tbl

        key = f"{self.cols_key or id(self)}/tidx"
        if not _tbl.has(key):
            n, S = self.cols.shape
            cols = np.asarray(self.cols, dtype=np.int64)
            rows = np.arange(n, dtype=np.int64)[:, None]
            own = np.broadcast_to(np.arange(S, dtype=np.int64), (n, S))
            pad = cols == rows  # slot 0 (diagonal) + padding slots
            j = cols[~pad]
            i = np.broadcast_to(rows, (n, S))[~pad]
            try:
                src_slot_off = self.slots_for(j, i)
            except KeyError as e:
                raise ValueError(
                    "transpose_idx: sparsity pattern is not structurally "
                    "symmetric") from e
            src_slot = own.copy()
            src_slot[~pad] = src_slot_off
            src_row = np.where(pad, rows, cols)
            _tbl.register(key, (src_row * S + src_slot).astype(np.int32)
                          .reshape(-1))
        return _tbl.table(key)

    def matvec_idx(self, ndof: int):
        """Flat gather index for SpMV, precomputed on host: idx[(i,s,j)] =
        cols[i,s]*ndof + j, kept as a host table (56 MB at 1M cells)
        instead of a (n, S, ndof) iota temp built in every program."""
        from . import tables as _tbl

        key = f"{self.cols_key or id(self)}/mvidx{ndof}"
        if not _tbl.has(key):
            idx = (np.asarray(self.cols, dtype=np.int32)[:, :, None] * ndof
                   + np.arange(ndof, dtype=np.int32)).reshape(-1)
            _tbl.register(key, idx)
        return _tbl.table(key)

    @staticmethod
    def build(n_rows: int, edges: np.ndarray) -> "ELLStructure":
        """Build from an (m, 2) array of (row, col) off-diagonal pairs.

        Diagonal is always present at slot 0; duplicate edges collapse;
        padded slots point at the row itself. Fully vectorized (the analogue
        of the reference's symbolic setup, which must scale to 1M+ cells).
        """
        if edges is None or len(edges) == 0:
            edges = np.zeros((0, 2), dtype=np.int64)
        edges = np.asarray(edges, dtype=np.int64)
        edges = edges[edges[:, 0] != edges[:, 1]]
        key = edges[:, 0] * n_rows + edges[:, 1]
        key = np.unique(key)
        rows = key // n_rows
        colv = key % n_rows
        # slot = 1 + rank of the edge within its row (keys are sorted, so
        # edges of a row are contiguous and ordered by col)
        row_start = np.searchsorted(rows, np.arange(n_rows))
        counts = np.diff(np.append(row_start, rows.shape[0]))
        S = 1 + (int(counts.max()) if counts.size else 0)
        slot = np.arange(key.shape[0]) - row_start[rows] + 1
        cols = np.tile(np.arange(n_rows, dtype=np.int32)[:, None], (1, max(S, 1)))
        cols[rows, slot] = colv
        # lookup table: diagonal keys + edge keys
        diag_key = np.arange(n_rows, dtype=np.int64) * n_rows + np.arange(n_rows)
        all_keys = np.concatenate([diag_key, key])
        all_slots = np.concatenate([np.zeros(n_rows, dtype=np.int32),
                                    slot.astype(np.int32)])
        order = np.argsort(all_keys)
        return ELLStructure(n_rows, cols, max(S, 1), all_keys[order],
                            all_slots[order])

    def slots_for(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Slot index for each (row, col) pair; vectorized; raises on pairs
        absent from the sparsity pattern."""
        rows = np.asarray(rows, dtype=np.int64)
        cols_q = np.asarray(cols, dtype=np.int64)
        q = rows * self.n_rows + cols_q
        ix = np.searchsorted(self._keys, q)
        if np.any(ix >= self._keys.shape[0]) or np.any(self._keys[np.minimum(
                ix, self._keys.shape[0] - 1)] != q):
            raise KeyError("slots_for: (row, col) not in sparsity pattern")
        return self._slots[ix]


class BlockELL:
    """blocks (n, S, neq, ndof) over an ELLStructure. Minimal immutable ops."""

    def __init__(self, structure: ELLStructure, blocks):
        self.structure = structure
        self.blocks = blocks

    @property
    def neq(self) -> int:
        return self.blocks.shape[2]

    @property
    def ndof(self) -> int:
        return self.blocks.shape[3]

    def matvec(self, x):
        """y = A @ x with x (n, ndof) -> y (n, neq)."""
        n, S, neq, ndof = self.blocks.shape
        idx = self.structure.matvec_idx(ndof)
        xg = x.reshape(-1)[jnp.asarray(idx)].reshape(n, S, ndof)
        return jnp.sum(self.blocks * xg[:, :, None, :], axis=(1, 3))

    def rmatvec(self, y):
        """x = A^T @ y with y (n, neq) -> x (n, ndof)."""
        return ell_rmatvec(self.blocks, self.structure.cols_t(), y)

    def to_dense(self):
        return ell_to_dense(self.blocks, self.structure.cols)

    def transpose(self) -> "BlockELL":
        """A^T as a BlockELL over the SAME structure (structurally
        symmetric patterns only — mesh stencils are). Gives the adjoint
        lambda-solves (reference gradients.jl: adjoint-layout systems fed
        to the ordinary Krylov+preconditioner stack) an explicit matrix the
        whole preconditioner zoo can factor."""
        return BlockELL(
            self.structure,
            ell_transpose(self.blocks, self.structure.transpose_idx()))


# Pytree: the static structure rides as aux data so a BlockELL can live in
# lax.while_loop carries (fully-jitted Newton) and jit arguments.
jax.tree_util.register_pytree_node(
    BlockELL,
    lambda m: ((m.blocks,), m.structure),
    lambda structure, ch: BlockELL(structure, ch[0]),
)


def ell_matvec(blocks, cols, x):
    """y[r] = sum_s blocks[r, s] @ x[cols[r, s]].

    Padded slots hold zero blocks, so no masking is needed. All gathers go
    through flat 1D index space and the block product is a broadcast-
    multiply-reduce, NOT dot_general: tiny block dims are no shape for a
    matrix unit, and the elementwise form fuses with the gather.
    """
    n, S, neq, ndof = blocks.shape
    cols = jnp.asarray(cols)
    # build the flat gather index with 1D ops only (no (n, S, ndof) iota
    # temp)
    idx = (jnp.repeat(cols.reshape(-1) * ndof, ndof)
           + jnp.tile(jnp.arange(ndof, dtype=cols.dtype), n * S))
    xg = x.reshape(-1)[idx].reshape(n, S, ndof)
    return jnp.sum(blocks * xg[:, :, None, :], axis=(1, 3))


def ell_rmatvec(blocks, cols, y):
    """x[c] = sum over (r, s) with cols[r,s]==c of blocks[r,s]^T @ y[r]."""
    n, S = cols.shape
    contrib = jnp.sum(blocks * y[:, None, :, None], axis=2)  # (n, S, ndof)
    flat = contrib.reshape(n * S, -1)
    idx = jnp.asarray(cols).reshape(n * S)
    return jax.ops.segment_sum(flat, idx, num_segments=n)


def ell_transpose(blocks, tidx):
    """Transposed blocks via the precomputed ``transpose_idx`` gather:
    pure gather + per-block swapaxes, jit-compatible (no scatters)."""
    n, S, neq, ndof = blocks.shape
    if neq != ndof:
        raise ValueError("ell_transpose: square cell blocks required")
    flat = blocks.reshape(n * S, neq, ndof)
    g = flat[jnp.asarray(tidx)].reshape(n, S, neq, ndof)
    return jnp.swapaxes(g, 2, 3)


def ell_to_dense(blocks, cols):
    """Scatter to a dense (n*neq, n*ndof) matrix (small systems / tests)."""
    n, S, neq, ndof = blocks.shape
    dense = jnp.zeros((n * neq, n * ndof), dtype=blocks.dtype)
    rows = jnp.arange(n)
    r_idx = (rows[:, None, None, None] * neq
             + jnp.arange(neq)[None, None, :, None])  # (n,1,neq,1)
    c_idx = (jnp.asarray(cols)[:, :, None, None] * ndof
             + jnp.arange(ndof)[None, None, None, :])  # (n,S,1,ndof)
    r_b = jnp.broadcast_to(r_idx, blocks.shape).reshape(-1)
    c_b = jnp.broadcast_to(c_idx, blocks.shape).reshape(-1)
    return dense.at[r_b, c_b].add(blocks.reshape(-1))


def extract_diagonal(blocks):
    """(n, neq, ndof) diagonal blocks (slot 0 by construction)."""
    return blocks[:, 0]
