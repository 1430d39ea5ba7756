"""Algebraic multigrid (aggregation AMG) for scalar block-ELL systems.

Counterpart of the reference's AMG stack (reference: src/linsolve/precond/
amg.jl:5 ``AMGPreconditioner`` with AlgebraicMultigrid.jl hierarchies, custom
coarse-system reassembly amg.jl:238-330 and partial updates reusing the
hierarchy :165; plus the HYPRE BoomerAMG and AMGCL extensions —
ext/JutulHYPREExt, ext/JutulAMGCLWrapExt — whose native C/C++ engines this
module replaces with XLA).

Split of work:
- **Symbolic setup is value-independent and runs once** (numpy): greedy
  aggregation (Vanek-style) on the sparsity graph, coarse-level ELL
  structures, and the fine->coarse scatter maps for the Galerkin product.
  This mirrors the reference's "partial hierarchy update" trick (amg.jl:165):
  sparsity never changes between Newton iterations, so only values move.
- **Numeric setup + apply are jitted**: coarse operators are segment-sums of
  fine blocks (Galerkin R A P with piecewise-constant P), smoothing is
  damped Jacobi, and the V-cycle is a fixed unrolled recursion — all static
  shapes, no host control flow.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import tables as _tbl
from ..ops.blockell import BlockELL, ELLStructure, ell_matvec
from .precond import Preconditioner


def greedy_aggregate(cols: np.ndarray, n: int) -> np.ndarray:
    """Vanek-style greedy aggregation on an ELL sparsity graph.

    Pass 1: seed aggregates from nodes whose neighborhood is untouched.
    Pass 2: attach remaining nodes to an adjacent aggregate.
    Returns (n,) aggregate ids in [0, n_agg).
    """
    try:
        from ..native import native_aggregate

        out = native_aggregate(cols, n)
        if out is not None:
            return out
    except Exception:
        pass
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    S = cols.shape[1]
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = cols[i]
        if np.all(agg[nbrs] < 0):
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    # pass 2: attach leftovers
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = cols[i]
        assigned = agg[nbrs]
        good = assigned[assigned >= 0]
        if good.size:
            agg[i] = good[0]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg


@dataclass
class AMGLevel:
    structure: ELLStructure  # this level's ELL
    agg: np.ndarray | None  # (n,) fine->coarse map (None at coarsest)
    scatter_idx: np.ndarray | None  # (n*S,) flat coarse (row*S_c + slot)
    scatter_valid: np.ndarray | None
    n_coarse: int = 0
    agg_key: str | None = None
    scatter_key: str | None = None


class AMGHierarchy:
    """Static multilevel structure for a given fine ELLStructure."""

    _uid = [0]

    def __init__(self, structure: ELLStructure, min_coarse: int = 64,
                 max_levels: int = 10):
        AMGHierarchy._uid[0] += 1
        self.uid = AMGHierarchy._uid[0]
        self.levels: list[AMGLevel] = []
        cur = structure
        for _ in range(max_levels):
            n = cur.n_rows
            if n <= min_coarse:
                break
            agg = greedy_aggregate(np.asarray(cur.cols), n)
            n_c = int(agg.max()) + 1
            if n_c >= n:  # no coarsening progress
                break
            # coarse structure from aggregated edges
            rows_f = np.repeat(np.arange(n), cur.n_slots)
            cols_f = np.asarray(cur.cols).reshape(-1)
            edges_c = np.stack([agg[rows_f], agg[cols_f]], axis=1)
            cstruct = ELLStructure.build(n_c, edges_c)
            # scatter map: fine entry (i, s) -> coarse flat slot
            slot_c = cstruct.slots_for(agg[rows_f], agg[cols_f])
            flat = agg[rows_f] * cstruct.n_slots + slot_c
            self.levels.append(AMGLevel(cur, agg, flat.astype(np.int32),
                                        None, n_c))
            cur = cstruct
        self.levels.append(AMGLevel(cur, None, None, None, 0))
        # register big static arrays so jit users can pass them as args
        for i, lvl in enumerate(self.levels):
            pre = f"amg{self.uid}/L{i}"
            if lvl.structure.cols_key is None:
                lvl.structure.register_cols(pre + "/cols")
            if lvl.agg is not None:
                lvl.agg_key = _tbl.register(pre + "/agg", lvl.agg)
                lvl.scatter_key = _tbl.register(pre + "/scatter",
                                                lvl.scatter_idx)

    @property
    def n_levels(self) -> int:
        return len(self.levels)


class AMGPreconditioner(Preconditioner):
    """Aggregation-AMG V-cycle for SCALAR (1x1 block) ELL systems
    (reference precond/amg.jl:5).

    ``omega``: damped-Jacobi smoother weight; ``n_smooth``: pre/post sweeps;
    ``n_cycles``: V-cycles per apply.
    """

    def __init__(self, omega: float = 0.67, n_smooth: int = 2,
                 n_cycles: int = 1, min_coarse: int = 64,
                 smoother: str = "jacobi", cheby_lower: float = 0.25):
        self.omega = omega
        self.n_smooth = n_smooth
        self.n_cycles = n_cycles
        self.min_coarse = min_coarse
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self.cheby_lower = cheby_lower
        self._hier: AMGHierarchy | None = None
        self._struct_id = None

    def _symbolic(self, structure: ELLStructure) -> AMGHierarchy:
        if self._hier is None or self._struct_id != id(structure):
            self._hier = AMGHierarchy(structure, self.min_coarse)
            self._struct_id = id(structure)
        return self._hier

    def update(self, J: BlockELL):
        """Galerkin coarse operators for all levels (jitted scatter-adds)."""
        assert J.blocks.shape[2] == 1 and J.blocks.shape[3] == 1, (
            "AMGPreconditioner expects a scalar system; use CPR for blocks"
        )
        hier = self._symbolic(J.structure)
        return amg_coarsen_ops(hier, J.blocks[:, :, 0, 0])

    def apply(self, state, J: BlockELL, x):
        hier = self._symbolic(J.structure)
        b = x[:, 0] if x.ndim == 2 else x
        u = amg_vcycle_apply(hier, state, b, self.omega, self.n_smooth,
                             self.n_cycles, smoother=self.smoother,
                             cheby_lower=self.cheby_lower)
        return u[:, None] if x.ndim == 2 else u


def amg_coarsen_ops(hier: AMGHierarchy, vals):
    """Galerkin coarse operators for all levels from fine scalar ELL
    values ``vals (n, S)`` (traceable; also used replicated inside the
    distributed CPR's shard_map body)."""
    ops = []
    for li, lvl in enumerate(hier.levels[:-1]):
        ops.append(vals)
        n_c = lvl.n_coarse
        # coarse values: segment-sum of fine entries into coarse slots
        cstruct = hier.levels[li + 1].structure
        flat = jnp.asarray(_tbl.table(lvl.scatter_key)
                           if lvl.scatter_key else lvl.scatter_idx)
        coarse_flat = jax.ops.segment_sum(
            vals.reshape(-1), flat, num_segments=n_c * cstruct.n_slots
        )
        vals = coarse_flat.reshape(n_c, cstruct.n_slots)
    ops.append(vals)  # coarsest operator
    # dense coarsest for the direct bottom solve
    bottom = hier.levels[-1].structure
    nb = bottom.n_rows
    dense = jnp.zeros((nb, nb), vals.dtype)
    rows = jnp.repeat(jnp.arange(nb), bottom.n_slots)
    colsb = jnp.asarray(bottom.cols_t()).reshape(-1)
    dense = dense.at[rows, colsb].add(vals.reshape(-1))
    return (ops, dense)


def _ell_cheby_data(A):
    """(dinv, lmax) for Chebyshev smoothing of a scalar ELL level:
    inverse diagonal + Gershgorin bound on lambda_max(D^-1 A) (see
    ops/stencil.py _cheby_setup for the stencil counterpart)."""
    diag = A[:, 0]
    dabs = jnp.abs(diag)
    dsafe = jnp.where(dabs > 0, dabs, 1.0)
    offsum = jnp.sum(jnp.abs(A[:, 1:]), axis=1)
    lmax = 1.0 + jnp.max(offsum / dsafe)
    dinv = jnp.where(dabs > 0, 1.0 / diag, 0.0)
    return dinv, lmax


def _ell_cheby_smooth(A, cols, dinv, lmax, u, rhs, n_sweep,
                      lower: float = 0.25):
    """Chebyshev relaxation for the scalar ELL level via the shared
    recurrence (linsolve/cheby.py); ``u=None`` starts from zero (first
    preconditioned residual is elementwise)."""
    from .cheby import chebyshev_recurrence

    return chebyshev_recurrence(
        lambda u_: dinv * (rhs - _scalar_matvec(A, cols, u_)),
        dinv * rhs, u, n_sweep, lmax, lower)


def amg_vcycle_apply(hier: AMGHierarchy, state, b, omega: float,
                     n_smooth: int, n_cycles: int,
                     smoother: str = "jacobi",
                     cheby_lower: float = 0.25):
    """Aggregation-AMG V-cycle(s) for rhs ``b`` given ``amg_coarsen_ops``
    output (traceable). ``smoother``: "jacobi" or "chebyshev" (per-level
    Gershgorin intervals derived from the traced operator values)."""
    ops, dense = state
    cheby = smoother == "chebyshev"

    def vcycle(level: int, rhs):
        lvl = hier.levels[level]
        A = ops[level]
        cols = jnp.asarray(lvl.structure.cols_t())
        diag = A[:, 0]
        dinv = 1.0 / diag

        if level == hier.n_levels - 1:
            return jnp.linalg.solve(dense, rhs)

        if cheby:
            cdinv, lmax = _ell_cheby_data(A)
            u = _ell_cheby_smooth(A, cols, cdinv, lmax, None, rhs,
                                  n_smooth, lower=cheby_lower)
        else:
            u = omega * dinv * rhs  # first Jacobi sweep from zero
            for _ in range(n_smooth - 1):
                r = rhs - _scalar_matvec(A, cols, u)
                u = u + omega * dinv * r
        r = rhs - _scalar_matvec(A, cols, u)
        agg = jnp.asarray(_tbl.table(lvl.agg_key)
                          if lvl.agg_key else lvl.agg)
        r_c = jax.ops.segment_sum(r, agg, num_segments=lvl.n_coarse)
        e_c = vcycle(level + 1, r_c)
        u = u + e_c[agg]
        if cheby:
            return _ell_cheby_smooth(A, cols, cdinv, lmax, u, rhs,
                                     n_smooth, lower=cheby_lower)
        for _ in range(n_smooth):
            r = rhs - _scalar_matvec(A, cols, u)
            u = u + omega * dinv * r
        return u

    u = jnp.zeros_like(b)
    for _ in range(n_cycles):
        r = b - _scalar_matvec(ops[0], jnp.asarray(
            hier.levels[0].structure.cols_t()), u)
        u = u + vcycle(0, r)
    return u


def _scalar_matvec(vals, cols, x):
    """(n,S) scalar ELL matvec (flat 1D gather)."""
    n, S = vals.shape
    xg = x[cols.reshape(-1)].reshape(n, S)
    return jnp.sum(vals * xg, axis=1)


# ---------------------------------------------------------------------------
# Smoothed aggregation with strength of connection
# ---------------------------------------------------------------------------
def strength_mask(vals: np.ndarray, cols: np.ndarray,
                  theta: float) -> np.ndarray:
    """Symmetric strength of connection: |a_ij| >= theta*sqrt(|a_ii a_jj|)
    (reference: AlgebraicMultigrid.jl strength used by amg.jl:5). Slot 0
    (diagonal) is always strong; padded self-columns are weak."""
    n, S = vals.shape
    diag = np.abs(vals[:, 0])
    dj = diag[cols]  # (n, S)
    with np.errstate(invalid="ignore"):
        strong = np.abs(vals) >= theta * np.sqrt(np.abs(diag)[:, None] * dj)
    strong[:, 0] = True
    rows = np.arange(n)[:, None]
    strong &= cols != rows  # padded self-edges are not connections
    strong[:, 0] = True
    return strong


@dataclass
class _SALevel:
    """Static tables of one smoothed-aggregation level (values flow
    through jit each update; these are build-time constants)."""

    structure: ELLStructure
    n_fine: int
    n_coarse: int
    Sp: int  # P-row pattern width
    omega: float  # Jacobi prolongation-smoother weight (frozen at setup)
    k_pattern: str  # (n, Sp) coarse col per P-row slot (dump = n_coarse)
    k_pos: str  # (n, S) position of agg(cols[i,s]) in row pattern (or Sp)
    k_filter: str  # (n, S) 1.0 where strong (A_F mask)
    k_agg: str  # (n,) aggregate ids
    k_scatter: str  # (n*S*Sp*Sp,) flat coarse target (dump = n_c*S_c)
    k_gi: str  # (n*S*Sp*Sp,) flat P index of the row factor
    k_gj: str  # flat P index of the col factor
    k_ai: str  # flat A index
    coarse: ELLStructure = None


class SmoothedAggregationAMG(Preconditioner):
    """Smoothed-aggregation AMG with strength-of-connection filtering
    (reference: AMGPreconditioner{:smoothed_aggregation}, precond/amg.jl:5,
    coarse reassembly :238-330, partial hierarchy updates :165).

    Split of work: the hierarchy (strength graph, aggregates, P-row
    patterns, Galerkin triple-product scatter tables, smoother weights) is
    built ONCE from the first concrete Jacobian values (host numpy); every
    subsequent ``update`` re-runs only the value path — P values and
    Galerkin products as jitted gathers/segment-sums with static tables —
    exactly the reference's partial-update trick.

    Scale note: the triple-product tables hold n*S*Sp^2 int32 entries; this
    targets the unstructured mid-size regime (the structured 1M-cell path
    uses the lattice GMG in ops/stencil.py instead).
    """

    _uid = [0]

    def __init__(self, theta: float = 0.08, omega: float = 0.67,
                 n_smooth: int = 1, n_cycles: int = 1,
                 min_coarse: int = 64, max_levels: int = 10,
                 smoother: str = "jacobi", cheby_lower: float = 0.25):
        SmoothedAggregationAMG._uid[0] += 1
        self.uid = SmoothedAggregationAMG._uid[0]
        self.theta = theta
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self.cheby_lower = cheby_lower
        self.omega = omega  # relaxation smoother weight
        self.n_smooth = n_smooth
        self.n_cycles = n_cycles
        self.min_coarse = min_coarse
        self.max_levels = max_levels
        self._levels: list[_SALevel] | None = None
        self._struct_id = None

    # -- symbolic+numeric hierarchy from concrete values ------------------
    def _build(self, structure: ELLStructure, vals0: np.ndarray):
        levels: list[_SALevel] = []
        cur = structure
        vals = np.asarray(vals0, dtype=np.float64)
        for li in range(self.max_levels):
            n, S = vals.shape
            if n <= self.min_coarse:
                break
            cols = np.asarray(cur.cols)
            strong = strength_mask(vals, cols, self.theta)
            # aggregation on the strong graph
            cols_strong = np.where(strong, cols, np.arange(n)[:, None])
            agg = greedy_aggregate(cols_strong, n)
            n_c = int(agg.max()) + 1
            if n_c >= n:
                break

            # filtered matrix A_F: weak off-diagonals lumped to the diagonal
            filt = strong.astype(np.float64)
            aF = vals * filt
            aF[:, 0] += (vals * (1.0 - filt)).sum(axis=1)
            dinv = 1.0 / np.where(np.abs(aF[:, 0]) > 0, aF[:, 0], 1.0)
            # omega_P = 4/3 / rho(D^-1 A_F), rho by power iteration
            x = np.random.default_rng(0).standard_normal(n)
            for _ in range(20):
                y = dinv * (aF * x[cols]).sum(axis=1)
                nx = np.linalg.norm(y)
                x = y / max(nx, 1e-300)
            rho = max(nx, 1e-12)
            omega_p = (4.0 / 3.0) / rho

            # P row patterns: aggregates of strong neighbors (incl. self)
            agg_cols = np.where(strong, agg[cols], -1)
            agg_cols[:, 0] = agg[np.arange(n)]
            pattern, pos = [], np.zeros((n, S), dtype=np.int32)
            Sp = 1
            pat_rows = []
            for i in range(n):
                uniq = []
                for s in range(S):
                    a = agg_cols[i, s]
                    if a < 0:
                        continue
                    if a not in uniq:
                        uniq.append(int(a))
                pat_rows.append(uniq)
                Sp = max(Sp, len(uniq))
            pattern = np.full((n, Sp), n_c, dtype=np.int32)  # dump = n_c
            for i, uniq in enumerate(pat_rows):
                pattern[i, :len(uniq)] = uniq
                lookup = {a: p for p, a in enumerate(uniq)}
                for s in range(S):
                    a = agg_cols[i, s]
                    pos[i, s] = lookup.get(int(a), Sp) if a >= 0 else Sp

            # coarse ELL from P-pattern products
            rows_f = np.repeat(np.arange(n), S)
            cols_f = cols.reshape(-1)
            pi_pat = pattern[rows_f]  # (nS, Sp)
            pj_pat = pattern[cols_f]
            edges = []
            for pi in range(Sp):
                for pj in range(Sp):
                    e = np.stack([pi_pat[:, pi], pj_pat[:, pj]], axis=1)
                    ok = (e[:, 0] < n_c) & (e[:, 1] < n_c)
                    edges.append(e[ok])
            cstruct = ELLStructure.build(n_c, np.concatenate(edges, axis=0))
            S_c = cstruct.n_slots

            # triple-product scatter tables (flat; dump = n_c*S_c)
            nS = n * S
            scatter = np.full(nS * Sp * Sp, n_c * S_c, dtype=np.int64)
            gi = np.zeros(nS * Sp * Sp, dtype=np.int64)
            gj = np.zeros(nS * Sp * Sp, dtype=np.int64)
            ai = np.zeros(nS * Sp * Sp, dtype=np.int64)
            idx = 0
            Pw = Sp + 1  # padded P width (last col = dump zeros)
            for pi in range(Sp):
                rc = pi_pat[:, pi]
                for pj in range(Sp):
                    cc = pj_pat[:, pj]
                    ok = (rc < n_c) & (cc < n_c)
                    slot = np.zeros(nS, dtype=np.int64)
                    slot[ok] = cstruct.slots_for(rc[ok], cc[ok])
                    tgt = np.where(ok, rc * S_c + slot, n_c * S_c)
                    sl = slice(idx, idx + nS)
                    scatter[sl] = tgt
                    gi[sl] = rows_f * Pw + pi
                    gj[sl] = cols_f * Pw + pj
                    ai[sl] = np.arange(nS)
                    idx += nS

            pre = f"sa{self.uid}/L{li}"
            lvl = _SALevel(
                structure=cur, n_fine=n, n_coarse=n_c, Sp=Sp,
                omega=float(omega_p),
                k_pattern=_tbl.register(pre + "/pat", pattern),
                k_pos=_tbl.register(pre + "/pos", pos),
                k_filter=_tbl.register(pre + "/filt", filt),
                k_agg=_tbl.register(pre + "/agg", agg),
                k_scatter=_tbl.register(pre + "/sc", scatter),
                k_gi=_tbl.register(pre + "/gi", gi),
                k_gj=_tbl.register(pre + "/gj", gj),
                k_ai=_tbl.register(pre + "/ai", ai),
                coarse=cstruct,
            )
            if lvl.structure.cols_key is None:
                lvl.structure.register_cols(pre + "/cols")
            levels.append(lvl)

            # concrete coarse values for the NEXT level's strength/aggregates
            Pv = self._p_values_np(lvl, vals, aF, dinv)
            vals = self._galerkin_np(lvl, vals, Pv, n_c, S_c)
            cur = cstruct
        if cur.cols_key is None:
            cur.register_cols(f"sa{self.uid}/bottom/cols")
        self._bottom = cur
        return levels

    # -- value paths (numpy mirrors for setup; jnp in update) --------------
    def _p_values_np(self, lvl, vals, aF, dinv):
        n, S = vals.shape
        Sp = lvl.Sp
        pos = _tbl.table(lvl.k_pos)
        agg = _tbl.table(lvl.k_agg)
        pattern = _tbl.table(lvl.k_pattern)
        P = np.zeros((n, Sp + 1))
        contrib = -lvl.omega * dinv[:, None] * aF  # (n, S)
        np.add.at(P, (np.repeat(np.arange(n), S), pos.reshape(-1)),
                  contrib.reshape(-1))
        own = pattern == agg[:, None]
        P[:, :Sp][own] += 1.0
        P[:, Sp] = 0.0
        return P

    def _galerkin_np(self, lvl, vals, P, n_c, S_c):
        flatP = P.reshape(-1)
        terms = (flatP[_tbl.table(lvl.k_gi)]
                 * vals.reshape(-1)[_tbl.table(lvl.k_ai)]
                 * flatP[_tbl.table(lvl.k_gj)])
        out = np.zeros(n_c * S_c + 1)
        np.add.at(out, _tbl.table(lvl.k_scatter), terms)
        return out[:-1].reshape(n_c, S_c)

    def _p_values_jx(self, lvl, vals):
        n, S = vals.shape
        Sp = lvl.Sp
        filt = jnp.asarray(_tbl.table(lvl.k_filter), vals.dtype)
        aF = vals * filt
        aF = aF.at[:, 0].add(jnp.sum(vals * (1.0 - filt), axis=1))
        # guard zero diagonals exactly like the numpy mirror (_p_values_np)
        # or hierarchies that build fine on host go NaN on jitted updates
        d0 = aF[:, 0]
        dinv = 1.0 / jnp.where(jnp.abs(d0) > 0, d0, 1.0)
        pos = jnp.asarray(_tbl.table(lvl.k_pos), jnp.int32)
        agg = _tbl.table(lvl.k_agg)
        pattern = _tbl.table(lvl.k_pattern)
        contrib = -lvl.omega * dinv[:, None] * aF
        flat_idx = (jnp.arange(n)[:, None] * (Sp + 1) + pos).reshape(-1)
        P = jax.ops.segment_sum(contrib.reshape(-1), flat_idx,
                                num_segments=n * (Sp + 1)).reshape(n, Sp + 1)
        own = jnp.asarray((pattern == agg[:, None]), vals.dtype)
        P = P.at[:, :Sp].add(own)
        P = P.at[:, Sp].set(0.0)
        return P

    def _galerkin_jx(self, lvl, vals, P):
        n_c, S_c = lvl.n_coarse, lvl.coarse.n_slots
        flatP = P.reshape(-1)
        gi = jnp.asarray(_tbl.table(lvl.k_gi), jnp.int32)
        gj = jnp.asarray(_tbl.table(lvl.k_gj), jnp.int32)
        ai = jnp.asarray(_tbl.table(lvl.k_ai), jnp.int32)
        sc = jnp.asarray(_tbl.table(lvl.k_scatter), jnp.int32)
        terms = flatP[gi] * vals.reshape(-1)[ai] * flatP[gj]
        out = jax.ops.segment_sum(terms, sc, num_segments=n_c * S_c + 1)
        return out[:-1].reshape(n_c, S_c)

    # -- Preconditioner interface -----------------------------------------
    def update(self, J: BlockELL):
        assert J.blocks.shape[2] == 1 and J.blocks.shape[3] == 1, (
            "SmoothedAggregationAMG expects a scalar system"
        )
        vals = J.blocks[:, :, 0, 0]
        if self._levels is None or self._struct_id != id(J.structure):
            if isinstance(vals, jax.core.Tracer):
                raise RuntimeError(
                    "SmoothedAggregationAMG: first update must see concrete "
                    "values (call update once outside jit to build the "
                    "hierarchy; later updates are jit-safe)")
            self._levels = self._build(J.structure, np.asarray(vals))
            self._struct_id = id(J.structure)
        ops, Ps = [], []
        v = vals
        for lvl in self._levels:
            ops.append(v)
            P = self._p_values_jx(lvl, v)
            Ps.append(P)
            v = self._galerkin_jx(lvl, v, P)
        ops.append(v)
        nb = self._bottom.n_rows
        dense = jnp.zeros((nb, nb), v.dtype)
        rows = jnp.repeat(jnp.arange(nb), self._bottom.n_slots)
        colsb = jnp.asarray(self._bottom.cols_t()).reshape(-1)
        dense = dense.at[rows, colsb].add(v.reshape(-1))
        return (ops, Ps, dense)

    def apply(self, state, J: BlockELL, x):
        ops, Ps, dense = state
        b = x[:, 0] if x.ndim == 2 else x
        levels = self._levels

        def vcycle(li: int, rhs):
            if li == len(levels):
                return jnp.linalg.solve(dense, rhs)
            lvl = levels[li]
            A = ops[li]
            cols = jnp.asarray(lvl.structure.cols_t())
            d0 = A[:, 0]
            dinv = 1.0 / jnp.where(jnp.abs(d0) > 0, d0, 1.0)
            if self.smoother == "chebyshev":
                cdinv, lmax = _ell_cheby_data(A)
                u = _ell_cheby_smooth(A, cols, cdinv, lmax, None, rhs,
                                      self.n_smooth,
                                      lower=self.cheby_lower)
            else:
                u = self.omega * dinv * rhs
                for _ in range(self.n_smooth - 1):
                    r = rhs - _scalar_matvec(A, cols, u)
                    u = u + self.omega * dinv * r
            r = rhs - _scalar_matvec(A, cols, u)
            # restriction: r_c = P^T r
            P = Ps[li]
            n, Spp = P.shape
            pattern = jnp.asarray(_tbl.table(lvl.k_pattern), jnp.int32)
            seg = jnp.concatenate(
                [pattern, jnp.full((n, 1), lvl.n_coarse, jnp.int32)], axis=1)
            r_c = jax.ops.segment_sum(
                (P * r[:, None]).reshape(-1), seg.reshape(-1),
                num_segments=lvl.n_coarse + 1)[:-1]
            e_c = vcycle(li + 1, r_c)
            # prolongation: u += P e_c
            e_pad = jnp.concatenate([e_c, jnp.zeros(1, e_c.dtype)])
            u = u + jnp.sum(P[:, :-1] * e_pad[pattern], axis=1)
            if self.smoother == "chebyshev":
                return _ell_cheby_smooth(A, cols, cdinv, lmax, u, rhs,
                                         self.n_smooth,
                                         lower=self.cheby_lower)
            for _ in range(self.n_smooth):
                r = rhs - _scalar_matvec(A, cols, u)
                u = u + self.omega * dinv * r
            return u

        u = jnp.zeros_like(b)
        if not levels:  # system never coarsened: direct solve
            u = jnp.linalg.solve(dense, b)
            return u[:, None] if x.ndim == 2 else u
        cols0 = jnp.asarray(levels[0].structure.cols_t())
        for _ in range(self.n_cycles):
            r = b - _scalar_matvec(ops[0], cols0, u)
            u = u + vcycle(0, r)
        return u[:, None] if x.ndim == 2 else u
