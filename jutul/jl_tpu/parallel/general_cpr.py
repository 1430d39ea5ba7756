"""Distributed CPR for general partitions — pod-shaped (VERDICT r2 item 5).

JAX-native counterpart of the reference's per-rank CPR under domain
decomposition (reference: ext/JutulPartitionedArraysExt/linalg.jl:78
parray_preconditioner_apply! with local ILU/AMG + optionally global AMG;
src/linsolve/precond/cpr.jl quasi-IMPES weights). The slab engine's
distributed CPR (parallel/sharded.py) all_gathers the FINE pressure grid
onto every shard — O(n_global) per device, sound at 8 shards but not
pod-shaped. This design never gathers the fine grid:

- quasi-IMPES weights and the scalar pressure operator A_p are collapsed
  SHARD-LOCALLY from the face-block Jacobian (owned rows only);
- fine-level smoothing is halo-aware damped Jacobi (one ``all_to_all``
  halo exchange per sweep — the same packed plan as the residual);
- cells are aggregated SHARD-LOCALLY (Vanek greedy on the owned-owned
  face graph; aggregates never cross shards, mirroring partition-
  respecting coarse DOFs), cutting the problem ~aggregate-size-fold;
- only the COARSE system (n/agg_size values) is psum-replicated; below
  it, the existing aggregation-AMG hierarchy (linsolve/amg.py) runs
  redundantly per shard — zero further communication;
- stage 2 is block-Jacobi via the inverse diagonal blocks with the
  pressure-COLUMN SpMV (du0 is nonzero only in the p dof).

Per-device memory/compute: O(n_own) fine + O(n_global / agg_size)
coarse — the fine grid is never replicated.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..linsolve.amg import (
    AMGHierarchy,
    amg_coarsen_ops,
    amg_vcycle_apply,
    greedy_aggregate,
)
from ..ops.blockell import ELLStructure
from ..ops.smallmat import block_inv, bmv


class GeneralCPRSetup:
    """Host-side symbolic setup: shard-local aggregation + replicated
    coarse structure + per-shard scatter tables (built once; value-
    independent, so the jitted ministep can bake them as shard_map
    arguments)."""

    def __init__(self, dec, pressure_index: int = 0,
                 min_coarse: int = 64, max_levels: int = 10):
        self.p = pressure_index
        D = dec.n_devices
        nc = dec.partition.shape[0]
        neighbors = dec.neighbors
        stencil = dec.stencil
        nf, K = stencil.shape

        # -- shard-local aggregation of OWNED cells over owned-owned faces
        agg_local = np.full(nc, -1, dtype=np.int64)
        n_agg = np.zeros(D, dtype=np.int64)
        L, R = neighbors[:, 0], neighbors[:, 1]
        part = dec.partition
        for d in range(D):
            own = dec.own_lists[d]
            n_own = len(own)
            lidx = np.full(nc, -1, dtype=np.int64)
            lidx[own] = np.arange(n_own)
            mask = (part[L] == d) & (part[R] == d)
            eL, eR = lidx[L[mask]], lidx[R[mask]]
            # ELL-ish cols with self-padding for greedy_aggregate
            deg = np.zeros(n_own, dtype=np.int64)
            np.add.at(deg, eL, 1)
            np.add.at(deg, eR, 1)
            S = max(1, int(deg.max()) if deg.size else 1)
            cols = np.tile(np.arange(n_own)[:, None], (1, S))
            fill = np.zeros(n_own, dtype=np.int64)
            for a, b in ((eL, eR), (eR, eL)):
                for i in range(len(a)):
                    cols[a[i], fill[a[i]] % S] = b[i]
                    fill[a[i]] += 1
            agg_d = greedy_aggregate(cols, n_own)
            n_agg[d] = agg_d.max() + 1 if n_own else 0
            agg_local[own] = agg_d
        offsets = np.concatenate([[0], np.cumsum(n_agg)])
        self.n_coarse = int(offsets[-1])
        agg_global = offsets[part] + agg_local  # (nc,)

        # -- replicated coarse structure: edges from every (row, stencil)
        rows_all = np.concatenate([L[:, None].repeat(K, 1).reshape(-1),
                                   R[:, None].repeat(K, 1).reshape(-1)])
        cols_all = np.concatenate([stencil.reshape(-1)] * 2)
        edges = np.stack([agg_global[rows_all], agg_global[cols_all]],
                         axis=1)
        self.cstruct = ELLStructure.build(self.n_coarse, edges)
        S_c = self.cstruct.n_slots
        self.garbage = self.n_coarse * S_c  # scatter slot for dead entries

        # -- per-shard scatter tables --------------------------------------
        nom, nfm = dec.n_own_max, dec.nf_max
        self.flat_plus = np.full((D, nfm, K), self.garbage, np.int32)
        self.flat_minus = np.full((D, nfm, K), self.garbage, np.int32)
        self.flat_diag = np.full((D, nom), self.garbage, np.int32)
        self.aggG_own = np.full((D, nom), self.n_coarse, np.int32)
        for d in range(D):
            own = dec.own_lists[d]
            self.aggG_own[d, :len(own)] = agg_global[own]
            # diagonal: slot 0 by ELLStructure construction
            self.flat_diag[d, :len(own)] = agg_global[own] * S_c
            alive = dec.face_alive[d] > 0
            fg = dec.face_g[d]
            for which, rows_loc, tab in (
                    ("plus", dec.row_plus[d], self.flat_plus),
                    ("minus", dec.row_minus[d], self.flat_minus)):
                owned = alive & (rows_loc < nom)
                fi = np.flatnonzero(owned)
                if fi.size == 0:
                    continue
                row_g = own[rows_loc[fi]]
                for k in range(K):
                    col_g = stencil[fg[fi], k]
                    slots = self.cstruct.slots_for(agg_global[row_g],
                                                   agg_global[col_g])
                    tab[d, fi, k] = (agg_global[row_g] * S_c
                                     + slots).astype(np.int32)

        # -- replicated sub-hierarchy below the gathered coarse level
        self.hier = AMGHierarchy(self.cstruct, min_coarse=min_coarse,
                                 max_levels=max_levels)

    def tables(self):
        """The (D, ...) sharded tables the jitted ministep passes through
        shard_map (in_specs P(axis))."""
        return tuple(jnp.asarray(t) for t in
                     (self.flat_plus, self.flat_minus, self.flat_diag,
                      self.aggG_own))


def cpr_update(setup: GeneralCPRSetup, sys_arrays, face_tabs, cpr_tabs,
               halo, axis, flux_k: int, smoother: str = "jacobi"):
    """Per-Newton-iteration CPR state (traced, inside the shard_map body).

    Collapses the face-block Jacobian to the scalar pressure operator
    with quasi-IMPES weights, psum-assembles the replicated coarse
    operator, and Galerkin-coarsens the replicated sub-hierarchy.
    """
    r_own, diag_own, diag_acc, jacK = sys_arrays
    (face_l, face_r, row_plus, row_minus, face_alive, own_alive,
     face_st) = face_tabs
    flat_plus, flat_minus, flat_diag, aggG_own = cpr_tabs
    p = setup.p
    nom = diag_own.shape[0]
    neq = diag_own.shape[1]

    dinv = block_inv(diag_own)  # (nom, neq, ndof)
    w = dinv[:, p, :]  # (nom, neq) quasi-IMPES row weights
    w_ext = jnp.concatenate([w, jnp.zeros((1, neq), w.dtype)])  # dump row

    # scalar pressure collapse: Ap[i, st_k] = sum_e w_i[e] * jacK[e, k, p]
    apd_acc = jnp.einsum("ne,ne->n", w, diag_acc[:, :, p])  # (nom,)
    apd_full = jnp.einsum("ne,ne->n", w, diag_own[:, :, p])
    dinv_p = jnp.where(own_alive > 0, 1.0 /
                       jnp.where(apd_full != 0, apd_full, 1.0), 0.0)
    cpP = jnp.einsum("fe,fek->fk", w_ext[row_plus], jacK[:, :, :, p])
    cpM = jnp.einsum("fe,fek->fk", w_ext[row_minus], jacK[:, :, :, p])

    # replicated coarse operator: scatter-add + psum
    cvals = jnp.zeros(setup.garbage + 1, r_own.dtype)
    cvals = cvals.at[flat_diag].add(apd_acc * own_alive)
    cvals = cvals.at[flat_plus.reshape(-1)].add(cpP.reshape(-1))
    cvals = cvals.at[flat_minus.reshape(-1)].add(-cpM.reshape(-1))
    cvals = jax.lax.psum(cvals, axis)[:setup.garbage]
    cvals = cvals.reshape(setup.n_coarse, setup.cstruct.n_slots)
    amg_state = amg_coarsen_ops(setup.hier, cvals)

    def ap_matvec(u):
        """Distributed fine-level scalar pressure matvec (halo-aware)."""
        u_ext = halo(u)
        y = jnp.zeros(nom + 1, u.dtype)
        y = y.at[:nom].add(apd_acc * u)
        for k in range(flux_k):
            uk = u_ext[face_st[:, k]]
            y = y.at[row_plus].add(cpP[:, k] * uk)
            y = y.at[row_minus].add(-cpM[:, k] * uk)
        return y[:nom] * own_alive

    # fine-level Chebyshev interval: Gershgorin row-abs-sums of the
    # distributed pressure operator (faces touching an owned row are
    # always shard-local, so the row sums are local; the max is a pmax).
    # Only built when the Chebyshev smoother will read it — the default
    # jacobi path must not gamble on XLA DCE-ing a cross-device pmax.
    lmax_p = None
    if smoother == "chebyshev":
        offsum = jnp.zeros(nom + 1, apd_full.dtype)
        offsum = offsum.at[row_plus].add(jnp.sum(jnp.abs(cpP), axis=1))
        offsum = offsum.at[row_minus].add(jnp.sum(jnp.abs(cpM), axis=1))
        ratio = offsum[:nom] * jnp.abs(dinv_p) * own_alive
        lmax_p = 1.0 + jax.lax.pmax(jnp.max(ratio), axis)

    return dict(w=w, dinv=dinv, dinv_p=dinv_p, ap_matvec=ap_matvec,
                amg_state=amg_state, aggG_own=aggG_own,
                own_alive=own_alive, lmax_p=lmax_p)


def _cheby_fine(ap_mv, dinv_p, lmax, u, rhs, n_sweep, lower=0.25):
    """Chebyshev relaxation on the distributed fine pressure level —
    the shared recurrence (linsolve/cheby.py) with the halo-aware
    matvec; no dot products, so smoothing costs zero extra
    collectives."""
    from ..linsolve.cheby import chebyshev_recurrence

    return chebyshev_recurrence(
        lambda u_: dinv_p * (rhs - ap_mv(u_)), dinv_p * rhs, u, n_sweep,
        lmax, lower)


def cpr_apply(setup: GeneralCPRSetup, pstate, sys_arrays, face_tabs,
              halo, axis, flux_k: int, x, omega: float = 0.8,
              n_fine_smooth: int = 1, smoother: str = "jacobi",
              cheby_lower: float = 0.25):
    """CPR application: x (nom, neq) residual -> du (nom, ndof).

    Stage 1: halo-aware pre-smooth on A_p (damped Jacobi or Chebyshev),
    shard-local restriction (aggregates never cross shards),
    psum-replicated coarse AMG V-cycle, prolong, post-smooth. Stage 2:
    block-Jacobi with the p-column SpMV.
    """
    _r_own, _diag_own, _diag_acc, jacK = sys_arrays
    (face_l, face_r, row_plus, row_minus, face_alive, own_alive,
     face_st) = face_tabs
    p = setup.p
    w, dinv, dinv_p = pstate["w"], pstate["dinv"], pstate["dinv_p"]
    ap_mv, amg_state = pstate["ap_matvec"], pstate["amg_state"]
    aggG_own = pstate["aggG_own"]
    nom = x.shape[0]
    cheby = smoother == "chebyshev"

    r_p = jnp.einsum("ne,ne->n", w, x)  # weighted pressure residual

    # pre-smooth (first sweep from zero is elementwise)
    if cheby:
        u = _cheby_fine(ap_mv, dinv_p, pstate["lmax_p"], None, r_p,
                        n_fine_smooth, lower=cheby_lower)
    else:
        u = omega * dinv_p * r_p
        for _ in range(n_fine_smooth - 1):
            u = u + omega * dinv_p * (r_p - ap_mv(u))
    rho = r_p - ap_mv(u)

    # restrict shard-locally, replicate ONLY the coarse residual
    rc = jnp.zeros(setup.n_coarse + 1, rho.dtype)
    rc = rc.at[aggG_own].add(rho * own_alive)
    rc = jax.lax.psum(rc, axis)[:setup.n_coarse]
    ec = amg_vcycle_apply(setup.hier, amg_state, rc, omega=0.67,
                          n_smooth=2, n_cycles=1, smoother=smoother)
    u = u + ec[aggG_own] * own_alive

    # post-smooth (halo-aware)
    if cheby:
        u = _cheby_fine(ap_mv, dinv_p, pstate["lmax_p"], u, r_p,
                        n_fine_smooth, lower=cheby_lower)
    else:
        for _ in range(n_fine_smooth):
            u = u + omega * dinv_p * (r_p - ap_mv(u))
    dp = u

    # stage 2: r2 = x - A (dp e_p) via the pressure COLUMN of the
    # face-block SpMV; then block-Jacobi and re-add dp
    dp_ext = halo(dp)
    y = jnp.zeros((nom + 1, x.shape[1]), x.dtype)
    y = y.at[:nom].add(_diag_acc[:, :, p] * dp[:, None])
    for k in range(flux_k):
        dk = dp_ext[face_st[:, k]]
        y = y.at[row_plus].add(jacK[:, :, k, p] * dk[:, None])
        y = y.at[row_minus].add(-jacK[:, :, k, p] * dk[:, None])
    r2 = x - y[:nom] * own_alive[:, None]
    du = bmv(dinv, r2)
    return du.at[:, p].add(dp) * own_alive[:, None]
