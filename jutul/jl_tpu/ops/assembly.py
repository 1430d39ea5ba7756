"""Assembly engine: compile a SimulationModel into jitted residual/Jacobian.

This is the JAX-native counterpart of Jutul's entire AD + assembly stack
(reference: src/ad/ad.jl dual allocation & fill_equation_entries!,
src/ad/local_ad.jl LocalPerspectiveAD, src/ad/generic.jl GenericAutoDiffCache,
src/equations.jl alignment, src/conservation/conservation.jl TPFA assembly).

The reference seeds ForwardDiff duals with entity-local partials and scatters
value+partials into a pre-aligned sparse matrix. Here the same mathematics is
expressed as:

- residual value: secondary variables evaluated once globally (topological
  order), then contributions vmapped over cells/faces and scattered with
  ``.at[].add`` / segment sums (deterministic under XLA).
- Jacobian: per-face / per-cell closures take the local primary dof vector(s),
  unpack them into variable values, re-evaluate the (entity-local) secondary
  chain, and compute the contribution; ``jax.vmap(jax.jacfwd(...))`` yields
  exactly the reference's N-partial entity-local blocks, which are scattered
  into a BlockELL matrix at statically precomputed slots (the analogue of
  ``jacobian_positions`` / ``injective_alignment!``, ad/ad.jl:103-169).

Everything returned by ``compile_model`` is jit-compatible; static index
arrays are captured as numpy constants.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.entities import CELLS, FACES, JutulEntity
from ..models.equations import (
    AccumulationContribution,
    CellTermContribution,
    FaceFluxContribution,
)
from . import tables as _tbl
from .blockell import BlockELL, ELLStructure


@dataclass
class EquationInfo:
    name: str
    eq: Any
    neq: int
    row_slice: slice  # into the stacked per-cell equation axis


class CompiledModel:
    """Static compilation product of a SimulationModel.

    Provides jittable pure functions over state dicts:
      - evaluate_secondaries(state)
      - residual(state, state0, dt, forces)
      - jacobian_blocks(state, state0, dt, forces)
      - get_dofs(state) / apply_update(state, du, relaxation)
      - convergence(r, state, dt)
    """

    _uid_counter = [0]

    def __init__(self, model):
        CompiledModel._uid_counter[0] += 1
        self._uid = CompiledModel._uid_counter[0]
        self.model = model
        model.validate()
        self.layout = model.dof_layout()
        self.ndof = self.layout.ndof
        self.secondary_order = model.sorted_secondary_variables()

        # classify state entries by entity
        self.cell_entry_entity: dict[str, JutulEntity] = {}
        for group in (model.primary_variables, model.parameters,
                      model.secondary_variables):
            for name, var in group.items():
                self.cell_entry_entity[name] = var.associated_entity(model)

        # equations live on ONE common row entity — Cells usually, but any
        # entity works (reference: equations on arbitrary entities,
        # src/equations.jl:328-434); primaries must share it so the block
        # system stays square per row.
        self.equations: list[EquationInfo] = []
        ofs = 0
        row_entity: JutulEntity | None = None
        for name, eq in model.equations.items():
            ent = eq.entity(model)
            if row_entity is None:
                row_entity = ent
            elif ent != row_entity:
                raise NotImplementedError(
                    f"single-entity engine: all equations must share one "
                    f"entity; got {row_entity} and {ent}. Mixed-entity "
                    f"models compile via ops/mixed.py — use compile_model "
                    f"(it dispatches automatically)")
            neq = eq.number_of_equations_per_entity(model)
            self.equations.append(EquationInfo(name, eq, neq, slice(ofs, ofs + neq)))
            ofs += neq
        self.row_entity = row_entity if row_entity is not None else CELLS
        for name, var in model.primary_variables.items():
            if var.associated_entity(model) != self.row_entity:
                raise NotImplementedError(
                    f"primary {name!r} lives on "
                    f"{var.associated_entity(model)}, equations on "
                    f"{self.row_entity}")
        # row-entity count; named n_cells for the common Cells case
        self.n_cells = model.count_entities(self.row_entity)
        # coupling ("face") parameters: entries on Faces when rows are not
        # Faces themselves; a Faces-row model has no distinct coupling entity
        self.coupling_entity = FACES if self.row_entity != FACES else None
        self.neq_total = ofs
        if self.neq_total != self.ndof:
            raise ValueError(
                f"equations per row ({self.neq_total}) != dofs per row "
                f"({self.ndof}); square systems required"
            )

        # compile contributions & sparsity
        self.contribs: list[tuple[EquationInfo, Any, dict]] = []
        edges: list[np.ndarray] = []
        for info in self.equations:
            for con in info.eq.contributions(model):
                meta: dict = {}
                if isinstance(con, FaceFluxContribution):
                    st = np.asarray(con.stencil, dtype=np.int32)
                    plus = np.asarray(con.plus, dtype=np.int32)
                    minus = np.asarray(con.minus, dtype=np.int32)
                    K = st.shape[1]
                    for k in range(K):
                        edges.append(np.stack([plus, st[:, k]], axis=1))
                        edges.append(np.stack([minus, st[:, k]], axis=1))
                    meta.update(stencil=st, plus=plus, minus=minus, K=K)
                self.contribs.append((info, con, meta))

        all_edges = np.concatenate(edges, axis=0) if edges else np.zeros((0, 2), int)
        self.ell = ELLStructure.build(self.n_cells, all_edges)
        self.ell.register_cols(f"cm{self._uid}/ell_cols")
        # precompute scatter slots for each face-flux contribution
        for info, con, meta in self.contribs:
            if isinstance(con, FaceFluxContribution):
                st, plus, minus = meta["stencil"], meta["plus"], meta["minus"]
                K = meta["K"]
                meta["plus_slots"] = np.stack(
                    [self.ell.slots_for(plus, st[:, k]) for k in range(K)], axis=1
                )  # (nf, K)
                meta["minus_slots"] = np.stack(
                    [self.ell.slots_for(minus, st[:, k]) for k in range(K)], axis=1
                )
                self._build_gather_tables(meta)

    def _build_gather_tables(self, meta: dict) -> None:
        """Invert the scatter: for every (row, slot) of the ELL matrix,
        which (face, stencil-k, sign) contributions land there.

        This converts assembly from scatter-add (atomics, ordering-dependent
        sums) to pure gathers — the dual of the reference's half-face
        CSR maps (src/domains.jl:101, conservation.jl conn_pos/conn_data).
        Off-diagonal slots of a two-point-style stencil receive at most P
        entries; diagonal rows receive up to the vertex degree.
        """
        n, S = self.n_cells, self.ell.n_slots
        st, plus, minus = meta["stencil"], meta["plus"], meta["minus"]
        K = meta["K"]
        nf = st.shape[0]
        rows, slots, faces, ks, signs = [], [], [], [], []
        for k in range(K):
            for rr, ss, sign in ((plus, meta["plus_slots"][:, k], 1.0),
                                 (minus, meta["minus_slots"][:, k], -1.0)):
                rows.append(rr.astype(np.int64))
                slots.append(ss.astype(np.int64))
                faces.append(np.arange(nf, dtype=np.int64))
                ks.append(np.full(nf, k, dtype=np.int64))
                signs.append(np.full(nf, sign))
        rows = np.concatenate(rows)
        slots = np.concatenate(slots)
        faces = np.concatenate(faces)
        ks = np.concatenate(ks)
        signs = np.concatenate(signs)

        def table(sel, width, W):
            """(rows[sel], width[sel]) -> padded (n, W, P) gather tables."""
            r_, w_, f_, k_, s_ = (rows[sel], width[sel], faces[sel], ks[sel],
                                  signs[sel])
            key = r_ * W + w_
            order = np.argsort(key, kind="stable")
            key_s = key[order]
            starts = np.searchsorted(key_s, key_s)
            rank = np.arange(key_s.shape[0]) - starts
            P = int(rank.max()) + 1 if rank.size else 1
            facek = np.zeros((n * W, P), dtype=np.int32)
            sign = np.zeros((n * W, P), dtype=np.float64)
            face = np.zeros((n * W, P), dtype=np.int32)
            facek[key_s, rank] = (f_[order] * K + k_[order]).astype(np.int32)
            face[key_s, rank] = f_[order].astype(np.int32)
            sign[key_s, rank] = s_[order]
            return (facek.reshape(n, W, P), face.reshape(n, W, P),
                    sign.reshape(n, W, P), P)

        is_diag = slots == 0
        d_facek, d_face, d_sign, Pd = table(is_diag, np.zeros_like(slots), 1)
        o_facek, o_face, o_sign, Po = table(~is_diag,
                                            np.maximum(slots - 1, 0),
                                            max(S - 1, 1))
        pre = f"cm{self._uid}/c{id(meta)}"
        meta["k_stencil"] = _tbl.register(pre + "/stencil", meta["stencil"])
        meta["k_diag_facek"] = _tbl.register(pre + "/dfk", d_facek[:, 0])
        meta["k_diag_sign"] = _tbl.register(pre + "/dsg",
                                            d_sign[:, 0].astype(np.int8))
        meta["k_off_facek"] = _tbl.register(pre + "/ofk", o_facek)
        meta["k_off_sign"] = _tbl.register(pre + "/osg",
                                           o_sign.astype(np.int8))
        # residual half-face table (the reference's half_face_map,
        # src/domains.jl:101): built from plus/minus directly — the jacobian
        # diagonal entries would multi-count faces for wide (K>2) stencils
        # where a row appears at several stencil positions.
        hf_rows = np.concatenate([plus, minus]).astype(np.int64)
        hf_face = np.concatenate([np.arange(nf), np.arange(nf)])
        hf_sign = np.concatenate([np.ones(nf), -np.ones(nf)])
        order = np.argsort(hf_rows, kind="stable")
        rr, ff, ss = hf_rows[order], hf_face[order], hf_sign[order]
        starts = np.searchsorted(rr, rr)
        rank = np.arange(rr.shape[0]) - starts
        Pr = int(rank.max()) + 1 if rank.size else 1
        r_face = np.zeros((n, Pr), dtype=np.int32)
        r_sign = np.zeros((n, Pr))
        r_face[rr, rank] = ff.astype(np.int32)
        r_sign[rr, rank] = ss
        meta["k_r_face"] = _tbl.register(pre + "/rf", r_face)
        meta["k_r_sign"] = _tbl.register(pre + "/rs", r_sign.astype(np.int8))

    # ------------------------------------------------------------------
    # state helpers
    # ------------------------------------------------------------------
    def evaluate_secondaries(self, state: dict) -> dict:
        """Global secondary-variable sweep in topological order
        (reference: update_secondary_variables!, variable_evaluation.jl:87)."""
        model = self.model
        state = dict(state)
        for name in self.secondary_order:
            var = model.secondary_variables[name]
            deps = {d: state[d] for d in var.dependencies}
            state[name] = var.evaluate(model, **deps)
        return state

    def _eval_secondaries_local(self, local: dict) -> dict:
        """Same chain on a local (gathered) state dict; elementwise contract
        makes this valid for any batch shape."""
        model = self.model
        local = dict(local)
        for name in self.secondary_order:
            var = model.secondary_variables[name]
            deps = {d: local[d] for d in var.dependencies}
            local[name] = var.evaluate(model, **deps)
        return local

    def _cell_entries(self, state: dict, include=("primary", "secondary",
                                                  "parameter", "extra")) -> dict:
        """Subset of state living on the row entity (Cells usually)."""
        model = self.model
        out = {}
        for name, val in state.items():
            ent = self.cell_entry_entity.get(name)
            if ent is None:
                continue  # unknown extra entries are ignored in local views
            if ent == self.row_entity:
                kind = (
                    "primary" if name in model.primary_variables
                    else "secondary" if name in model.secondary_variables
                    else "parameter"
                )
                if kind in include:
                    out[name] = val
        return out

    def _face_entries(self, state: dict) -> dict:
        """Coupling-entity entries (Faces params for cell-row models)."""
        out = {}
        if self.coupling_entity is None:
            return out
        for name, val in state.items():
            if self.cell_entry_entity.get(name) == self.coupling_entity:
                out[name] = val
        return out

    def get_dofs(self, state: dict):
        """(n_cells, ndof) packed primary dof matrix."""
        parts = []
        for name in self.layout.names:
            var = self.model.primary_variables[name]
            parts.append(jnp.asarray(var.pack(jnp.asarray(state[name]))))
        return jnp.concatenate(parts, axis=-1)

    def unpack_dofs(self, U) -> dict:
        """U (..., ndof) -> dict of primary variable values."""
        out = {}
        for name in self.layout.names:
            var = self.model.primary_variables[name]
            sl = self.layout.slices[name]
            out[name] = var.unpack(U[..., sl])
        return out

    def apply_update(self, state: dict, du, relaxation=1.0) -> dict:
        """Newton update of primaries with per-variable clamping
        (reference: update_primary_variables!, models.jl:928)."""
        state = dict(state)
        for name in self.layout.names:
            var = self.model.primary_variables[name]
            sl = self.layout.slices[name]
            state[name] = var.update(state[name], du[..., sl], relaxation,
                                     self.model)
        return state

    # ------------------------------------------------------------------
    # residual
    # ------------------------------------------------------------------
    def residual(self, state: dict, state0: dict, dt, forces=None):
        """(n_cells, neq_total) residual. States must already contain
        secondary variables (call evaluate_secondaries first or use
        assemble()).

        Assembly is 100% gather-based: per-face fluxes are computed once,
        then each cell row SUMS its incident faces via the precomputed
        half-face tables (meta['r_face']/['r_sign']) — no scatter-adds in
        the hot path.
        """
        model = self.model
        n = self.n_cells
        cell_state = self._cell_entries(state)
        cell_state0 = self._cell_entries(state0)
        face_state = self._face_entries(state)

        per_eq: dict[str, list] = {info.name: [] for info in self.equations}
        for info, con, meta in self.contribs:
            if isinstance(con, (AccumulationContribution, CellTermContribution)):
                fn = lambda cs, cs0, _con=con: _con.fn(model, cs, cs0, dt)
                vals = jax.vmap(fn)(cell_state, cell_state0)  # (n, neq)
                per_eq[info.name].append(vals)
            elif isinstance(con, FaceFluxContribution):
                st = _tbl.table(meta["k_stencil"])
                local = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[st],
                                               cell_state)
                fs = jax.tree_util.tree_map(lambda a: jnp.asarray(a), face_state)
                fn = lambda cs, f, _con=con: _con.fn(model, cs, f)
                flux = jax.vmap(fn)(local, fs)  # (nf, neq)
                rf = _tbl.table(meta["k_r_face"])
                rs = jnp.asarray(_tbl.table(meta["k_r_sign"]), flux.dtype)
                gf = flux[rf.reshape(-1)].reshape(
                    rf.shape + flux.shape[1:])  # (n, Pd, neq)
                vals = jnp.sum(gf * rs[..., None], axis=1)
                per_eq[info.name].append(vals)
            else:
                raise TypeError(f"Unknown contribution {type(con)}")

        pieces = []
        for info in self.equations:
            parts = per_eq[info.name]
            tot = parts[0]
            for p in parts[1:]:
                tot = tot + p
            pieces.append(tot)
        r = jnp.concatenate(pieces, axis=-1) if len(pieces) > 1 else pieces[0]
        if forces:
            r = self._apply_forces(r, state, dt, forces)
        return r

    def _apply_forces(self, r, state, dt, forces):
        for info in self.equations:
            sl = info.row_slice
            r_eq = r[:, sl]
            for fv in forces.values():
                for force in _as_force_list(fv):
                    r_eq = force.apply(self.model, info.eq, info.name, r_eq,
                                       state, dt)
            r = r.at[:, sl].set(r_eq)
        return r

    # ------------------------------------------------------------------
    # Jacobian
    # ------------------------------------------------------------------
    def _flat_block_index(self, rows, slots, row_slice: slice):
        """Flat indices into blocks.reshape(-1) for updates of shape
        (m, n_eq_local, ndof) at (rows, slots, row_slice, :).

        All Jacobian scatters go through FLAT 1D index space, so the
        (n, S, neq, ndof) operand's tiny trailing block dims never shape
        the scatter. Counterpart of the reference's linear nzval indices
        (jacobian_positions, ad/ad.jl:103).
        """
        S, neqT, ndof = self.ell.n_slots, self.neq_total, self.ndof
        eqs = np.arange(row_slice.start, row_slice.stop)
        base = (np.asarray(rows, dtype=np.int64) * S
                + np.asarray(slots, dtype=np.int64)) * (neqT * ndof)
        idx = (base[:, None, None] + eqs[:, None] * ndof
               + np.arange(ndof)[None, :])
        return idx.reshape(-1)

    def jacobian_blocks(self, state: dict, state0: dict, dt, forces=None):
        """BlockELL blocks (n, S, neq_total, ndof) — the vmap(jacfwd)
        counterpart of fill_equation_entries! (reference ad/generic.jl:53).

        Pure gather-based: per-face jacfwd blocks are gathered into their
        (row, slot) destinations via the precomputed tables (the inverse of
        the reference's injective scatter alignment, ad/ad.jl:107) — no
        scatter-adds, no layout-constrained operands.
        """
        model = self.model
        n, S = self.n_cells, self.ell.n_slots
        ndof = self.ndof

        params_cell = self._cell_entries(state, include=("parameter", "extra"))
        cell_state0 = self._cell_entries(state0)
        face_state = self._face_entries(state)
        U_all = self.get_dofs(state)  # (n, ndof)

        # per equation: [diag parts (n, neq_e, ndof)], [off parts
        # (n, S-1, neq_e, ndof)]
        diag_eq: dict[str, list] = {i.name: [] for i in self.equations}
        off_eq: dict[str, list] = {i.name: [] for i in self.equations}

        for info, con, meta in self.contribs:
            neq_e = info.neq
            if isinstance(con, (AccumulationContribution, CellTermContribution)):
                def local_fn(u_c, p_c, cs0, _con=con):
                    local = dict(p_c)
                    local.update(self.unpack_dofs(u_c))
                    local = self._eval_secondaries_local(local)
                    return _con.fn(model, local, cs0, dt)

                jac = jax.vmap(jax.jacfwd(local_fn, argnums=0))(
                    U_all, params_cell, cell_state0
                )  # (n, neq, ndof)
                diag_eq[info.name].append(jac)
            elif isinstance(con, FaceFluxContribution):
                st = _tbl.table(meta["k_stencil"])
                p_st = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[st],
                                              params_cell)  # (nf, K, ...)
                U_st = U_all[st]  # (nf, K, ndof)

                def flux_fn(U, p, f, _con=con):
                    local = dict(p)
                    local.update(self.unpack_dofs(U))
                    local = self._eval_secondaries_local(local)
                    return _con.fn(model, local, f)

                jac = jax.vmap(jax.jacfwd(flux_fn, argnums=0))(
                    U_st, p_st, face_state
                )  # (nf, neq, K, ndof)
                K = meta["K"]
                # flat storage indexed by face*K + k
                jac_fk = jnp.swapaxes(jac, 1, 2).reshape(
                    st.shape[0] * K, neq_e * ndof)
                dfk = _tbl.table(meta["k_diag_facek"])  # (n, Pd)
                dsg = jnp.asarray(_tbl.table(meta["k_diag_sign"]),
                                  jac_fk.dtype)
                dpart = jac_fk[dfk.reshape(-1)].reshape(
                    dfk.shape + (neq_e, ndof))
                diag_eq[info.name].append(
                    jnp.sum(dpart * dsg[..., None, None], axis=1))
                ofk = _tbl.table(meta["k_off_facek"])  # (n, S-1, Po)
                osg = jnp.asarray(_tbl.table(meta["k_off_sign"]),
                                  jac_fk.dtype)
                opart = jac_fk[ofk.reshape(-1)].reshape(
                    ofk.shape + (neq_e, ndof))
                off_eq[info.name].append(
                    jnp.sum(opart * osg[..., None, None], axis=2))

        def _sum(parts, zero_shape):
            if not parts:
                # match the working dtype — a default-dtype zeros block here
                # would promote the whole Jacobian to f64 under x64
                return jnp.zeros(zero_shape, U_all.dtype)
            tot = parts[0]
            for p in parts[1:]:
                tot = tot + p
            return tot

        diag_all = jnp.concatenate(
            [_sum(diag_eq[i.name], (n, i.neq, ndof)) for i in self.equations],
            axis=1) if len(self.equations) > 1 else _sum(
                diag_eq[self.equations[0].name],
                (n, self.neq_total, ndof))
        off_all = jnp.concatenate(
            [_sum(off_eq[i.name], (n, S - 1, i.neq, ndof))
             for i in self.equations], axis=2) if len(self.equations) > 1 \
            else _sum(off_eq[self.equations[0].name],
                      (n, S - 1, self.neq_total, ndof))
        blocks = jnp.concatenate([diag_all[:, None], off_all], axis=1)
        if forces:
            blocks = self._apply_force_jacobians(blocks, state, dt, forces)
        return blocks

    def _apply_force_jacobians(self, blocks, state, dt, forces):
        for info in self.equations:
            sl = info.row_slice
            for fv in forces.values():
                for force in _as_force_list(fv):
                    contrib = force.diagonal_jacobian(
                        self.model, info.eq, info.name, self, state, dt
                    )
                    if contrib is None:
                        continue
                    cells, jac = contrib  # (ns,), (ns, neq, ndof)
                    blocks = blocks.at[cells, 0, sl, :].add(jac)
        return blocks

    # ------------------------------------------------------------------
    # combined assemble + convergence
    # ------------------------------------------------------------------
    def assemble(self, state: dict, state0: dict, dt, forces=None,
                 with_jacobian: bool = True):
        state = self.evaluate_secondaries(state)
        state0 = self.evaluate_secondaries(state0)
        r = self.residual(state, state0, dt, forces)
        if not with_jacobian:
            return r, None, state
        blocks = self.jacobian_blocks(state, state0, dt, forces)
        return r, BlockELL(self.ell, blocks), state

    def convergence(self, r, state, dt) -> dict:
        """Nested dict eq_name -> criterion -> (neq,) errors
        (reference: check_convergence, models.jl:818)."""
        out = {}
        for info in self.equations:
            out[info.name] = info.eq.convergence_criterion(
                self.model, info.name, r[:, info.row_slice], state, dt
            )
        return out


def _as_force_list(fv):
    if fv is None:
        return ()
    if isinstance(fv, (list, tuple)):
        return fv
    return (fv,)


def compile_model(model) -> CompiledModel:
    from .mixed import MixedCompiledModel, is_mixed_entity

    if is_mixed_entity(model):
        # per-equation entities in one model (reference equations.jl:
        # 328-434): compiled as per-entity views + cross-entity coupling
        # blocks (ops/mixed.py)
        return MixedCompiledModel(model)
    return CompiledModel(model)
