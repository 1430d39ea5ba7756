"""MultiModel: coupled submodels with cross-terms.

Counterpart of the reference multimodel layer (reference:
src/multimodel/model.jl:91-616 ``MultiModel``; src/multimodel/crossterm.jl
:3-660 ``CrossTerm``/``AdditiveCrossTerm``/``CTSkewSymmetry`` +
``add_cross_term!``; linear system coupling src/linsolve/multimodel.jl).

JAX-native design: a MultiModel is a dict of SimulationModels plus a list of
cross-term pairs with STATIC connection index arrays. Assembly compiles to:
per-model BlockELL diagonal systems (the same vmap/jacfwd engine) plus
coupling blocks — vmapped jacfwd of the cross-term local function over the
connection list, scattered into (a) the target model's diagonal ELL (w.r.t.
target dofs) and (b) dense COO coupling blocks (w.r.t. source dofs). The
whole coupled system solves as one Krylov space over the concatenated dof
vector (reference's single-sparse-matrix path); Schur group reduction is
layered on top (linsolve/multimodel.jl:17 counterpart in linsolve/schur.py).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..models.setup import merge_state, setup_parameters, setup_state
from ..ops.assembly import CompiledModel, compile_model
from ..ops.blockell import BlockELL, ell_to_dense


class CrossTerm:
    """Base cross-term (reference crossterm.jl:3).

    Subclasses implement ``value(model_t, model_s, local_t, local_s, dt)``
    -> (neq,) for ONE connection; entries of ``local_t``/``local_s`` are the
    states gathered at the connection's target/source cell. ``symmetric``
    marks CTSkewSymmetry: the negated value is added to the source model's
    same-named equation.

    A cross term may carry static per-connection data (reference
    crossterm.jl stores e.g. well-perforation WI in the struct): set
    ``self.conn_data = {name: (m, ...) array}`` and accept a sixth
    argument, ``value(..., dt, conn)``, where ``conn[name]`` is that
    connection's slice.
    """

    symmetric: bool = False
    conn_data: "dict | None" = None

    def value(self, model_t, model_s, local_t, local_s, dt):
        raise NotImplementedError


class AdditiveCrossTerm(CrossTerm):
    pass


@dataclass
class CrossTermPair:
    """reference core_types.jl:1071-1085 CrossTermPair."""

    target: str
    source: str
    equation: str
    cross_term: CrossTerm
    target_cells: np.ndarray
    source_cells: np.ndarray


class MultiModel:
    """Named submodels + cross terms (reference core_types.jl:1098)."""

    def __init__(self, models: dict, groups=None, context=None,
                 reduction=None):
        self.models: "OrderedDict[str, Any]" = OrderedDict(models)
        self.cross_terms: list[CrossTermPair] = []
        self.groups = groups
        self.reduction = reduction

    def __getitem__(self, name: str):
        return self.models[name]

    def add_cross_term(self, cross_term: CrossTerm, target: str, source: str,
                       equation: str, target_cells=None, source_cells=None):
        """reference add_cross_term! (multimodel/crossterm.jl)."""
        if target not in self.models or source not in self.models:
            raise KeyError(f"unknown model in ({target!r}, {source!r})")
        if equation not in self.models[target].equations:
            raise KeyError(f"{target!r} has no equation {equation!r}")
        tc = np.atleast_1d(np.asarray(
            target_cells if target_cells is not None else [0], dtype=np.int32))
        sc = np.atleast_1d(np.asarray(
            source_cells if source_cells is not None else [0], dtype=np.int32))
        if tc.shape != sc.shape:
            raise ValueError("target_cells and source_cells must align")
        self.cross_terms.append(
            CrossTermPair(target, source, equation, cross_term, tc, sc))

    # --- setup ---------------------------------------------------------
    def setup_state(self, **per_model) -> dict:
        return {name: per_model.get(name, setup_state(m))
                for name, m in self.models.items()}

    def setup_parameters(self, **per_model) -> dict:
        return {name: per_model.get(name, setup_parameters(m))
                for name, m in self.models.items()}

    def setup_forces(self, **per_model) -> dict:
        return {name: per_model.get(name) for name in self.models}

    def __repr__(self) -> str:  # pragma: no cover
        return f"MultiModel({list(self.models)}, {len(self.cross_terms)} cross-terms)"


@dataclass
class CouplingBlock:
    """Off-diagonal COO coupling (reference LinearizedBlock,
    linsolve/default.jl:44)."""

    target: str
    source: str
    rows: np.ndarray  # target cells (m,)
    cols: np.ndarray  # source cells (m,)
    blocks: Any  # (m, neq_t, ndof_s)


class MultiLinearizedSystem:
    """Coupled system: per-model BlockELL + coupling blocks
    (reference MultiLinearizedSystem, linsolve/default.jl:70)."""

    def __init__(self, diag: dict, couplings: list[CouplingBlock],
                 layout: "MultiLayout"):
        self.diag = diag
        self.couplings = couplings
        self.layout = layout

    def matvec(self, x: dict) -> dict:
        y = {name: J.matvec(x[name]) for name, J in self.diag.items()}
        for cb in self.couplings:
            contrib = jnp.sum(cb.blocks * x[cb.source][cb.cols][:, None, :],
                              axis=-1)  # (m, neq_t)
            y[cb.target] = y[cb.target].at[cb.rows].add(contrib)
        return y

    # --- flat vector interface (for Krylov / direct) -------------------
    def flatten(self, d: dict, widths: dict) -> jnp.ndarray:
        return jnp.concatenate([d[n].reshape(-1) for n in self.layout.names])

    def flatten_res(self, d: dict) -> jnp.ndarray:
        return jnp.concatenate([d[n].reshape(-1) for n in self.layout.names])

    def unflatten_dofs(self, v) -> dict:
        out = {}
        for n in self.layout.names:
            sl, shape = self.layout.dof_slices[n]
            out[n] = v[sl].reshape(shape)
        return out

    def unflatten_res(self, v) -> dict:
        out = {}
        for n in self.layout.names:
            sl, shape = self.layout.res_slices[n]
            out[n] = v[sl].reshape(shape)
        return out

    def matvec_flat(self, v):
        x = self.unflatten_dofs(v)
        return self.flatten_res(self.matvec(x))

    def to_dense(self):
        lay = self.layout
        N = lay.total_res
        M = lay.total_dof
        out = jnp.zeros((N, M))
        for n, J in self.diag.items():
            d = ell_to_dense(J.blocks, J.structure.cols)
            r0 = lay.res_slices[n][0].start
            c0 = lay.dof_slices[n][0].start
            out = out.at[r0:r0 + d.shape[0], c0:c0 + d.shape[1]].set(d)
        for cb in self.couplings:
            m, neq_t, ndof_s = cb.blocks.shape
            r0 = self.layout.res_slices[cb.target][0].start
            c0 = self.layout.dof_slices[cb.source][0].start
            # rows/cols may be traced (pytree children inside jit)
            rr = r0 + jnp.asarray(cb.rows) * neq_t
            cc = c0 + jnp.asarray(cb.cols) * ndof_s
            flat = ((rr[:, None, None]
                     + jnp.arange(neq_t)[None, :, None]) * M
                    + cc[:, None, None]
                    + jnp.arange(ndof_s)[None, None, :]).reshape(-1)
            out = out.reshape(-1).at[flat].add(
                cb.blocks.reshape(-1)).reshape(N, M)
        return out


@dataclass(eq=False)  # identity eq/hash: one instance per
# CompiledMultiModel, and pytree aux_data must be hashable when a
# MultiLinearizedSystem crosses a jit boundary as an argument (ADVICE r2)
class MultiLayout:
    names: list
    dof_slices: dict  # name -> (slice into flat dof vec, (n, ndof))
    res_slices: dict  # name -> (slice into flat res vec, (n, neq))
    total_dof: int
    total_res: int


# Pytrees: the coupled Jacobian can ride lax.while_loop carries (the
# fully-jitted multimodel Newton). CouplingBlock's rows/cols are traced
# children (index arrays); names are static aux. MultiLinearizedSystem's
# layout is static aux (one instance per CompiledMultiModel).
jax.tree_util.register_pytree_node(
    CouplingBlock,
    lambda b: ((b.blocks, b.rows, b.cols), (b.target, b.source)),
    lambda aux, ch: CouplingBlock(aux[0], aux[1], ch[1], ch[2], ch[0]),
)
jax.tree_util.register_pytree_node(
    MultiLinearizedSystem,
    lambda m: ((m.diag, m.couplings), m.layout),
    lambda layout, ch: MultiLinearizedSystem(ch[0], list(ch[1]), layout),
)



def add_cross_term(model: "MultiModel", cross_term: CrossTerm, target: str,
                   source: str, equation: str, target_cells=None,
                   source_cells=None):
    """Free-function form of ``MultiModel.add_cross_term`` (the
    reference's exported ``add_cross_term!``, multimodel/crossterm.jl)."""
    model.add_cross_term(cross_term, target, source, equation,
                         target_cells=target_cells,
                         source_cells=source_cells)


class CompiledMultiModel:
    """Assembly engine for MultiModel — same interface as CompiledModel so
    the Simulator drives both."""

    is_multi = True

    def __init__(self, mm: MultiModel):
        self.mm = mm
        self.comps: "OrderedDict[str, CompiledModel]" = OrderedDict(
            (name, compile_model(m)) for name, m in mm.models.items())
        names = list(mm.models)
        dof_slices, res_slices = {}, {}
        od = orr = 0
        for n, c in self.comps.items():
            nd = c.n_cells * c.ndof
            nr = c.n_cells * c.neq_total
            dof_slices[n] = (slice(od, od + nd), (c.n_cells, c.ndof))
            res_slices[n] = (slice(orr, orr + nr), (c.n_cells, c.neq_total))
            od += nd
            orr += nr
        self.layout = MultiLayout(names, dof_slices, res_slices, od, orr)

        # equations view for tolerance lookup: "model.eq" names
        self.equations = []
        for n, c in self.comps.items():
            for info in c.equations:
                self.equations.append(_NamedEq(f"{n}.{info.name}", info.eq))

    # ------------------------------------------------------------------
    def evaluate_secondaries(self, state: dict) -> dict:
        return {n: self.comps[n].evaluate_secondaries(state[n])
                for n in self.comps}

    def get_dofs(self, state: dict) -> dict:
        return {n: self.comps[n].get_dofs(state[n]) for n in self.comps}

    def apply_update(self, state: dict, du: dict, relaxation=1.0) -> dict:
        return {n: self.comps[n].apply_update(state[n], du[n], relaxation)
                for n in self.comps}

    # ------------------------------------------------------------------
    def _cross_term_values(self, pair: CrossTermPair, full: dict,
                           full0: dict, dt):
        mm = self.mm
        ct = pair.cross_term
        t, s = pair.target, pair.source
        lt = {k: jnp.asarray(v)[pair.target_cells] for k, v in full[t].items()
              if self.comps[t].cell_entry_entity.get(k) is not None
              and np.ndim(v) >= 1
              and np.shape(v)[0] == self.comps[t].n_cells}
        ls = {k: jnp.asarray(v)[pair.source_cells] for k, v in full[s].items()
              if self.comps[s].cell_entry_entity.get(k) is not None
              and np.ndim(v) >= 1
              and np.shape(v)[0] == self.comps[s].n_cells}
        cd = getattr(ct, "conn_data", None)
        if cd:
            cdj = {k: jnp.asarray(v) for k, v in cd.items()}
            fn = lambda a, b, c: ct.value(mm.models[t], mm.models[s],
                                          a, b, dt, c)
            return jax.vmap(fn)(lt, ls, cdj)  # (m, neq)
        fn = lambda a, b: ct.value(mm.models[t], mm.models[s], a, b, dt)
        return jax.vmap(fn)(lt, ls)  # (m, neq)

    def residual(self, full: dict, full0: dict, dt, forces=None):
        r = {}
        for n, c in self.comps.items():
            f = (forces or {}).get(n) if forces else None
            r[n] = c.residual(full[n], full0[n], dt, f)
        for pair in self.mm.cross_terms:
            vals = self._cross_term_values(pair, full, full0, dt)
            sl = self._eq_slice(pair.target, pair.equation)
            r[pair.target] = r[pair.target].at[pair.target_cells, sl].add(vals)
            if pair.cross_term.symmetric:
                sl_s = self._eq_slice(pair.source, pair.equation)
                r[pair.source] = r[pair.source].at[
                    pair.source_cells, sl_s].add(-vals)
        return r

    def _eq_slice(self, model_name, eq_name):
        for info in self.comps[model_name].equations:
            if info.name == eq_name:
                return info.row_slice
        raise KeyError(eq_name)

    def assemble(self, full: dict, full0: dict, dt, forces=None,
                 with_jacobian: bool = True):
        full = self.evaluate_secondaries(full)
        full0 = self.evaluate_secondaries(full0)
        r = self.residual(full, full0, dt, forces)
        if not with_jacobian:
            return r, None, full
        diag = {}
        for n, c in self.comps.items():
            f = (forces or {}).get(n) if forces else None
            diag[n] = BlockELL(c.ell, c.jacobian_blocks(full[n], full0[n],
                                                        dt, f))
        couplings: list[CouplingBlock] = []
        for pair in self.mm.cross_terms:
            diag, cbs = self._cross_term_jacobian(pair, full, full0, dt, diag)
            couplings.extend(cbs)
        J = MultiLinearizedSystem(diag, couplings, self.layout)
        return r, J, full

    def _cross_term_jacobian(self, pair: CrossTermPair, full, full0, dt,
                             diag):
        mm = self.mm
        ct = pair.cross_term
        t, s = pair.target, pair.source
        ct_c, cs_c = self.comps[t], self.comps[s]
        U_t = ct_c.get_dofs(full[t])[pair.target_cells]  # (m, ndof_t)
        U_s = cs_c.get_dofs(full[s])[pair.source_cells]
        p_t = {k: jnp.asarray(v)[pair.target_cells]
               for k, v in ct_c._cell_entries(full[t],
                                              include=("parameter", "extra")
                                              ).items()}
        p_s = {k: jnp.asarray(v)[pair.source_cells]
               for k, v in cs_c._cell_entries(full[s],
                                              include=("parameter", "extra")
                                              ).items()}

        cd = getattr(ct, "conn_data", None)
        cdj = ({k: jnp.asarray(v) for k, v in cd.items()} if cd else None)

        def local(u_t, u_s, pt, ps, conn):
            lt = dict(pt)
            lt.update(ct_c.unpack_dofs(u_t))
            lt = ct_c._eval_secondaries_local(lt)
            ls = dict(ps)
            ls.update(cs_c.unpack_dofs(u_s))
            ls = cs_c._eval_secondaries_local(ls)
            if conn is not None:
                return ct.value(mm.models[t], mm.models[s], lt, ls, dt, conn)
            return ct.value(mm.models[t], mm.models[s], lt, ls, dt)

        jac_t, jac_s = jax.vmap(
            jax.jacfwd(local, argnums=(0, 1)),
            in_axes=(0, 0, 0, 0, 0 if cdj is not None else None))(
            U_t, U_s, p_t, p_s, cdj)  # (m, neq, ndof_t), (m, neq, ndof_s)

        sl = self._eq_slice(t, pair.equation)
        # d value / d u_target -> target diagonal (t_cell, t_cell)
        bt = diag[t].blocks.at[pair.target_cells, 0, sl, :].add(jac_t)
        diag[t] = BlockELL(diag[t].structure, bt)
        cbs = [CouplingBlock(t, s, pair.target_cells, pair.source_cells,
                             jac_s)]
        if ct.symmetric:
            sl_s = self._eq_slice(s, pair.equation)
            bs = diag[s].blocks.at[pair.source_cells, 0, sl_s, :].add(-jac_s)
            diag[s] = BlockELL(diag[s].structure, bs)
            cbs.append(CouplingBlock(s, t, pair.source_cells,
                                     pair.target_cells, -jac_t))
        return diag, cbs

    def convergence(self, r: dict, full: dict, dt) -> dict:
        out = {}
        for n, c in self.comps.items():
            sub = c.convergence(r[n], full[n], dt)
            for eq, crits in sub.items():
                out[f"{n}.{eq}"] = crits
        return out


class _NamedEq:
    def __init__(self, name, eq):
        self.name = name
        self.eq = eq


def compile_multi_model(mm: MultiModel) -> CompiledMultiModel:
    return CompiledMultiModel(mm)
