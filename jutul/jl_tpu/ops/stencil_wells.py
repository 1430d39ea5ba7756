"""Bordered stencil fast path: lattice reservoir + well-model border.

Wells as real MODELS in the structured fast path (VERDICT r3 item 2).
The augmented-graph well formulation (models/wells.py ``WellGraphMesh``:
one wellbore storage cell per well, perforations as extra faces whose
TPFA upwind flux with trans=WI IS the Peaceman inflow) breaks the pure
Cartesian lattice that ``StencilCompiledModel`` requires. This module
restores the fast path by assembling the coupled system in BORDERED
form:

    [ A_rr  A_rw ] [du_r]   [-r_r]      A_rr: 7-point StencilMatrix
    [ A_wr  A_ww ] [du_w] = [-r_w]      A_ww: (nw, neq, ndof) block diag
                                        A_rw/A_wr: one block per perforation

and solving by Schur elimination of the (tiny) well block: the Krylov
space sees only S = A_rr − A_rw A_ww⁻¹ A_wr — the lattice operator plus
a rank-(nw·ndof) correction — preconditioned by the SAME CPR(GMG) stack
as the well-free flagship; du_w back-substitutes exactly. This is the
counterpart of the reference's well treatment: wells are models
coupled through cross-terms (reference src/multimodel/crossterm.jl:3-660)
and the linear system eliminates well blocks via Schur
(src/linsolve/multimodel.jl:17 MultiLinearizedSystem reduction), while
the reservoir block keeps its specialized TPFA storage
(src/conservation/conservation.jl:101-484).

Controls stay forces on the wellbore cell exactly as in models/wells.py:
rate control = PhaseSourceTerm (surface mass stream), BHP control =
PressureBoundaryCondition (fixed-pressure connection with a control
transmissibility, contributing its dq/du to A_ww).

The transpose of a bordered matrix is bordered (lattice transpose +
swapped/transposed border blocks), so the adjoint's lambda-solves ride
this same path (see ``bordered_transpose``; reference runs the
adjoint-layout system through the forward solver stack,
ad/gradients.jl:168-224).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .smallmat import block_inv

# Default einsum/dot precision may round float32 inputs to a shorter
# mantissa (TF32 on the GPU): on the one-hot contractions that rounds the
# gathered perforation dofs and Jacobian blocks to ~3 digits and degrades
# Newton to quasi-Newton. Every contraction on this path carries full
# working precision.
_PREC = jax.lax.Precision.HIGHEST
from .stencil import StencilCompiledModel, StencilMatrix, stencil_transpose


@dataclass
class BorderedStencilMatrix:
    """StencilMatrix + well border: rows/cols nc..nc+nw-1 are wellbores.

    ``perf_cell``/``perf_well`` give each perforation's reservoir cell
    (0..nc-1) and well index (0..nw-1); ``J_rb[p]`` is the reservoir-row/
    well-column block, ``J_br[p]`` the well-row/reservoir-column block,
    ``D_ww[w]`` the wellbore diagonal block. The perforations'
    reservoir-diagonal contributions live inside ``A.diag`` already.
    """

    A: StencilMatrix
    perf_cell: np.ndarray  # (np,) static
    perf_well: np.ndarray  # (np,) static
    J_rb: jnp.ndarray  # (np, neq, ndof)
    J_br: jnp.ndarray  # (np, neq, ndof)
    D_ww: jnp.ndarray  # (nw, neq, ndof)

    @property
    def n(self) -> int:
        return self.A.n + self.D_ww.shape[0]

    def matvec(self, x):
        """x (nc+nw, ndof) -> (nc+nw, neq)."""
        nc = self.A.n
        xr, xw = x[:nc], x[nc:]
        yr = self.A.matvec(xr)
        yr = yr.at[self.perf_cell].add(
            jnp.einsum("pij,pj->pi", self.J_rb, xw[self.perf_well], precision=_PREC))
        yw = jnp.einsum("wij,wj->wi", self.D_ww, xw, precision=_PREC)
        yw = yw.at[self.perf_well].add(
            jnp.einsum("pij,pj->pi", self.J_br, xr[self.perf_cell], precision=_PREC))
        return jnp.concatenate([yr, yw], axis=0)


jax.tree_util.register_pytree_node(
    BorderedStencilMatrix,
    lambda m: ((m.A, m.J_rb, m.J_br, m.D_ww),
               (tuple(np.asarray(m.perf_cell).tolist()),
                tuple(np.asarray(m.perf_well).tolist()))),
    lambda aux, ch: BorderedStencilMatrix(
        ch[0], np.asarray(aux[0], dtype=np.int64),
        np.asarray(aux[1], dtype=np.int64), ch[1], ch[2], ch[3]),
)


def bordered_transpose(B: BorderedStencilMatrix) -> BorderedStencilMatrix:
    """B^T is bordered with the same sparsity: lattice transposed, the
    border blocks swapped and block-transposed."""
    swapT = lambda v: jnp.swapaxes(v, -1, -2)
    return BorderedStencilMatrix(
        stencil_transpose(B.A), B.perf_cell, B.perf_well,
        J_rb=swapT(B.J_br), J_br=swapT(B.J_rb), D_ww=swapT(B.D_ww))


def _perf_onehot(nc, perf_cell, dtype):
    """(nc, np) one-hot selector generated from iota comparisons —
    never an indexed gather/scatter, so scatter-adds expressed through
    it (``einsum('np,p...->n...')``) impose NO layout on the big
    operand (see _onehot_correction). ``perf_cell`` may be concrete or
    traced (the bordered matrix is assembled inside jit on the
    whole-schedule path)."""
    cells = jnp.asarray(perf_cell).astype(jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (nc, cells.shape[0]), 0)
    return (rows == cells[None, :]).astype(dtype)


class _DomainView:
    def __init__(self, domain, mesh):
        self._domain = domain
        self.mesh = mesh

    def __getattr__(self, k):
        return getattr(self._domain, k)


class _BaseModelView:
    """The full WellGraphMesh model with ``domain.mesh`` replaced by the
    base CartesianMesh (only the lattice dims are read through it)."""

    def __init__(self, model, base_mesh):
        self._model = model
        self.domain = _DomainView(model.domain, base_mesh)

    def __getattr__(self, k):
        return getattr(self._model, k)


class _LatticeView:
    """Reservoir-lattice view of a WellGraphMesh CompiledModel: same
    physics/variables, ``n_cells`` = base lattice cells, base mesh dims.
    All states fed through it must be PRE-SLICED to the lattice
    (``BorderedStencilModel._split_state``)."""

    def __init__(self, comp, base_mesh, nc):
        self._comp = comp
        self.n_cells = nc
        self.model = _BaseModelView(comp.model, base_mesh)

    def __getattr__(self, k):
        return getattr(self._comp, k)


class BorderedStencilModel:
    """Structured fast path over a CompiledModel on a WellGraphMesh:
    lattice interior via StencilCompiledModel, wellbores + perforations
    as a dense border.

    Drop-in for StencilCompiledModel in the Simulator/adjoint engines —
    ``assemble`` returns a BorderedStencilMatrix which
    ``StencilKrylovSolver`` solves by Schur elimination of the wells.
    """

    def __init__(self, comp):
        from ..meshes.cartesian import CartesianMesh
        from ..models.wells import WellGraphMesh

        mesh = comp.model.domain.mesh
        if not isinstance(mesh, WellGraphMesh):
            raise TypeError("BorderedStencilModel requires a WellGraphMesh")
        if not isinstance(mesh.base, CartesianMesh):
            raise TypeError("WellGraphMesh base must be a CartesianMesh")
        self.comp = comp
        self.mesh = mesh
        self.nc = mesh._nc_base
        self.nw = len(mesh.wells)
        self.nf_base = mesh._nf_base
        perf = mesh._perf  # (np, 2): (reservoir cell, well cell) global
        self.perf_cell = perf[:, 0].astype(np.int64)
        self.perf_well = (perf[:, 1] - self.nc).astype(np.int64)
        self.lattice = StencilCompiledModel(
            _LatticeView(comp, mesh.base, self.nc))
        self.ndof = comp.ndof
        self.neq = comp.neq_total
        if self.lattice.flux_con is None:
            raise NotImplementedError("bordered path needs a flux term")

    @property
    def n_cells(self):
        return self.comp.n_cells  # nc + nw

    # -- state plumbing ---------------------------------------------------
    def _split_state(self, state):
        """(reservoir-sliced state, well-sliced state): cell entries split
        at nc, face entries at nf_base, everything else shared."""
        comp = self.comp
        res, well = {}, {}
        for k, v in state.items():
            ent = comp.cell_entry_entity.get(k)
            if ent == comp.row_entity:
                va = jnp.asarray(v)
                res[k] = va[:self.nc]
                well[k] = va[self.nc:]
            elif ent is not None and ent == comp.coupling_entity:
                va = jnp.asarray(v)
                res[k] = va[:self.nf_base]
                well[k] = va[self.nf_base:]
            else:
                res[k] = v
                well[k] = v
        return res, well

    def _perf_face_state(self, state):
        return {k: jnp.asarray(v)[self.nf_base:]
                for k, v in self.comp._face_entries(state).items()}

    # -- residual ---------------------------------------------------------
    def _perf_flux(self, cell_state, fs_perf):
        """(np, neq) perforation fluxes, positive = out of the reservoir
        cell (the TPFA upwind flux with trans=WI = Peaceman inflow)."""
        con = self.lattice.flux_con
        model = self.comp.model
        loc_l = {k: jnp.asarray(v)[self.perf_cell]
                 for k, v in cell_state.items()}
        loc_r = {k: jnp.asarray(v)[self.nc + self.perf_well]
                 for k, v in cell_state.items()}

        def flux2(l, r_, f):
            local = jax.tree_util.tree_map(
                lambda x, y: jnp.stack([x, y]), l, r_)
            return con.fn(model, local, f)

        return jax.vmap(flux2)(loc_l, loc_r, fs_perf)  # (np, neq)

    def residual(self, state, state0, dt, forces=None):
        """(nc+nw, neq); states must already carry secondaries."""
        comp = self.comp
        model = comp.model
        sr, _sw = self._split_state(state)
        sr0, _sw0 = self._split_state(state0)
        r_lat = self.lattice.residual(sr, sr0, dt)  # (nc, neq)

        cell_state = comp._cell_entries(state)  # full nc+nw rows
        cell_state0 = comp._cell_entries(state0)
        cw = {k: v[self.nc:] for k, v in cell_state.items()}
        cw0 = {k: v[self.nc:] for k, v in cell_state0.items()}
        r_w = jnp.zeros((self.nw, self.neq), r_lat.dtype)
        for con in self.lattice.acc_cons:
            fn = lambda cs, cs0, _c=con: _c.fn(model, cs, cs0, dt)
            r_w = r_w + jax.vmap(fn)(cw, cw0)

        F = self._perf_flux(cell_state, self._perf_face_state(state))
        oh = _perf_onehot(self.nc, self.perf_cell, r_lat.dtype)
        r_lat = r_lat + jnp.einsum("np,pi->ni", oh, F, precision=_PREC)
        r_w = r_w.at[self.perf_well].add(-F)
        r = jnp.concatenate([r_lat, r_w], axis=0)
        if forces:
            r = comp._apply_forces(r, state, dt, forces)
        return r

    # -- jacobian ---------------------------------------------------------
    def _border_jacobian(self, state, state0, dt, diag):
        """Perforation + wellbore blocks; returns (diag', J_rb, J_br,
        D_ww) with the perforations' reservoir-diagonal contribution
        added into ``diag`` ((neq, ndof, nc))."""
        comp = self.comp
        model = comp.model
        con = self.lattice.flux_con
        U = comp.get_dofs(state)  # (nc+nw, ndof)
        params_cell = comp._cell_entries(state,
                                         include=("parameter", "extra"))
        cs0 = comp._cell_entries(state0)
        fs_perf = self._perf_face_state(state)
        dtype = diag.dtype

        # wellbore accumulation diagonal
        Uw = U[self.nc:]
        pw = {k: jnp.asarray(v)[self.nc:] for k, v in params_cell.items()}
        cw0 = {k: v[self.nc:] for k, v in cs0.items()}
        D_ww = jnp.zeros((self.nw, self.neq, self.ndof), dtype)
        for acon in self.lattice.acc_cons:
            def acc_local(u, p, c0, _c=acon):
                local = dict(p)
                local.update(comp.unpack_dofs(u))
                local = comp._eval_secondaries_local(local)
                return _c.fn(model, local, c0, dt)

            D_ww = D_ww + jax.vmap(jax.jacfwd(acc_local, argnums=0))(
                Uw, pw, cw0)

        # perforation flux blocks
        p_l = {k: jnp.asarray(v)[self.perf_cell]
               for k, v in params_cell.items()}
        p_r = {k: jnp.asarray(v)[self.nc + self.perf_well]
               for k, v in params_cell.items()}

        def flux_local(u_l, u_r, pl, pr, f):
            ll = dict(pl)
            ll.update(comp.unpack_dofs(u_l))
            ll = comp._eval_secondaries_local(ll)
            rr = dict(pr)
            rr.update(comp.unpack_dofs(u_r))
            rr = comp._eval_secondaries_local(rr)
            local = jax.tree_util.tree_map(
                lambda x, y: jnp.stack([x, y]), ll, rr)
            return con.fn(model, local, f)

        JF_l, JF_r = jax.vmap(jax.jacfwd(flux_local, argnums=(0, 1)))(
            U[self.perf_cell], U[self.nc + self.perf_well], p_l, p_r,
            fs_perf)  # each (np, neq, ndof)
        JF_l = JF_l.astype(dtype)
        JF_r = JF_r.astype(dtype)

        # residual[res] += F, residual[well] -= F. The diag update goes
        # through the one-hot contraction: diag feeds EVERY Krylov matvec
        # and CPR update, so an indexed scatter here would propagate its
        # layout through the whole solve loop
        oh = _perf_onehot(self.nc, self.perf_cell, dtype)
        diag = diag + jnp.einsum("np,pij->ijn", oh, JF_l, precision=_PREC)
        J_rb = JF_r
        J_br = -JF_l
        D_ww = D_ww.at[self.perf_well].add(-JF_r)
        return diag, J_rb, J_br, D_ww

    def _apply_force_border(self, diag, D_ww, state, dt, forces):
        """Split state-dependent force Jacobians between the lattice
        diagonal and the well block by (static) cell index — the
        bordered counterpart of StencilCompiledModel._apply_force_diag."""
        from .assembly import _as_force_list

        comp = self.comp
        for info in comp.equations:
            sl = info.row_slice
            for fv in forces.values():
                for force in _as_force_list(fv):
                    fn = getattr(force, "diagonal_jacobian", None)
                    if fn is None:
                        continue
                    contrib = fn(comp.model, info.eq, info.name, comp,
                                 state, dt)
                    if contrib is None:
                        continue
                    cells, jac = contrib
                    cells = np.asarray(cells)
                    jac = jnp.asarray(jac, diag.dtype)
                    rm = cells < self.nc
                    if rm.any():
                        diag = diag.at[sl, :, jnp.asarray(cells[rm])].add(
                            jnp.moveaxis(jac[np.flatnonzero(rm)], 0, -1))
                    wm = ~rm
                    if wm.any():
                        D_ww = D_ww.at[
                            jnp.asarray(cells[wm] - self.nc), sl, :].add(
                            jac[np.flatnonzero(wm)])
        return diag, D_ww

    def jacobian(self, state, state0, dt, forces=None):
        sr, _ = self._split_state(state)
        sr0, _ = self._split_state(state0)
        A_lat = self.lattice.jacobian(sr, sr0, dt)
        diag, J_rb, J_br, D_ww = self._border_jacobian(
            state, state0, dt, A_lat.diag)
        if forces:
            diag, D_ww = self._apply_force_border(diag, D_ww, state, dt,
                                                  forces)
        A = StencilMatrix(A_lat.L, diag, A_lat.plus, A_lat.minus)
        return BorderedStencilMatrix(A, self.perf_cell, self.perf_well,
                                     J_rb, J_br, D_ww)

    # -- assemble ---------------------------------------------------------
    def assemble(self, state, state0, dt, forces=None):
        comp = self.comp
        state = comp.evaluate_secondaries(state)
        state0 = comp.evaluate_secondaries(state0)
        sr, _ = self._split_state(state)
        sr0, _ = self._split_state(state0)
        r_lat = self.lattice.residual(sr, sr0, dt)
        A_lat = self.lattice.jacobian(sr, sr0, dt)

        # border residual (well acc + perforation fluxes)
        model = comp.model
        cell_state = comp._cell_entries(state)
        cell_state0 = comp._cell_entries(state0)
        cw = {k: v[self.nc:] for k, v in cell_state.items()}
        cw0 = {k: v[self.nc:] for k, v in cell_state0.items()}
        r_w = jnp.zeros((self.nw, self.neq), r_lat.dtype)
        for con in self.lattice.acc_cons:
            fn = lambda cs, cs0, _c=con: _c.fn(model, cs, cs0, dt)
            r_w = r_w + jax.vmap(fn)(cw, cw0)
        F = self._perf_flux(cell_state, self._perf_face_state(state))
        oh = _perf_onehot(self.nc, self.perf_cell, r_lat.dtype)
        r_lat = r_lat + jnp.einsum("np,pi->ni", oh, F.astype(r_lat.dtype), precision=_PREC)
        r_w = r_w.at[self.perf_well].add(-F.astype(r_w.dtype))
        r = jnp.concatenate([r_lat, r_w], axis=0)

        diag, J_rb, J_br, D_ww = self._border_jacobian(
            state, state0, dt, A_lat.diag)
        if forces:
            r = comp._apply_forces(r, state, dt, forces)
            diag, D_ww = self._apply_force_border(diag, D_ww, state, dt,
                                                  forces)
        A = StencilMatrix(A_lat.L, diag, A_lat.plus, A_lat.minus)
        B = BorderedStencilMatrix(A, self.perf_cell, self.perf_well,
                                  J_rb, J_br, D_ww)
        return r, B, state


def _well_boxes(B: BorderedStencilMatrix):
    """Static per-well lattice boxes, or None.

    When every well's perforations form a contiguous VERTICAL COLUMN of
    lattice cells (same ix/iy, consecutive iz — the standard completion
    pattern), the per-matvec Schur correction can gather and scatter via
    static ``lax.slice``/``dynamic_update_slice`` on the 4-D lattice
    view instead of indexed gather/scatter ops: a few-row gather or
    scatter on the Krylov-carried vector inside the solve loop can
    constrain XLA's layout assignment for the whole V-cycle/matvec
    chain, while the box form leaves it alone, with identical
    numerics."""
    nzl, nyl, nxl = B.A.L
    pcell = np.asarray(B.perf_cell)
    pwell = np.asarray(B.perf_well)
    boxes = []
    for w in range(B.D_ww.shape[0]):
        idx = np.where(pwell == w)[0]
        if idx.size == 0:
            return None
        cells = pcell[idx]
        iz = cells // (nxl * nyl)
        rem = cells % (nxl * nyl)
        iy, ix = rem // nxl, rem % nxl
        if not ((ix == ix[0]).all() and (iy == iy[0]).all()):
            return None
        order = np.argsort(iz)
        if iz[order].size > 1 and not (np.diff(iz[order]) == 1).all():
            return None
        boxes.append((int(iz.min()), int(iz.max()) + 1, int(iy[0]),
                      int(ix[0]), idx[order]))
    return boxes


def _onehot_correction(B: BorderedStencilMatrix, Dinv):
    """Layout-NEUTRAL Schur correction: gather/scatter/reshape-free.

    The box-slice form avoids indexed ops, but its 4-D reshape +
    dynamic-update-slice chain on the Krylov-carried vector can still
    force relayouts at the flagship shape. This form touches the carry with NOTHING but elementwise ops
    and tiny contractions: a (nc, np) one-hot selector is generated
    in-register from iota comparisons (never materialized in HBM), the
    perforation gather is ``einsum('np,nj->pj', onehot, x)`` and the
    scatter-back is ``einsum('np,pi->ni', onehot, out)`` — exact (each
    row of onehot selects exactly one perforation cell), works for
    ARBITRARY completions (no column requirement), and imposes no
    layout on x or y."""
    nc = B.A.n
    nw = B.D_ww.shape[0]
    cells = jnp.asarray(np.asarray(B.perf_cell), jnp.int32)  # (np,)
    wells = np.asarray(B.perf_well)
    # (nw, np) well-membership matrix (tiny, static)
    Wmat = jnp.asarray((wells[None, :] == np.arange(nw)[:, None])
                       .astype(np.float64))

    def correction(xr):
        onehot = _perf_onehot(nc, cells, xr.dtype)  # (nc, np)
        seg = jnp.einsum("np,nj->pj", onehot, xr, precision=_PREC)  # perforation-cell dofs
        t = jnp.einsum("pij,pj->pi", B.J_br, seg, precision=_PREC)  # (np, neq)
        tw = Wmat.astype(xr.dtype) @ t  # (nw, neq) per-well sums
        yw = jnp.einsum("wij,wj->wi", Dinv, tw, precision=_PREC)  # (nw, ndof)
        out = jnp.einsum("pij,pj->pi", B.J_rb,
                         (Wmat.T.astype(xr.dtype) @ yw), precision=_PREC)  # (np, neq)
        return jnp.einsum("np,pi->ni", onehot, out, precision=_PREC)

    return correction


def schur_eliminate(B: BorderedStencilMatrix, r, base_mv=None,
                    correction_form: str | None = None):
    """Reduce the bordered system to the reservoir Krylov space.

    Returns (S_matvec over (nc, ndof) vectors, r_schur (nc, neq),
    back_substitute(du_r) -> du_w). The Schur complement
    S = A_rr − A_rw D⁻¹ A_wr is applied matrix-free; the well blocks are
    block-diagonal because wellbores only couple through their own
    perforations. ``correction_form``: "onehot" (default — the
    layout-neutral contraction form, see _onehot_correction), "box"
    (r4 static lattice-box slices; column completions only), or
    "gather" (indexed gather/scatter). Env JUTUL_WELL_CORR
    overrides."""
    import os

    nc = B.A.n
    nw = B.D_ww.shape[0]
    rr, rw = r[:nc], r[nc:]
    Dinv = block_inv(B.D_ww)  # (nw, ndof, neq) acting eq-residual -> dof
    form = correction_form or os.environ.get("JUTUL_WELL_CORR", "onehot")
    if form not in ("onehot", "box", "gather"):
        # an unrecognized value must NOT fall through silently to
        # another form
        raise ValueError(
            f"correction_form {form!r} (JUTUL_WELL_CORR) must be one of "
            "'onehot', 'box', 'gather'")

    def gather_to_wells(xr):
        t = jnp.einsum("pij,pj->pi", B.J_br, xr[B.perf_cell], precision=_PREC)  # (np, neq)
        return jax.ops.segment_sum(t, jnp.asarray(B.perf_well),
                                   num_segments=nw)  # (nw, neq)

    def correction(xr):
        yw = jnp.einsum("wij,wj->wi", Dinv, gather_to_wells(xr), precision=_PREC)
        out = jnp.einsum("pij,pj->pi", B.J_rb, yw[B.perf_well], precision=_PREC)
        return jnp.zeros_like(rr).at[B.perf_cell].add(out)

    mv = base_mv if base_mv is not None else B.A.matvec
    boxes = _well_boxes(B) if form == "box" else None
    if form == "onehot":
        corr_oh = _onehot_correction(B, Dinv)

        def s_matvec(xr):
            return mv(xr) - corr_oh(xr)
    elif boxes is not None:
        nzl, nyl, nxl = B.A.L
        Jbr, Jrb = B.J_br, B.J_rb

        def s_matvec(xr):
            y = mv(xr)
            x4 = xr.reshape(nzl, nyl, nxl, xr.shape[-1])
            y4 = y.reshape(nzl, nyl, nxl, y.shape[-1])
            for w, (z0, z1, jy, jx, idx) in enumerate(boxes):
                seg = x4[z0:z1, jy, jx, :]  # (ncomp, ndof) static slice
                t = jnp.einsum("pij,pj->i", Jbr[idx], seg, precision=_PREC)
                yw = jnp.einsum("ij,j->i", Dinv[w], t, precision=_PREC)
                out = jnp.einsum("pij,j->pi", Jrb[idx], yw, precision=_PREC)
                y4 = y4.at[z0:z1, jy, jx, :].add(-out)
            return y4.reshape(y.shape)
    else:
        def s_matvec(xr):
            return mv(xr) - correction(xr)

    yw0 = jnp.einsum("wij,wj->wi", Dinv, rw, precision=_PREC)  # D⁻¹ r_w
    oh0 = _perf_onehot(nc, B.perf_cell, rr.dtype)
    r_schur = rr - jnp.einsum(
        "np,pi->ni", oh0,
        jnp.einsum("pij,pj->pi", B.J_rb, yw0[B.perf_well],
                   precision=_PREC),
        precision=_PREC)

    def back_substitute(du_r):
        t = gather_to_wells(du_r)
        return jnp.einsum("wij,wj->wi", Dinv, -(rw + t), precision=_PREC)

    return s_matvec, r_schur, back_substitute
