"""Structured-grid fast path: stencil assembly, SpMV and GMG-CPR.

For Cartesian meshes the TPFA sparsity is a 7-point stencil, so every
gather/scatter in the generic block-ELL path can be replaced by lattice
SLICING and PADDING: all arrays keep their large lattice dimensions
trailing, every stage is elementwise work that XLA fuses, and the CPR
pressure stage becomes geometric multigrid with exact piecewise-constant
Galerkin coarsening (which preserves the 7-point structure exactly).

Counterpart note: this is the lattice analogue of the reference's hard-coded
TPFA assembly path (src/conservation/conservation.jl:101-484
ConservationLawTPFAStorage + fill_conservation_eq!) — the reference
specializes the hot path for TPFA the same way.

Layout conventions:
- cell fields: (..., n) with small component axes LEADING;
- lattice views: (nz, ny, nx) trailing;
- the stencil matrix stores, per axis a, the coupling blocks as
  ``plus[a][e, j, f_lat]`` (row = left cell, column = +a neighbor) and
  ``minus[a][e, j, f_lat]`` (row = right cell, column = -a neighbor),
  plus ``diag[e, j, n]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.equations import (
    AccumulationContribution,
    CellTermContribution,
    FaceFluxContribution,
)

_SLICES = {  # per axis: (left-cells slice, right-cells slice) on (nz,ny,nx)
    0: (np.s_[:, :, :-1], np.s_[:, :, 1:]),
    1: (np.s_[:, :-1, :], np.s_[:, 1:, :]),
    2: (np.s_[:-1, :, :], np.s_[1:, :, :]),
}
_PADS = {  # pad widths to place a face-lattice onto the cell lattice
    0: ((0, 0), (0, 0), (0, 1)),  # value sits at the LEFT cell
    1: ((0, 0), (0, 1), (0, 0)),
    2: ((0, 1), (0, 0), (0, 0)),
}
_PADS_R = {
    0: ((0, 0), (0, 0), (1, 0)),  # value sits at the RIGHT cell
    1: ((0, 0), (1, 0), (0, 0)),
    2: ((1, 0), (0, 0), (0, 0)),
}


@dataclass
class StencilMatrix:
    """7-point block stencil matrix on an (nz, ny, nx) lattice."""

    L: tuple  # (nz, ny, nx)
    diag: jnp.ndarray  # (neq, ndof, n)
    plus: dict  # axis -> (neq, ndof, *face_lat)
    minus: dict  # axis -> (neq, ndof, *face_lat)

    @property
    def n(self) -> int:
        return int(np.prod(self.L))

    def matvec(self, x):
        """y = A x with x (n, ndof) -> y (n, neq); all slicing, no gathers."""
        return stencil_matvec(self)(x)


def lattice_coefficients(A: StencilMatrix):
    """(7, C, K, n) cell-aligned coefficients: the diagonal, then per axis
    the +a coupling (stored at the left cell, multiplies x at the right
    cell) and the -a coupling (stored at the right cell, multiplies x at
    the left cell), zero-padded from the face lattices onto the cells."""
    C, K, n = A.diag.shape
    out = [A.diag]
    for a in range(3):
        if a in A.plus:
            pad = ((0, 0), (0, 0))
            out.append(jnp.pad(A.plus[a], pad + _PADS[a]).reshape(C, K, n))
            out.append(jnp.pad(A.minus[a], pad + _PADS_R[a]).reshape(C, K, n))
        else:
            out += [jnp.zeros_like(A.diag)] * 2
    return jnp.stack(out)


def _shift(v, axis, d):
    """v at i+d (d = +-1) along ``axis`` of a lattice, zero outside."""
    n = v.shape[axis]
    sl = [slice(None)] * v.ndim
    pad = [(0, 0)] * v.ndim
    sl[axis] = slice(1, n) if d > 0 else slice(0, n - 1)
    pad[axis] = (0, 1) if d > 0 else (1, 0)
    return jnp.pad(v[tuple(sl)], pad)


def apply_lattice(coef, x, L):
    """y (n, C) = A x for x (n, K), with ``coef`` from
    :func:`lattice_coefficients`: a sum of 7*C*K products of a
    coefficient stream and a shifted x lattice, the small C and K axes
    unrolled. XLA fuses it into one kernel that reads each stream once;
    summing over a component axis with a reduction instead splits the
    apply into many kernels."""
    C, K = coef.shape[1:3]
    xl = x.T.reshape((K,) + tuple(L))
    sh = [xl]
    for ax in (3, 2, 1):  # lattice axes of x, y, z
        sh += [_shift(xl, ax, 1), _shift(xl, ax, -1)]
    ys = []
    for c in range(C):
        acc = None
        for t in range(7):
            for k in range(K):
                term = coef[t, c, k].reshape(L) * sh[t][k]
                acc = term if acc is None else acc + term
        ys.append(acc.reshape(-1))
    return jnp.stack(ys, axis=1)


def stencil_matvec(A: StencilMatrix):
    """Matvec callable of a block stencil matrix, built once per linear
    solve: the cell-aligned coefficients are laid out once and every
    apply reuses them."""
    coef = lattice_coefficients(A)
    return lambda x: apply_lattice(coef, x, A.L)


# Registered as a pytree (lattice shape static, blocks traced) so StencilMatrix
# can ride lax.while_loop carries (the fully-jitted Newton loop).
jax.tree_util.register_pytree_node(
    StencilMatrix,
    lambda m: ((m.diag, m.plus, m.minus), m.L),
    lambda L, ch: StencilMatrix(L, *ch),
)


def stencil_transpose(A: StencilMatrix) -> StencilMatrix:
    """A^T of a 7-point block stencil IS a 7-point block stencil: entry
    (row=L(f), col=R(f), block B) becomes (row=R(f), col=L(f), B^T), so
    plus/minus swap with their blocks transposed. This is what makes the
    adjoint's transposed lambda-solves ride the SAME stencil fast path
    (CPR-GMG preconditioned) as the forward Newton — the reference runs
    the adjoint-layout system through its forward solver stack the same
    way (ad/gradients.jl:168-224)."""
    swap = lambda v: jnp.swapaxes(v, 0, 1)
    return StencilMatrix(
        A.L, swap(A.diag),
        {a: swap(A.minus[a]) for a in A.minus},
        {a: swap(A.plus[a]) for a in A.plus})


def _inv2x2(d00, d01, d10, d11):
    det = d00 * d11 - d01 * d10
    inv = 1.0 / det
    return d11 * inv, -d01 * inv, -d10 * inv, d00 * inv


class StencilCompiledModel:
    """Structured fast path over a generic CompiledModel (CartesianMesh,
    single multi-component ConservationLaw with the TPFA stencil)."""

    def __init__(self, comp):
        self.comp = comp
        mesh = comp.model.domain.mesh
        from ..meshes.cartesian import CartesianMesh

        if not isinstance(mesh, CartesianMesh):
            raise TypeError("StencilCompiledModel requires a CartesianMesh")
        nx, ny, nz = mesh._dims3()
        self.L = (nz, ny, nx)
        self.ndof = comp.ndof
        self.neq = comp.neq_total
        # face blocks per axis in the global face ordering (x, then y, z)
        sizes = [(nx - 1) * ny * nz if nx > 1 else 0,
                 nx * (ny - 1) * nz if ny > 1 else 0,
                 nx * ny * (nz - 1) if nz > 1 else 0]
        self.face_sizes = sizes
        self.face_offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.face_lat = {
            0: (nz, ny, nx - 1) if nx > 1 else None,
            1: (nz, ny - 1, nx) if ny > 1 else None,
            2: (nz - 1, ny, nx) if nz > 1 else None,
        }
        # contributions
        self.acc_cons = []
        self.flux_con = None
        for info, con, meta in comp.contribs:
            if isinstance(con, (AccumulationContribution,
                                CellTermContribution)):
                self.acc_cons.append(con)
            elif isinstance(con, FaceFluxContribution):
                if self.flux_con is not None:
                    raise NotImplementedError("one flux contribution only")
                if con.stencil.shape[1] != 2:
                    raise NotImplementedError("TPFA (K=2) stencils only")
                self.flux_con = con

    # -- local state helpers -------------------------------------------
    def _axis_cell_states(self, cell_state, a):
        """Per-side dicts of cell entries sliced to the axis's face lattice
        and flattened (nf_a, ...)."""
        L = self.L
        sl_l, sl_r = _SLICES[a]
        out_l, out_r = {}, {}
        for k, v in cell_state.items():
            v = jnp.asarray(v)
            comp_shape = v.shape[1:]
            lat = v.reshape(L + comp_shape)
            out_l[k] = lat[sl_l].reshape((-1,) + comp_shape)
            out_r[k] = lat[sl_r].reshape((-1,) + comp_shape)
        return out_l, out_r

    def _axis_face_state(self, face_state, a):
        o0, o1 = self.face_offsets[a], self.face_offsets[a + 1]
        return {k: jnp.asarray(v)[o0:o1] for k, v in face_state.items()}

    # -- residual -------------------------------------------------------
    def residual(self, state, state0, dt, forces=None):
        comp = self.comp
        model = comp.model
        cell_state = comp._cell_entries(state)
        cell_state0 = comp._cell_entries(state0)
        face_state = comp._face_entries(state)
        n = self.n_cells

        r = jnp.zeros((self.neq, n))
        for con in self.acc_cons:
            fn = lambda cs, cs0, _c=con: _c.fn(model, cs, cs0, dt)
            vals = jax.vmap(fn)(cell_state, cell_state0)  # (n, neq)
            r = r + vals.T
        if self.flux_con is not None:
            con = self.flux_con
            r_lat = r.reshape((self.neq,) + self.L)
            for a in range(3):
                if self.face_lat[a] is None:
                    continue
                cs_l, cs_r = self._axis_cell_states(cell_state, a)
                fs = self._axis_face_state(face_state, a)

                def flux2(l, r_, f, _c=con):
                    local = jax.tree_util.tree_map(
                        lambda x, y: jnp.stack([x, y]), l, r_)
                    return _c.fn(model, local, f)

                flux = jax.vmap(flux2)(cs_l, cs_r, fs)  # (nf_a, neq)
                f_lat = flux.T.reshape((self.neq,) + self.face_lat[a])
                r_lat = r_lat + jnp.pad(f_lat, ((0, 0),) + _PADS[a])
                r_lat = r_lat - jnp.pad(f_lat, ((0, 0),) + _PADS_R[a])
            r = r_lat.reshape(self.neq, -1)
        r = r.T  # (n, neq) to match the generic engine
        if forces:
            r = comp._apply_forces(r, state, dt, forces)
        return r

    @property
    def n_cells(self):
        return self.comp.n_cells

    def _apply_force_diag(self, diag, state, dt, forces):
        """Add state-dependent force Jacobians (e.g. a pressure-BC's
        dq/dp) onto the (neq, ndof, n) diagonal — the stencil counterpart
        of the generic engine's _apply_force_jacobians
        (ops/assembly.py:499); constant sources contribute None."""
        from .assembly import _as_force_list

        comp = self.comp
        for info in comp.equations:
            sl = info.row_slice
            for fv in forces.values():
                for force in _as_force_list(fv):
                    contrib = force.diagonal_jacobian(
                        comp.model, info.eq, info.name, comp, state, dt)
                    if contrib is None:
                        continue
                    cells, jac = contrib  # (ns,), (ns, neq_e, ndof)
                    diag = diag.at[sl, :, jnp.asarray(cells)].add(
                        jnp.moveaxis(jnp.asarray(jac, diag.dtype), 0, -1))
        return diag

    # -- jacobian -------------------------------------------------------
    def jacobian(self, state, state0, dt, forces=None) -> StencilMatrix:
        comp = self.comp
        model = comp.model
        params_cell = comp._cell_entries(state, include=("parameter", "extra"))
        cell_state0 = comp._cell_entries(state0)
        face_state = comp._face_entries(state)
        U_all = comp.get_dofs(state)  # (n, ndof)
        n = self.n_cells
        neq, ndof = self.neq, self.ndof

        diag = jnp.zeros((neq, ndof, n))
        for con in self.acc_cons:
            def local_fn(u_c, p_c, cs0, _c=con):
                local = dict(p_c)
                local.update(comp.unpack_dofs(u_c))
                local = comp._eval_secondaries_local(local)
                return _c.fn(model, local, cs0, dt)

            jac = jax.vmap(jax.jacfwd(local_fn, argnums=0))(
                U_all, params_cell, cell_state0)  # (n, neq, ndof)
            diag = diag + jnp.moveaxis(jac, 0, -1)

        plus, minus = {}, {}
        if self.flux_con is not None:
            con = self.flux_con
            diag_lat = diag.reshape((neq, ndof) + self.L)
            for a in range(3):
                if self.face_lat[a] is None:
                    continue
                p_l, p_r = self._axis_cell_states(params_cell, a)
                sl_l, sl_r = _SLICES[a]
                U_lat = U_all.T.reshape((ndof,) + self.L)
                U_l = U_lat[(slice(None),) + sl_l].reshape(ndof, -1).T
                U_r = U_lat[(slice(None),) + sl_r].reshape(ndof, -1).T
                fs = self._axis_face_state(face_state, a)

                def flux2(ul, ur, pl, pr, f, _c=con):
                    ll = dict(pl)
                    ll.update(comp.unpack_dofs(ul))
                    ll = comp._eval_secondaries_local(ll)
                    rr = dict(pr)
                    rr.update(comp.unpack_dofs(ur))
                    rr = comp._eval_secondaries_local(rr)
                    local = jax.tree_util.tree_map(
                        lambda x, y: jnp.stack([x, y]), ll, rr)
                    return _c.fn(model, local, f)

                # Jacobian via jvp THROUGH the vectorized flux (the same
                # computation shape as the fast residual path): per dof j,
                # one jvp for the left and one for the right sensitivity.
                # XLA CSEs the repeated primal across the 2*ndof calls.
                flux_vec = jax.vmap(flux2, in_axes=(0, 0, 0, 0, 0))
                zeros_u = jnp.zeros_like(U_l)
                fl = self.face_lat[a]
                cols_l, cols_r = [], []
                for j in range(ndof):
                    ej = jnp.zeros_like(U_l).at[:, j].set(1.0)
                    _, tl = jax.jvp(
                        lambda ul, ur: flux_vec(ul, ur, p_l, p_r, fs),
                        (U_l, U_r), (ej, zeros_u))
                    _, tr = jax.jvp(
                        lambda ul, ur: flux_vec(ul, ur, p_l, p_r, fs),
                        (U_l, U_r), (zeros_u, ej))
                    cols_l.append(tl)  # (nf, neq) = dF/du_L[:, :, j]
                    cols_r.append(tr)
                jlT = jnp.stack(
                    [jnp.stack([cols_l[j][:, e].reshape(fl)
                                for j in range(ndof)])
                     for e in range(neq)])  # (neq, ndof, *fl)
                jrT = jnp.stack(
                    [jnp.stack([cols_r[j][:, e].reshape(fl)
                                for j in range(ndof)])
                     for e in range(neq)])
                # residual[L] += F => d/d u_L at diag(L), d/d u_R at plus
                # residual[R] -= F => d/d u_R at diag(R), d/d u_L at minus
                diag_lat = diag_lat + jnp.pad(jlT, ((0, 0), (0, 0)) + _PADS[a])
                diag_lat = diag_lat - jnp.pad(jrT, ((0, 0), (0, 0)) + _PADS_R[a])
                plus[a] = jrT
                minus[a] = -jlT
            diag = diag_lat.reshape(neq, ndof, n)
        if forces:
            diag = self._apply_force_diag(diag, state, dt, forces)
        return StencilMatrix(self.L, diag, plus, minus)

    def assemble(self, state, state0, dt, forces=None):
        state = self.comp.evaluate_secondaries(state)
        state0 = self.comp.evaluate_secondaries(state0)
        r = self.residual(state, state0, dt, forces)
        A = self.jacobian(state, state0, dt, forces)
        return r, A, state


# ---------------------------------------------------------------------------
# CPR with geometric multigrid on the pressure stencil
# ---------------------------------------------------------------------------
@dataclass
class ScalarStencil:
    L: tuple
    diag: jnp.ndarray  # (n,)
    plus: dict  # axis -> face-lattice arrays
    minus: dict

    @property
    def n(self) -> int:
        return int(np.prod(self.L))

    def matvec(self, x):
        L = self.L
        y = self.diag * x
        x_lat = x.reshape(L)
        y_lat = y.reshape(L)
        for a in self.plus:
            sl_l, sl_r = _SLICES[a]
            y_lat = y_lat + jnp.pad(self.plus[a] * x_lat[sl_r], _PADS[a])
            y_lat = y_lat + jnp.pad(self.minus[a] * x_lat[sl_l], _PADS_R[a])
        return y_lat.reshape(-1)


jax.tree_util.register_pytree_node(
    ScalarStencil,
    lambda m: ((m.diag, m.plus, m.minus), m.L),
    lambda L, ch: ScalarStencil(L, *ch),
)


def _fold(v, axis, f: int = 2):
    """Sum adjacent groups of ``f`` along ``axis`` (dim must be a
    multiple of f)."""
    sh = list(v.shape)
    n = sh[axis]
    sh[axis:axis + 1] = [n // f, f]
    return v.reshape(sh).sum(axis=axis + 1)


def _pad_even(A: ScalarStencil, f: int = 2) -> ScalarStencil:
    """Pad lattice dims to multiples of ``f`` with identity rows (diag=1,
    no coupling); dims of extent 1 stay uncoarsened and unpadded."""
    nz, ny, nx = A.L
    pads3 = tuple(0 if n == 1 else (-n) % f for n in (nz, ny, nx))
    if not any(pads3):
        return A
    pad_c = tuple((0, p) for p in pads3)
    diag = jnp.pad(A.diag.reshape(A.L), pad_c, constant_values=1.0)
    plus, minus = {}, {}
    for a in A.plus:
        plus[a] = jnp.pad(A.plus[a], pad_c)
        minus[a] = jnp.pad(A.minus[a], pad_c)
    return ScalarStencil(diag.shape, diag.reshape(-1), plus, minus)


def _coarsen_scalar(A: ScalarStencil, f: int = 2) -> ScalarStencil:
    """Exact piecewise-constant Galerkin ``f``x coarsening of a 7-point
    stencil (stays 7-point: only face-adjacent coarse blocks couple).

    A_c[I, J] = sum_{i in I, j in J} A[i, j]: fine faces interior to a
    block (index % f != f-1 along the axis) fold into the coarse
    diagonal; the block-boundary face layer (index % f == f-1) forms the
    coarse interface couplings. f=2 is classical cell-centered MG; f=4
    collapses two 2x levels into one — half the V-cycle's levels for a
    weaker but much cheaper cycle.
    """
    A = _pad_even(A, f)
    nz, ny, nx = A.L
    cL = tuple(max(n // f, 1) if n > 1 else 1 for n in (nz, ny, nx))

    def blocksum_cells(v_lat):
        out = v_lat
        for axis, n in enumerate(A.L):
            if n > 1:
                out = _fold(out, axis, f)
        return out

    def blocksum_transverse(v, ax_lat):
        out = v
        for axis in range(3):
            if axis != ax_lat and A.L[axis] > 1:
                out = _fold(out, axis, f)
        return out

    diag_c = blocksum_cells(A.diag.reshape(A.L))
    plus_c, minus_c = {}, {}
    for a in A.plus:
        ax_lat = 2 - a
        nf = A.plus[a].shape[ax_lat]  # = n-1 along the axis
        sel_int = [slice(None)] * 3
        sel_ifc = [slice(None)] * 3
        if f == 1:
            raise ValueError("coarsening factor must be >= 2")
        # boundary layer between blocks: one fine-face layer per coarse
        # face, at index f-1, 2f-1, ...
        sel_ifc[ax_lat] = slice(f - 1, None, f)
        p, m = A.plus[a], A.minus[a]
        pi = p[tuple(sel_ifc)]
        # interior faces: everything NOT on the block boundary. Zero out
        # the boundary layer and fold the whole face lattice (padded by
        # one zero layer to n faces) into the diagonal.
        mask_sh = [1, 1, 1]
        mask_sh[ax_lat] = nf
        idx = jnp.arange(nf).reshape(mask_sh)
        interior = jnp.where(idx % f != f - 1, p + m, 0.0)
        pad1 = [(0, 0)] * 3
        pad1[ax_lat] = (0, 1)  # n-1 faces -> n cells (face sits at left)
        interior = jnp.pad(interior, pad1)
        diag_c = diag_c + blocksum_cells(interior)
        if pi.shape[ax_lat] == 0:
            continue
        plus_c[a] = blocksum_transverse(pi, ax_lat)
        minus_c[a] = blocksum_transverse(m[tuple(sel_ifc)], ax_lat)
    return ScalarStencil(cL, diag_c.reshape(-1), plus_c, minus_c)


def _prolong_linear(e_lat, fine_L):
    """Trilinear cell-centered prolongation (Wesseling): each fine child
    sits a quarter coarse-cell off its parent's center, so along every
    coarsened axis the child value is 3/4 parent + 1/4 nearest neighbor
    (edge-clamped). Paired with the piecewise-constant restriction this
    gives transfer orders 2+1 > operator order 2 — the classical
    cell-centered MG recipe that injection (order 1) misses; measured
    contraction/cycle 0.85 -> ~0.3 on the heterogeneous pressure
    stencil."""
    for axis in range(3):
        n = e_lat.shape[axis]
        if fine_L[axis] == n:  # axis not coarsened
            continue
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(0, 1)
        sl_hi[axis] = slice(n - 1, n)
        sl_m = [slice(None)] * 3
        sl_p = [slice(None)] * 3
        sl_m[axis] = slice(0, n - 1)
        sl_p[axis] = slice(1, n)
        e_minus = jnp.concatenate(
            [e_lat[tuple(sl_lo)], e_lat[tuple(sl_m)]], axis=axis)
        e_plus = jnp.concatenate(
            [e_lat[tuple(sl_p)], e_lat[tuple(sl_hi)]], axis=axis)
        even = 0.75 * e_lat + 0.25 * e_minus
        odd = 0.75 * e_lat + 0.25 * e_plus
        st = jnp.stack([even, odd], axis=axis + 1)
        sh = list(e_lat.shape)
        sh[axis] = 2 * n
        e_lat = st.reshape(sh)
    return e_lat


class XLAScalarLevel:
    """Per-level V-cycle operations on a scalar stencil: matvec, residual
    and weighted-Jacobi sweeps, each a short elementwise chain around one
    stencil apply that XLA fuses."""

    def __init__(self, A):
        self.A = A
        self._dinv = 1.0 / A.diag

    def matvec(self, x):
        return self.A.matvec(x)

    def residual(self, u, b):
        return b - self.A.matvec(u)

    def smooth(self, u, b, omega):
        return u + omega * self._dinv * (b - self.A.matvec(u))

    def smooth0(self, b, omega):
        """smooth from the zero guess: elementwise, no stencil pass."""
        return omega * self._dinv * b


def _cheby_setup(A: ScalarStencil):
    """Per-level Chebyshev data: inverse diagonal + a Gershgorin upper
    bound on lambda_max(D^-1 A) (one coefficient pass, no power
    iteration — a slight overestimate only flattens the polynomial a
    little, while an UNDERestimate would amplify high modes)."""
    offs = jnp.zeros(A.L, A.diag.dtype)
    for a in A.plus:
        offs = offs + jnp.pad(jnp.abs(A.plus[a]), _PADS[a])
        offs = offs + jnp.pad(jnp.abs(A.minus[a]), _PADS_R[a])
    dabs = jnp.abs(A.diag)
    dsafe = jnp.where(dabs > 0, dabs, 1.0)
    lmax = 1.0 + jnp.max(offs.reshape(-1) / dsafe)
    # dead rows never update (dinv = 0)
    dinv = jnp.where(dabs > 0, 1.0 / A.diag, 0.0)
    return dinv, lmax


def _cheby_smooth(lv, dinv, lmax, u, b, n_sweep, lower=0.25):
    """Chebyshev smoothing of the level via the shared recurrence
    (linsolve/cheby.py) with the level's fused residual op."""
    from ..linsolve.cheby import chebyshev_recurrence

    return chebyshev_recurrence(
        lambda u_: dinv * lv.residual(u_, b), dinv * b, u, n_sweep,
        lmax, lower)


class GMG:
    """Geometric multigrid V-cycle on a scalar 7-point stencil (the CPR
    pressure stage on structured grids — replaces AMG with exact
    structure-preserving coarsening).

    ``smoother``: "jacobi" (weighted) or "chebyshev" (polynomial
    smoothing on [lower*lmax, lmax]; no dot products, so it stays
    communication-free under DD — SURVEY hard part (a))."""

    def __init__(self, omega: float = 0.8, n_smooth: int = 2,
                 n_coarse_sweeps: int = 40, min_cells: int = 32,
                 max_levels: int = 10,
                 smoother: str = "jacobi", cheby_lower: float = 0.25,
                 prolongation: str = "injection",
                 coarsen_factor: int = 2):
        self.omega = omega
        self.n_smooth = n_smooth
        self.n_coarse_sweeps = n_coarse_sweeps
        self.min_cells = min_cells
        self.max_levels = max_levels
        # per-axis fold factor between levels: 2 = classical cell-centered
        # MG; 4 halves the level count (64x fewer cells per hop) — a
        # weaker but cheaper cycle
        if int(coarsen_factor) < 2:
            raise ValueError("coarsen_factor must be >= 2")
        self.coarsen_factor = int(coarsen_factor)
        if prolongation == "linear" and self.coarsen_factor != 2:
            raise ValueError("prolongation='linear' requires "
                             "coarsen_factor=2")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self.cheby_lower = cheby_lower
        if prolongation not in ("injection", "linear"):
            raise ValueError(f"unknown prolongation {prolongation!r}")
        self.prolongation = prolongation

    def hierarchy(self, A: ScalarStencil) -> list:
        ops = [A]
        for _ in range(self.max_levels):
            if ops[-1].n <= self.min_cells:
                break
            ops.append(_coarsen_scalar(ops[-1], self.coarsen_factor))
        return ops

    def matvecs(self, ops: list) -> list:
        """Per-level operations (built once per update)."""
        return [XLAScalarLevel(A) for A in ops]

    def cheby_data(self, ops: list) -> list | None:
        """Per-level (dinv, lmax) when the Chebyshev smoother is on."""
        if self.smoother != "chebyshev":
            return None
        return [_cheby_setup(A) for A in ops]

    def vcycle(self, ops: list, b, level: int = 0, mvs: list | None = None,
               cheb: list | None = None):
        A = ops[level]
        lv = mvs[level] if mvs is not None else XLAScalarLevel(A)
        if cheb is None and self.smoother == "chebyshev":
            cheb = self.cheby_data(ops)
        if cheb is not None:
            dinv, lmax = cheb[level]
            if level == len(ops) - 1:
                return _cheby_smooth(lv, dinv, lmax, None, b,
                                     self.n_coarse_sweeps, self.cheby_lower)
            u = _cheby_smooth(lv, dinv, lmax, None, b, self.n_smooth,
                              self.cheby_lower)
            r = lv.residual(u, b)
        # smooth(0, b) == omega * b / diag: the first sweep from the zero
        # initial guess is ELEMENTWISE — no A-application. One full
        # stencil pass saved per level per V-cycle (and 1 of the
        # n_coarse_sweeps below).
        elif level == len(ops) - 1:
            u = lv.smooth0(b, self.omega)
            for _ in range(self.n_coarse_sweeps - 1):
                u = lv.smooth(u, b, self.omega)
            return u
        else:
            u = lv.smooth0(b, self.omega)
            for _ in range(self.n_smooth - 1):
                u = lv.smooth(u, b, self.omega)
            r = lv.residual(u, b)
        # restrict (pw-constant sum) onto the padded lattice
        f = self.coarsen_factor
        Ap = _pad_even(A, f)
        r_lat = jnp.pad(r.reshape(A.L),
                        ((0, Ap.L[0] - A.L[0]), (0, Ap.L[1] - A.L[1]),
                         (0, Ap.L[2] - A.L[2])))
        rc = r_lat
        for axis, n in enumerate(Ap.L):
            if n > 1:
                rc = _fold(rc, axis, f)
        ec = self.vcycle(ops, rc.reshape(-1), level + 1, mvs, cheb)
        # prolong: inject the coarse value into each child cell, or
        # interpolate it trilinearly (prolongation="linear", f=2 only)
        e_lat = ec.reshape(ops[level + 1].L)
        if self.prolongation == "linear":
            e_lat = _prolong_linear(e_lat, Ap.L)
        else:
            for axis, n in enumerate(Ap.L):
                if n > 1:
                    e_lat = jnp.repeat(e_lat, f, axis=axis)
        e_lat = e_lat[: A.L[0], : A.L[1], : A.L[2]]
        u = u + e_lat.reshape(-1)
        if cheb is not None:
            dinv, lmax = cheb[level]
            return _cheby_smooth(lv, dinv, lmax, u, b, self.n_smooth,
                                 self.cheby_lower)
        for _ in range(self.n_smooth):
            u = lv.smooth(u, b, self.omega)
        return u


@dataclass
class StencilCPRState:
    w: jnp.ndarray  # (neq, n) quasi-IMPES row weights
    dinv: jnp.ndarray  # (n, ndof, neq) inverse diagonal blocks
    ops: list  # GMG hierarchy of the pressure stencil
    mvs: list  # per-level V-cycle operations
    mv_col: object  # matvec of the pressure COLUMN of A (K=1): stage 2
    # applies A to a vector that is nonzero only in the pressure dof, so
    # only the p-column coefficients need reading — half the traffic of
    # the full C*K matvec at ndof=2
    cheb: list | None = None  # per-level (dinv, lmax) Chebyshev data


class StencilCPR:
    """CPR for the stencil matrix: quasi-IMPES weights + GMG pressure
    stage + block-Jacobi smoother. Mirrors linsolve/cpr.py on the
    structured fast path."""

    def __init__(self, pressure_index: int = 0, gmg: GMG | None = None):
        self.p = pressure_index
        self.gmg = gmg or GMG()

    def update(self, A: StencilMatrix):
        """General NxN blocks: quasi-IMPES weights w = row p of D^{-1};
        the scalar pressure stencil collapses every coupling block B
        through Ap[i,j] = sum_e w_i[e] * B[e, p]."""
        neq, ndof, n = A.diag.shape
        if neq != ndof:
            raise NotImplementedError("StencilCPR: square cell blocks only")
        # (n, neq, ndof) inverse diagonal blocks
        from .smallmat import block_inv

        dinv = block_inv(jnp.moveaxis(A.diag, -1, 0))  # (n, neq, ndof)
        w = jnp.moveaxis(dinv[:, self.p, :], 0, -1)  # (neq, n): row p
        # scalar pressure stencil: Ap[i,j] = sum_e w_i[e] * B[i,j][e, p]
        w_lat = w.reshape((neq,) + A.L)
        diag_p = jnp.einsum("en,en->n", w, A.diag[:, self.p])
        plus_p, minus_p = {}, {}
        for a in A.plus:
            sl_l, sl_r = _SLICES[a]
            wl = w_lat[(slice(None),) + sl_l]
            wr = w_lat[(slice(None),) + sl_r]
            plus_p[a] = jnp.einsum("e...,e...->...", wl,
                                   A.plus[a][:, self.p])
            minus_p[a] = jnp.einsum("e...,e...->...", wr,
                                    A.minus[a][:, self.p])
        Ap = ScalarStencil(A.L, diag_p.reshape(-1), plus_p, minus_p)
        ops = self.gmg.hierarchy(Ap)
        col = StencilMatrix(
            A.L, A.diag[:, self.p:self.p + 1, :],
            {a: v[:, self.p:self.p + 1] for a, v in A.plus.items()},
            {a: v[:, self.p:self.p + 1] for a, v in A.minus.items()})
        return StencilCPRState(w, dinv, ops, mvs=self.gmg.matvecs(ops),
                               mv_col=stencil_matvec(col),
                               cheb=self.gmg.cheby_data(ops))

    def apply(self, state: StencilCPRState, A: StencilMatrix, x):
        """x (n, neq) residual -> du (n, ndof)."""
        from .smallmat import bmv

        r_p = jnp.einsum("en,ne->n", state.w, x)
        dp = self.gmg.vcycle(state.ops, r_p, mvs=state.mvs,
                             cheb=state.cheb)
        # du0 is nonzero only in the pressure dof, so A du0 is the
        # p-column matvec of dp
        r2 = x - state.mv_col(dp[:, None])
        du = bmv(state.dinv, r2)
        return du.at[:, self.p].add(dp)


class StencilKrylovSolver:
    """Linear-solver adapter for the stencil fast path: BiCGStab with
    StencilCPR (drop-in for GenericKrylov when the Jacobian is a
    StencilMatrix). Vectors keep the operators' native (n, neq) /
    (n, ndof) layout — no flat relayouts at the matvec/precond
    boundaries (linsolve/krylov.py)."""

    def __init__(self, preconditioner: StencilCPR | None = None,
                 rtol: float = 1e-6, atol: float = 0.0,
                 max_iterations: int = 100):
        self.preconditioner = preconditioner or StencilCPR()
        self.rtol = rtol
        self.atol = atol
        self.max_iterations = max_iterations

    def solve(self, A: StencilMatrix, r, rtol=None):
        from ..linsolve.krylov import bicgstab
        from .stencil_wells import BorderedStencilMatrix

        if isinstance(A, BorderedStencilMatrix):
            return self._solve_bordered(A, r, rtol)
        pstate = self.preconditioner.update(A)
        return bicgstab(
            stencil_matvec(A), (-r).astype(A.diag.dtype),
            maxiter=self.max_iterations,
            rtol=self.rtol if rtol is None else rtol, atol=self.atol,
            precond=lambda x: self.preconditioner.apply(pstate, A, x))

    def _solve_bordered(self, B, r, rtol=None):
        """Bordered (well-model) system: Schur-eliminate the wellbore
        block, run the SAME CPR(GMG)-preconditioned BiCGStab on the
        reservoir Schur complement (lattice operator + rank-(nw·ndof)
        perforation correction), back-substitute du_w exactly. The
        preconditioner sees only the lattice StencilMatrix (the
        correction is low rank; Krylov absorbs it). Counterpart of the
        reference's Schur-reduced well solves
        (src/linsolve/multimodel.jl:17)."""
        from ..linsolve.krylov import bicgstab
        from .stencil_wells import schur_eliminate

        A = B.A
        pstate = self.preconditioner.update(A)
        s_matvec, r_schur, back_substitute = schur_eliminate(
            B, r, base_mv=stencil_matvec(A))
        du_r, stats = bicgstab(
            s_matvec, (-r_schur).astype(A.diag.dtype),
            maxiter=self.max_iterations,
            rtol=self.rtol if rtol is None else rtol, atol=self.atol,
            precond=lambda x: self.preconditioner.apply(pstate, A, x))
        du_w = back_substitute(du_r)
        return jnp.concatenate([du_r, du_w], axis=0), stats
