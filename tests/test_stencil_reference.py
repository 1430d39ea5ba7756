"""Lattice stencil operators (ops/stencil.py) against dense numpy
references: block and scalar matvec, the per-level V-cycle operations
and a two-grid V-cycle built from explicit dense matrices."""

import jax.numpy as jnp
import numpy as np
import pytest

_FACES = lambda nz, ny, nx: {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx),  # noqa
                             2: (nz - 1, ny, nx)}


def _random_stencil_matrix(L, C, K, seed=0):
    from jutul.jl_tpu.ops.stencil import StencilMatrix

    nz, ny, nx = L
    n = nz * ny * nx
    rng = np.random.default_rng(seed)
    diag = jnp.asarray(rng.normal(size=(C, K, n)))
    plus, minus = {}, {}
    for a, fs in _FACES(*L).items():
        if fs[0] and fs[1] and fs[2]:
            plus[a] = jnp.asarray(rng.normal(size=(C, K) + fs))
            minus[a] = jnp.asarray(rng.normal(size=(C, K) + fs))
    return StencilMatrix(L, diag, plus, minus)


def _random_scalar_stencil(L, seed, diag_shift=6.0, negative=True):
    from jutul.jl_tpu.ops.stencil import ScalarStencil

    n = int(np.prod(L))
    rng = np.random.default_rng(seed)
    diag = jnp.asarray(np.full(n, diag_shift) + rng.uniform(0, 1, n))
    mk = (lambda s: -np.abs(rng.normal(size=s))) if negative else \
        (lambda s: rng.normal(size=s))
    fs = {a: s for a, s in _FACES(*L).items() if all(s)}
    return ScalarStencil(L, diag, {a: jnp.asarray(mk(s)) for a, s in fs.items()},
                         {a: jnp.asarray(mk(s)) for a, s in fs.items()})


def _pairs(L, a):
    """(left, right) global cell indices of every face along axis a, in
    the face lattice's C order."""
    nz, ny, nx = L
    idx = np.arange(nz * ny * nx).reshape(L)
    if a == 0:
        return idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()
    if a == 1:
        return idx[:, :-1, :].ravel(), idx[:, 1:, :].ravel()
    return idx[:-1].ravel(), idx[1:].ravel()


def dense_block(A):
    """Dense (n*C, n*K) matrix of a StencilMatrix (row-major cell blocks)."""
    C, K, n = np.asarray(A.diag).shape
    M = np.zeros((n, C, n, K))
    d = np.asarray(A.diag)
    M[np.arange(n), :, np.arange(n), :] = np.moveaxis(d, -1, 0)
    for a in A.plus:
        lft, rgt = _pairs(A.L, a)
        p = np.asarray(A.plus[a]).reshape(C, K, -1)
        m = np.asarray(A.minus[a]).reshape(C, K, -1)
        M[lft, :, rgt, :] += np.moveaxis(p, -1, 0)
        M[rgt, :, lft, :] += np.moveaxis(m, -1, 0)
    return M.reshape(n * C, n * K)


def dense_scalar(A):
    n = A.n
    M = np.diag(np.asarray(A.diag, np.float64))
    for a in A.plus:
        lft, rgt = _pairs(A.L, a)
        M[lft, rgt] += np.asarray(A.plus[a]).ravel()
        M[rgt, lft] += np.asarray(A.minus[a]).ravel()
    return M


@pytest.mark.parametrize("L,C,K", [((4, 5, 6), 2, 2), ((3, 4, 8), 1, 1),
                                   ((2, 1, 7), 2, 2),
                                   # odd nx, ny % 8 != 0
                                   ((3, 5, 7), 2, 2), ((2, 3, 9), 2, 1)])
def test_block_matvec_matches_dense(L, C, K):
    A = _random_stencil_matrix(L, C, K)
    n = A.n
    x = np.random.default_rng(1).normal(size=(n, K))
    y = np.asarray(A.matvec(jnp.asarray(x)))
    y_ref = (dense_block(A) @ x.reshape(-1)).reshape(n, C)
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)


def test_scalar_stencil_matches_dense():
    A = _random_scalar_stencil((3, 4, 4), seed=2, negative=False)
    x = np.random.default_rng(2).normal(size=A.n)
    np.testing.assert_allclose(np.asarray(A.matvec(jnp.asarray(x))),
                               dense_scalar(A) @ x, rtol=1e-12, atol=1e-12)


def test_level_smoother_and_residual_match_dense():
    """XLAScalarLevel residual / weighted-Jacobi sweep / zero-guess sweep
    against the dense formulas."""
    from jutul.jl_tpu.ops.stencil import XLAScalarLevel

    A = _random_scalar_stencil((4, 8, 5), seed=3, diag_shift=8.0,
                               negative=False)
    M = dense_scalar(A)
    rng = np.random.default_rng(3)
    u, b = rng.normal(size=A.n), rng.normal(size=A.n)
    lv = XLAScalarLevel(A)
    d = np.diag(M)
    np.testing.assert_allclose(np.asarray(lv.residual(jnp.asarray(u),
                                                      jnp.asarray(b))),
                               b - M @ u, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(lv.smooth(jnp.asarray(u), jnp.asarray(b), 0.8)),
        u + 0.8 * (b - M @ u) / d, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lv.smooth0(jnp.asarray(b), 0.8)),
                               0.8 * b / d, rtol=1e-12, atol=1e-12)


def _aggregation(L):
    """(n_c, n) piecewise-constant restriction of a factor-2 coarsening
    (every extent even here)."""
    nz, ny, nx = L
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    cL = (nz // 2, ny // 2, nx // 2)
    coarse = ((iz // 2) * cL[1] + iy // 2) * cL[2] + ix // 2
    R = np.zeros((int(np.prod(cL)), nz * ny * nx))
    R[coarse.ravel(), np.arange(nz * ny * nx)] = 1.0
    return R


def _jacobi(M, b, u, omega, sweeps):
    d = np.diag(M)
    for _ in range(sweeps):
        u = u + omega * (b - M @ u) / d
    return u


def test_gmg_vcycle_matches_dense_two_grid():
    """Two-level V-cycle == the dense formula with the Galerkin coarse
    operator R A R^T (checks the coarsening, restriction, injection
    prolongation and both smoothing phases)."""
    from jutul.jl_tpu.ops.stencil import GMG

    L = (4, 8, 8)
    A = _random_scalar_stencil(L, seed=4)
    b = np.random.default_rng(4).normal(size=A.n)
    gmg = GMG(n_smooth=2, n_coarse_sweeps=6, min_cells=A.n // 8)
    ops = gmg.hierarchy(A)
    assert len(ops) == 2
    u = np.asarray(gmg.vcycle(ops, jnp.asarray(b)))

    M = dense_scalar(A)
    R = _aggregation(L)
    Mc = R @ M @ R.T
    np.testing.assert_allclose(dense_scalar(ops[1]), Mc, rtol=1e-12,
                               atol=1e-12)
    uf = _jacobi(M, b, np.zeros(A.n), 0.8, 2)
    rc = R @ (b - M @ uf)
    uc = _jacobi(Mc, rc, np.zeros(len(rc)), 0.8, 6)
    ref = _jacobi(M, b, uf + R.T @ uc, 0.8, 2)
    np.testing.assert_allclose(u, ref, rtol=1e-11, atol=1e-11)


def test_coarsest_level_is_repeated_jacobi():
    """A single-level hierarchy: the V-cycle is n_coarse_sweeps weighted
    Jacobi sweeps from zero (the first one elementwise)."""
    from jutul.jl_tpu.ops.stencil import GMG

    A = _random_scalar_stencil((4, 8, 8), seed=11)
    b = np.random.default_rng(11).normal(size=A.n)
    gmg = GMG(n_smooth=2, n_coarse_sweeps=5, min_cells=A.n)
    ops = gmg.hierarchy(A)
    assert len(ops) == 1
    np.testing.assert_allclose(
        np.asarray(gmg.vcycle(ops, jnp.asarray(b))),
        _jacobi(dense_scalar(A), b, np.zeros(A.n), 0.8, 5),
        rtol=1e-11, atol=1e-11)


def test_cpr_pressure_column_matvec():
    """Stage 2 through the pressure-column matvec equals the full-matrix
    formulation."""
    from jutul.jl_tpu.ops.smallmat import bmv
    from jutul.jl_tpu.ops.stencil import GMG, StencilCPR

    A = _random_stencil_matrix((4, 8, 8), 2, 2)
    n = A.n
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(n, 2)))
    cpr = StencilCPR(gmg=GMG(n_smooth=1, n_coarse_sweeps=4, min_cells=64))
    st = cpr.update(A)
    du = cpr.apply(st, A, x)
    # reference: full-matrix stage 2
    r_p = jnp.einsum("en,ne->n", st.w, x)
    dp = cpr.gmg.vcycle(st.ops, r_p, mvs=st.mvs)
    du0 = jnp.zeros((n, 2), x.dtype).at[:, 0].set(dp)
    ref = du0 + bmv(st.dinv, x - A.matvec(du0))
    np.testing.assert_allclose(np.asarray(du), np.asarray(ref),
                               rtol=1e-11, atol=1e-11)


def test_level_phases_on_larger_lattice():
    """Pre-smoothing + residual and post-smoothing on a 1024-cell level
    against the dense formulas."""
    from jutul.jl_tpu.ops.stencil import XLAScalarLevel

    A = _random_scalar_stencil((8, 8, 16), seed=12)
    M = dense_scalar(A)
    rng = np.random.default_rng(12)
    b, u0 = rng.normal(size=A.n), rng.normal(size=A.n)
    lv = XLAScalarLevel(A)
    u = lv.smooth(lv.smooth0(jnp.asarray(b), 0.8), jnp.asarray(b), 0.8)
    u_ref = _jacobi(M, b, np.zeros(A.n), 0.8, 2)
    np.testing.assert_allclose(np.asarray(u), u_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lv.residual(u, jnp.asarray(b))),
                               b - M @ u_ref, rtol=1e-11, atol=1e-11)
    u2 = lv.smooth(lv.smooth(jnp.asarray(u0), jnp.asarray(b), 0.8),
                   jnp.asarray(b), 0.8)
    np.testing.assert_allclose(np.asarray(u2), _jacobi(M, b, u0, 0.8, 2),
                               rtol=1e-12, atol=1e-12)
