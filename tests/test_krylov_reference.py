"""Krylov solvers (linsolve/krylov.py) against dense numpy solutions."""
import jax.numpy as jnp
import numpy as np
import pytest

from jutul.jl_tpu.linsolve.krylov import bicgstab


def _random_system(n, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) * 0.1
    A = A @ A.T + n * np.eye(n)  # SPD, well conditioned
    x_true = rng.normal(size=n)
    b = A @ x_true
    Aj = jnp.asarray(A, dtype)
    return (lambda x: Aj @ x), jnp.asarray(b, dtype), x_true


@pytest.mark.parametrize("n", [64, 300])
def test_bicgstab_solves_dense(n):
    """f32 BiCGStab reaches the dense f64 solution."""
    matvec, b, x_true = _random_system(n)
    x, stats = bicgstab(matvec, b, rtol=1e-6, maxiter=200)
    assert bool(stats["converged"])
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=2e-3, atol=2e-3)


def test_bicgstab_with_preconditioner_solves_dense():
    matvec, b, x_true = _random_system(200, seed=4)
    d = jnp.asarray(1.0 / (200.0 + 0.0 * b))  # scaled Jacobi-ish
    x, stats = bicgstab(matvec, b, rtol=1e-6, maxiter=200,
                        precond=lambda z: d * z)
    assert bool(stats["converged"])
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=2e-3, atol=2e-3)


def test_gmres_cgs2_matches_mgs():
    """CGS2 (matrix-product Arnoldi orthogonalization) reaches the same
    solution as the MGS reference formulation."""
    from jutul.jl_tpu.linsolve.krylov import gmres

    matvec, b, x_true = _random_system(200, seed=7)
    x_c, st_c = gmres(matvec, b, rtol=1e-6, maxiter=200, orth="cgs2")
    x_m, st_m = gmres(matvec, b, rtol=1e-6, maxiter=200, orth="mgs")
    assert bool(st_c["converged"]) and bool(st_m["converged"])
    # identical counts away from the f32 residual-estimate floor
    assert int(st_c["iterations"]) == int(st_m["iterations"])
    np.testing.assert_allclose(np.asarray(x_c), x_true, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(x_c), np.asarray(x_m),
                               rtol=1e-3, atol=1e-4)
