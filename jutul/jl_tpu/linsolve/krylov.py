"""Krylov solvers: restarted GMRES and BiCGStab, fully jittable.

Counterpart of Jutul's Krylov wrapper (reference: src/linsolve/krylov.jl —
``GenericKrylov`` :34, ``linear_solve!`` :71-240 with
``IterativeSolverConfig`` tolerances from linsolve/utils.jl:3). The reference
delegates to Krylov.jl; here the iterations are written directly as
``lax.while_loop`` programs so the whole solve fuses into one XLA
computation — dot products, SpMV (block-ELL einsum) and preconditioner
applies all stay on-device with no host round-trips.

Conventions: ``matvec``/``precond`` are closures over the assembled
operator. Preconditioning is applied on the right (x = M z) so the
reported residual is the true residual. ``bicgstab`` is shape-generic —
vectors keep whatever shape the operators natively consume (flat (N,)
for BlockELL, (n, neq) blocks for the stencil path); ``gmres`` stores an
explicit (m+1, N) basis and therefore requires flat vectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..ops.blockell import BlockELL
from .precond import Preconditioner, TrivialPreconditioner


def _identity(x):
    return x


def gmres(matvec: Callable, b, x0=None, restart: int = 20,
          maxiter: int = 200, rtol: float = 1e-8, atol: float = 0.0,
          precond: Callable | None = None, dot_fn: Callable | None = None,
          orth: str = "cgs2"):
    """Right-preconditioned restarted GMRES(m).

    Returns (x, stats) with stats = dict(iterations, residual, converged).
    ``dot_fn`` overrides the inner product (pass a psum-reducing dot inside
    shard_map for a distributed solve, like bicgstab; it receives the
    basis MATRIX in the cgs2 path — ``psum(jnp.dot(a, b))`` handles both).

    ``orth``: "cgs2" (classical Gram-Schmidt, twice — the Arnoldi
    orthogonalization becomes TWO (m+1, N) matrix products instead of
    m+1 sequential masked dots; reorthogonalization
    makes it as stable as MGS in practice) or "mgs" (the sequential
    reference formulation).
    """
    if orth not in ("cgs2", "mgs"):
        raise ValueError(f"unknown orthogonalization {orth!r}")
    N = b.shape[0]
    dtype = b.dtype
    if precond is None:
        precond = _identity
    if x0 is None:
        x0 = jnp.zeros_like(b)
    m = restart
    dot = dot_fn or jnp.dot
    norm = lambda v: jnp.sqrt(dot(v, v))

    bnorm = norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    def inner_cycle(x):
        """One GMRES(m) cycle from current x. Returns (x_new, resnorm)."""
        r = b - matvec(x)
        beta = norm(r)

        V = jnp.zeros((m + 1, N), dtype)
        V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def arnoldi_step(carry):
            V, H, cs, sn, g, k, _res = carry
            w = matvec(precond(V[k]))
            if orth == "cgs2":
                # classical Gram-Schmidt x2: each pass is one (m+1, N)
                # matmul + one rank-1-ish combine; columns beyond k
                # are zero rows of V, so masking is only needed to keep
                # the h coefficients clean
                mask = (jnp.arange(m + 1) <= k).astype(dtype)
                h1 = dot(V, w) * mask
                w = w - V.T @ h1
                h2 = dot(V, w) * mask
                w = w - V.T @ h2
                hcol = h1 + h2
            else:
                # modified Gram-Schmidt (masked beyond k)
                def mgs(j, wh):
                    w, hcol = wh
                    hij = jnp.where(j <= k, dot(V[j], w), 0.0)
                    w = w - hij * V[j]
                    return (w, hcol.at[j].set(hij))

                w, hcol = jax.lax.fori_loop(0, m + 1, mgs,
                                            (w, jnp.zeros(m + 1, dtype)))
            hk1 = norm(w)
            hcol = hcol.at[k + 1].set(hk1)
            V = V.at[k + 1].set(w / jnp.where(hk1 > 0, hk1, 1.0))

            # apply previous Givens rotations to the new column
            def rot(j, col):
                c, s = cs[j], sn[j]
                hj = jnp.where(j < k, c * col[j] + s * col[j + 1], col[j])
                hj1 = jnp.where(j < k, -s * col[j] + c * col[j + 1], col[j + 1])
                return col.at[j].set(hj).at[j + 1].set(hj1)

            hcol = jax.lax.fori_loop(0, m, rot, hcol)
            # new rotation to zero hcol[k+1]
            denom = jnp.sqrt(hcol[k] ** 2 + hcol[k + 1] ** 2)
            c_new = jnp.where(denom > 0, hcol[k] / denom, 1.0)
            s_new = jnp.where(denom > 0, hcol[k + 1] / denom, 0.0)
            cs = cs.at[k].set(c_new)
            sn = sn.at[k].set(s_new)
            hcol = hcol.at[k].set(denom).at[k + 1].set(0.0)
            H = H.at[:, k].set(hcol[: m + 1])
            g_k = g[k]
            g = g.at[k].set(c_new * g_k)
            g = g.at[k + 1].set(-s_new * g_k)
            res = jnp.abs(g[k + 1])
            return (V, H, cs, sn, g, k + 1, res)

        def arnoldi_cond(carry):
            *_, k, res = carry
            return jnp.logical_and(k < m, res > tol)

        carry0 = (V, H, cs, sn, g, 0, beta)
        V, H, cs, sn, g, k, res = jax.lax.while_loop(arnoldi_cond, arnoldi_step,
                                                     carry0)

        # back-substitute H[:k,:k] y = g[:k] (masked full-size triangular solve)
        def back(i_rev, y):
            i = m - 1 - i_rev
            active = i < k

            def body():
                s = g[i] - jnp.dot(H[i, :], y)
                return y.at[i].set(s / jnp.where(H[i, i] != 0, H[i, i], 1.0))

            return jnp.where(active, body(), y)

        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, dtype))
        dx = precond(V[:m].T @ y)
        return x + dx, res, k

    def outer_cond(carry):
        x, res, it, cycles = carry
        return jnp.logical_and(res > tol, it < maxiter)

    def outer_step(carry):
        x, _res, it, cycles = carry
        x, res, k = inner_cycle(x)
        return (x, res, it + k, cycles + 1)

    r0 = norm(b - matvec(x0))
    x, res, its, cycles = jax.lax.while_loop(
        outer_cond, outer_step, (x0, r0, 0, 0)
    )
    return x, {"iterations": its, "residual": res,
               "converged": res <= tol, "cycles": cycles}


def bicgstab(matvec: Callable, b, x0=None, maxiter: int = 200,
             rtol: float = 1e-8, atol: float = 0.0,
             precond: Callable | None = None, dot_fn: Callable | None = None):
    """Right-preconditioned BiCGStab (reference solver=:bicgstab path).

    ``dot_fn`` overrides the inner product — inside ``shard_map`` pass a
    psum-reducing dot to make the solve distributed (the counterpart of the
    reference's PVector dot products over MPI, ext krylov.jl).

    Shape-generic: every operation is elementwise or a full-reduction
    dot, so vectors may be ANY shape — flat (N,), block (n, neq), or
    lattice (neq, nz, ny, nx) — as long as ``matvec``/``precond``
    consume and produce it. Keeping vectors in the operators' NATIVE
    shape avoids (n*ndof) <-> (n, ndof) relayouts at every matvec/
    preconditioner boundary.
    """
    if precond is None:
        precond = _identity
    if x0 is None:
        x0 = jnp.zeros_like(b)
    dot = dot_fn or (lambda a, v: jnp.sum(a * v))
    norm = lambda v: jnp.sqrt(dot(v, v))
    bnorm = norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - matvec(x0)
    rhat = r0
    # breakdown guards must be representable in the WORKING dtype: a
    # 1e-300 literal flushes to 0.0 in f32, turning every guard into a
    # divide-by-zero once the solve converges past the residual floor
    # (measured: rtol=0 f32 solves went NaN after exact convergence)
    tiny = float(jnp.finfo(jnp.asarray(b).dtype).tiny)

    def cond(carry):
        x, r, p, v, rho, alpha, omega, it, res = carry
        return jnp.logical_and(res > tol, it < maxiter)

    def step(carry):
        x, r, p, v, rho, alpha, omega, it, _res = carry
        rho_new = dot(rhat, r)
        beta = (rho_new / jnp.where(rho != 0, rho, tiny)) * (
            alpha / jnp.where(omega != 0, omega, tiny)
        )
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = rho_new / jnp.where(denom != 0, denom, tiny)
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, s) / jnp.where(tt != 0, tt, tiny)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        res = norm(r)
        return (x, r, p, v, rho_new, alpha, omega, it + 1, res)

    z = jnp.zeros_like(b)
    carry0 = (x0, r0, z, z, 1.0, 1.0, 1.0, 0, norm(r0))
    x, r, *_, it, res = jax.lax.while_loop(cond, step, carry0)
    return x, {"iterations": it, "residual": res, "converged": res <= tol}


class GenericKrylov:
    """Krylov linear solver for BlockELL systems
    (reference linsolve/krylov.jl:34 GenericKrylov).

    Parameters mirror the reference: ``solver`` in {"gmres", "bicgstab"},
    a preconditioner object, relative/absolute tolerances and max iterations
    (IterativeSolverConfig, linsolve/utils.jl:3).
    """

    def __init__(self, solver: str = "gmres", preconditioner: Preconditioner
                 | None = None, rtol: float = 1e-6, atol: float = 0.0,
                 max_iterations: int = 200, restart: int = 20,
                 verbose: bool = False, orth: str = "cgs2"):
        if solver not in ("gmres", "bicgstab"):
            raise ValueError(f"unknown solver {solver!r}")
        self.solver = solver
        self.preconditioner = preconditioner or TrivialPreconditioner()
        self.rtol = rtol
        self.atol = atol
        self.max_iterations = max_iterations
        self.restart = restart
        self.verbose = verbose
        self.orth = orth  # GMRES orthogonalization: "cgs2" | "mgs"

    def solve(self, J, r, rtol=None):
        """Solve J du = -r; shapes (n, neq) -> (n, ndof). Jit-compatible.
        ``rtol`` overrides the configured relative tolerance (may be a
        traced scalar — Eisenstat-Walker forcing in the jitted Newton).

        Also accepts a coupled MultiLinearizedSystem (dict-valued r/du),
        defaulting to a per-model block-Jacobi (GroupWise) preconditioner.
        """
        from ..multimodel.core import MultiLinearizedSystem

        if isinstance(J, MultiLinearizedSystem):
            return self._solve_multi(J, r, rtol=rtol)
        rtol = self.rtol if rtol is None else rtol
        n, _, neq, ndof = J.blocks.shape
        pstate = self.preconditioner.update(J)

        def matvec(x_flat):
            return J.matvec(x_flat.reshape(n, ndof)).reshape(n * neq)

        def precond(x_flat):
            y = self.preconditioner.apply(pstate, J, x_flat.reshape(n, neq))
            return y.reshape(n * ndof)

        b = (-r).reshape(n * neq)
        if self.solver == "gmres":
            x, stats = gmres(matvec, b, restart=self.restart,
                             maxiter=self.max_iterations, rtol=rtol,
                             atol=self.atol, precond=precond,
                             orth=self.orth)
        else:
            x, stats = bicgstab(
                matvec, b, maxiter=self.max_iterations,
                rtol=rtol, atol=self.atol, precond=precond)
        return x.reshape(n, ndof), stats

    def _solve_multi(self, J, r: dict, rtol=None):
        from .precond import BlockJacobiPreconditioner, GroupWisePreconditioner

        rtol = self.rtol if rtol is None else rtol
        p = self.preconditioner
        if isinstance(p, TrivialPreconditioner):
            p = GroupWisePreconditioner(BlockJacobiPreconditioner())
        pstate = p.update(J) if isinstance(p, GroupWisePreconditioner) else None

        def matvec(v):
            return J.matvec_flat(v)

        if pstate is not None:
            def precond(v):
                x = J.unflatten_res(v)
                y = p.apply(pstate, J, x)
                return jnp.concatenate([y[n].reshape(-1)
                                        for n in J.layout.names])
        else:
            precond = None

        b = -J.flatten_res(r)
        if self.solver == "gmres":
            x, stats = gmres(matvec, b, restart=self.restart,
                             maxiter=self.max_iterations, rtol=rtol,
                             atol=self.atol, precond=precond,
                             orth=self.orth)
        else:
            x, stats = bicgstab(
                matvec, b, maxiter=self.max_iterations,
                rtol=rtol, atol=self.atol, precond=precond)
        return J.unflatten_dofs(x), stats
