"""Shared Chebyshev relaxation core.

One implementation of the 3-term recurrence (Saad Alg. 12.1 adapted to
a diagonally preconditioned operator) used by the lattice GMG
(ops/stencil.py), the aggregation/SA AMG (linsolve/amg.py) and the
distributed CPR fine level (parallel/general_cpr.py). Keeping the
interval logic here means a safeguard or interval change lands
everywhere at once.

Convention for zero/dead diagonal rows: dinv = 0 (the row never
updates).
"""
from __future__ import annotations


def chebyshev_recurrence(prec_residual, rhs_prec0, u0, n_sweep: int,
                         lmax, lower: float = 0.25):
    """``n_sweep`` Chebyshev steps on the interval [lower*lmax, lmax].

    ``prec_residual(u)`` returns the diagonally preconditioned residual
    D^-1 (rhs - A u); ``rhs_prec0`` is its value at u = 0 (usually just
    ``dinv * rhs`` — elementwise, the same free first sweep the Jacobi
    smooth-from-zero exploits). ``u0=None`` starts from zero.
    """
    lmin = lower * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = rhs_prec0 if u0 is None else prec_residual(u0)
    d = r / theta
    u = d if u0 is None else u0 + d
    for _ in range(1, n_sweep):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = prec_residual(u)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        u = u + d
        rho = rho_new
    return u
