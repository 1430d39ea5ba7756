"""Chebyshev GMG smoother + trilinear prolongation (ops/stencil.py).

SURVEY hard part (a): polynomial smoothing is the data-parallel
alternative to sequential triangular solves — no dot products, so it
also stays communication-free under DD."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jutul.jl_tpu import (
    CartesianMesh,
    compile_model,
    setup_parameters,
    setup_state,
    si_unit,
)
from jutul.jl_tpu.models.darcy import ImmiscibleFluid, setup_darcy_model
from jutul.jl_tpu.models.setup import merge_state
from jutul.jl_tpu.ops.stencil import (
    GMG,
    StencilCompiledModel,
    StencilCPR,
    StencilKrylovSolver,
    _cheby_setup,
    _cheby_smooth,
    _prolong_linear,
)

DARCY = si_unit("darcy")


def _flagship_system(nx=16, ny=16, nz=8, seed=0):
    nc = nx * ny * nz
    rng = np.random.default_rng(seed)
    mesh = CartesianMesh((nx, ny, nz), (100.0, 100.0, 10.0))
    model = setup_darcy_model(
        mesh, ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
        permeability=rng.lognormal(0.0, 1.0, nc) * 0.1 * DARCY,
        porosity=0.25, gravity=True)
    sw = rng.uniform(0.2, 0.8, nc)
    state0 = setup_state(model, Pressure=200e5,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    params = setup_parameters(model)
    comp = compile_model(model)
    sc = StencilCompiledModel(comp)
    st = {k: jnp.asarray(v, jnp.float32) for k, v in state0.items()}
    pr = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    full0 = comp.evaluate_secondaries(merge_state(st, pr))
    st2 = dict(st)
    st2["Pressure"] = (st["Pressure"]
                       * (1 + 2e-3 * rng.normal(size=nc))).astype(np.float32)
    full = comp.evaluate_secondaries(merge_state(st2, pr))
    r, A, _ = sc.assemble(full, full0, 21600.0)
    return r, A


def test_cheby_setup_bounds_spectrum():
    r, A = _flagship_system()
    cpr = StencilCPR(gmg=GMG())
    state = cpr.update(A)
    Ap = state.ops[0]
    dinv, lmax = _cheby_setup(Ap)
    # Gershgorin upper bound: power iteration must stay below it
    v = jnp.asarray(np.random.default_rng(1).normal(size=Ap.n), jnp.float32)
    for _ in range(30):
        v = dinv * Ap.matvec(v)
        v = v / jnp.linalg.norm(v)
    rayleigh = float(jnp.dot(v, dinv * Ap.matvec(v)))
    assert rayleigh <= float(lmax) * (1 + 1e-5)
    assert float(lmax) <= 3.0  # scaled M-matrix: lmax <= 2 (+ slack)


def _numpy_cheby(M, b, u0, n_sweep, lmax, lower=0.25):
    """Saad Alg. 12.1 on D^-1 M over [lower*lmax, lmax], in f64 numpy."""
    dinv = 1.0 / np.diag(M)
    lmin = lower * lmax
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    u = np.zeros_like(b) if u0 is None else u0.copy()
    d = dinv * (b - M @ u) / theta
    u = u + d
    for _ in range(n_sweep - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + 2.0 * rho_new / delta * dinv * (b - M @ u)
        u = u + d
        rho = rho_new
    return u


def _pressure_level():
    from jutul.jl_tpu.ops.stencil import XLAScalarLevel
    from test_stencil_reference import dense_scalar

    r, A = _flagship_system()
    Ap = StencilCPR(gmg=GMG()).update(A).ops[0]
    dinv, lmax = _cheby_setup(Ap)
    return Ap, XLAScalarLevel(Ap), dinv, lmax, dense_scalar(Ap)


def test_cheby_smooth_matches_numpy_recurrence():
    """The XLA Chebyshev smoother (from zero, from a guess, and the
    pre-smoothing residual) == the f64 numpy recurrence."""
    Ap, lv, dinv, lmax, M = _pressure_level()
    b = np.random.default_rng(2).normal(size=Ap.n).astype(np.float32)
    u0 = np.random.default_rng(3).normal(size=Ap.n).astype(np.float32)
    lm = float(lmax)
    scale = lambda ref: np.abs(ref).max()  # noqa: E731

    got = np.asarray(_cheby_smooth(lv, dinv, lmax, None, jnp.asarray(b),
                                   4, 0.25))
    ref = _numpy_cheby(M, b.astype(np.float64), None, 4, lm)
    assert np.abs(got - ref).max() <= 2e-5 * scale(ref)

    got = np.asarray(_cheby_smooth(lv, dinv, lmax, jnp.asarray(u0),
                                   jnp.asarray(b), 3, 0.25))
    ref = _numpy_cheby(M, b.astype(np.float64), u0.astype(np.float64), 3, lm)
    assert np.abs(got - ref).max() <= 2e-5 * scale(ref)

    u = _cheby_smooth(lv, dinv, lmax, None, jnp.asarray(b), 2, 0.25)
    ref = _numpy_cheby(M, b.astype(np.float64), None, 2, lm)
    rr = b - M @ ref
    assert np.abs(np.asarray(lv.residual(u, jnp.asarray(b))) - rr).max() \
        <= 2e-5 * scale(rr) + 2e-5 * scale(b)


def test_prolong_linear_constant_and_gradient():
    """Trilinear prolongation reproduces constants exactly and linear
    fields exactly in the interior (edge-clamped at boundaries)."""
    cL = (4, 4, 4)
    ones = jnp.ones(cL)
    up = _prolong_linear(ones, (8, 8, 8))
    np.testing.assert_allclose(np.asarray(up), 1.0, atol=1e-7)
    zc = jnp.arange(4.0)[:, None, None] * jnp.ones(cL)
    up = np.asarray(_prolong_linear(zc, (8, 8, 8)))
    # interior fine layers: linear in z with slope 1/2 per fine cell
    interior = up[1:-1, 4, 4]
    np.testing.assert_allclose(np.diff(interior), 0.5, atol=1e-6)


@pytest.mark.parametrize("prol", ["injection", "linear"])
def test_cheby_cpr_solves_and_beats_jacobi(prol):
    r, A = _flagship_system(24, 24, 12, seed=4)

    def run(smoother):
        solver = StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=GMG(
                n_smooth=2, n_coarse_sweeps=12, min_cells=512,
                smoother=smoother, prolongation=prol)),
            rtol=1e-3, max_iterations=100)
        du, st = solver.solve(A, jnp.asarray(r))
        assert bool(st["converged"])
        return du, int(st["iterations"])

    du_c, its_c = run("chebyshev")
    du_j, its_j = run("jacobi")
    assert its_c <= its_j, (its_c, its_j)
    # both reach the same linear system solution regime
    resid = lambda du: float(jnp.max(jnp.abs(
        A.matvec(du) + jnp.asarray(r))))
    r0 = float(jnp.max(jnp.abs(r)))
    assert resid(du_c) < 0.1 * r0 and resid(du_j) < 0.1 * r0


def test_amg_chebyshev_on_heat_system():
    """AMGPreconditioner(smoother="chebyshev") on the unstructured
    aggregation hierarchy: converges, with no more Krylov iterations
    than the damped-Jacobi smoothing."""
    from jutul.jl_tpu import (
        DataDomain,
        SimpleHeatSystem,
        SimulationModel,
    )
    from jutul.jl_tpu.linsolve.amg import AMGPreconditioner
    from jutul.jl_tpu.linsolve.krylov import GenericKrylov
    from jutul.jl_tpu.ops.blockell import BlockELL

    n = 1024
    rng = np.random.default_rng(0)
    g = CartesianMesh((32, 32), (1.0, 1.0))
    # rough (lognormal) conductivity: the regime where polynomial
    # smoothing pays; on smooth coefficients the two are within one it
    dom = DataDomain(g, heat_coefficient=rng.lognormal(0.0, 1.5, n))
    model = SimulationModel(dom, SimpleHeatSystem())
    comp = compile_model(model)
    state = {**setup_state(model, T=rng.normal(size=n)),
             **setup_parameters(model)}
    state = comp.evaluate_secondaries(state)
    r = comp.residual(state, {**state, "T": jnp.zeros(n)}, 1e-2)
    J = BlockELL(comp.ell, comp.jacobian_blocks(state, state, 1e-2))

    def run(smoother):
        solver = GenericKrylov(
            "gmres", preconditioner=AMGPreconditioner(smoother=smoother),
            rtol=1e-8, max_iterations=100)
        du, st = solver.solve(J, r)
        assert bool(st["converged"])
        return int(st["iterations"])

    its_c = run("chebyshev")
    its_j = run("jacobi")
    assert its_c <= its_j + 1, (its_c, its_j)


def test_smoothed_aggregation_chebyshev():
    """SmoothedAggregationAMG(smoother="chebyshev") converges on the
    heterogeneous heat system within one iteration of jacobi."""
    from jutul.jl_tpu import (
        DataDomain,
        SimpleHeatSystem,
        SimulationModel,
    )
    from jutul.jl_tpu.linsolve.amg import SmoothedAggregationAMG
    from jutul.jl_tpu.linsolve.krylov import GenericKrylov
    from jutul.jl_tpu.ops.blockell import BlockELL

    n = 1024
    rng = np.random.default_rng(0)
    g = CartesianMesh((32, 32), (1.0, 1.0))
    dom = DataDomain(g, heat_coefficient=rng.lognormal(0.0, 1.5, n))
    model = SimulationModel(dom, SimpleHeatSystem())
    comp = compile_model(model)
    state = {**setup_state(model, T=rng.normal(size=n)),
             **setup_parameters(model)}
    state = comp.evaluate_secondaries(state)
    r = comp.residual(state, {**state, "T": jnp.zeros(n)}, 1e-2)
    J = BlockELL(comp.ell, comp.jacobian_blocks(state, state, 1e-2))

    def run(smoother):
        p = SmoothedAggregationAMG(smoother=smoother)
        p.update(J)  # concrete first update builds the hierarchy
        solver = GenericKrylov("gmres", preconditioner=p, rtol=1e-8,
                               max_iterations=100)
        du, st = solver.solve(J, r)
        assert bool(st["converged"])
        return int(st["iterations"])

    its_c = run("chebyshev")
    its_j = run("jacobi")
    assert its_c <= its_j + 1, (its_c, its_j)


def test_chebyshev_through_simulate_jit():
    """The whole-schedule product path (simulate_jit) with the
    Chebyshev-smoothed CPR matches the Jacobi-smoothed run."""
    from jutul.jl_tpu import Simulator
    from jutul.jl_tpu.models.darcy import PhaseSourceTerm

    nx, ny, nz = 8, 8, 4
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny, nz), (50.0, 50.0, 5.0))
    model = setup_darcy_model(
        mesh, ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
        permeability=rng.lognormal(0.0, 1.0, nc) * 1e-13,
        porosity=0.25, gravity=True)
    sw = rng.uniform(0.2, 0.8, nc)
    state0 = setup_state(model, Pressure=200e5,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    forces = {"w": PhaseSourceTerm([0, nc - 1],
                                   np.array([[5e-4, 0.0],
                                             [-2e-4, -2e-4]]))}

    def run(smoother):
        solver = StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=GMG(
                n_smooth=2, min_cells=64,
                smoother=smoother, prolongation="linear")),
            rtol=1e-6, max_iterations=60)
        sim = Simulator(model, state0=state0, use_stencil=True)
        res = sim.simulate_jit(
            [21600.0], forces=forces, linear_solver=solver,
            tolerances={"mass_conservation/CNV": 1e-3,
                        "mass_conservation/MB": 1e-6},
            max_nonlinear_iterations=12, info_level=-1)
        return np.asarray(res.states[-1]["Pressure"])

    p_c = run("chebyshev")
    p_j = run("jacobi")
    assert np.all(np.isfinite(p_c))
    rel = np.max(np.abs(p_c - p_j)) / np.max(np.abs(p_j))
    assert rel < 1e-4, rel


def test_cheby_coarsest_level_matches_numpy_recurrence():
    """A single-level Chebyshev V-cycle is n_coarse_sweeps steps of the
    recurrence from zero (the coarse-solve branch of GMG.vcycle)."""
    Ap, lv, dinv, lmax, M = _pressure_level()
    b = np.random.default_rng(6).normal(size=Ap.n).astype(np.float32)
    gmg = GMG(n_coarse_sweeps=12, min_cells=Ap.n, smoother="chebyshev")
    ops = gmg.hierarchy(Ap)
    assert len(ops) == 1
    got = np.asarray(gmg.vcycle(ops, jnp.asarray(b)))
    ref = _numpy_cheby(M, b.astype(np.float64), None, 12, float(lmax))
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
