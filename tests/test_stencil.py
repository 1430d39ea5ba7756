"""Structured stencil fast path vs generic engine (must agree exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest

from jutul.jl_tpu import CartesianMesh, compile_model, setup_parameters, \
    setup_state, si_unit
from jutul.jl_tpu.models.darcy import ImmiscibleFluid, setup_darcy_model
from jutul.jl_tpu.models.setup import merge_state
from jutul.jl_tpu.ops.blockell import BlockELL, ell_to_dense
from jutul.jl_tpu.ops.stencil import (
    GMG,
    ScalarStencil,
    StencilCPR,
    StencilCompiledModel,
    _coarsen_scalar,
)

BAR = si_unit("bar")
DARCY = si_unit("darcy")


def darcy_setup(nx=6, ny=5, nz=4):
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny, nz), (6.0, 5.0, 4.0))
    model = setup_darcy_model(
        mesh, ImmiscibleFluid(viscosities=(1e-3, 3e-3)),
        permeability=rng.lognormal(0, 1, nc) * 0.1 * DARCY,
        porosity=0.25, gravity=False)
    sw = rng.uniform(0.1, 0.9, nc)
    state0 = setup_state(model, Pressure=100 * BAR + rng.uniform(-1, 1, nc) * BAR,
                         Saturations=np.stack([sw, 1 - sw], 1))
    params = setup_parameters(model)
    comp = compile_model(model)
    full = comp.evaluate_secondaries(merge_state(
        {k: jnp.asarray(v) for k, v in state0.items()},
        {k: jnp.asarray(v) for k, v in params.items()}))
    full0 = dict(full)
    full0["Saturations"] = jnp.roll(full["Saturations"], 1, axis=0)
    full0 = comp.evaluate_secondaries(full0)
    return comp, full, full0


def test_stencil_residual_matches_generic():
    comp, full, full0 = darcy_setup()
    sc = StencilCompiledModel(comp)
    dt = 1e4
    r_gen = np.asarray(comp.residual(full, full0, dt))
    r_st = np.asarray(sc.residual(full, full0, dt))
    assert np.allclose(r_st, r_gen, rtol=1e-12, atol=1e-18)


def test_stencil_jacobian_matvec_matches_generic():
    comp, full, full0 = darcy_setup()
    sc = StencilCompiledModel(comp)
    dt = 1e4
    blocks = comp.jacobian_blocks(full, full0, dt)
    J = BlockELL(comp.ell, blocks)
    A = sc.jacobian(full, full0, dt)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(comp.n_cells, comp.ndof)))
    y_gen = np.asarray(J.matvec(x))
    y_st = np.asarray(A.matvec(x))
    assert np.allclose(y_st, y_gen, rtol=1e-10, atol=1e-12)


def poisson_stencil(nz=8, ny=8, nx=8):
    """SPD 7-point Laplacian stencil for GMG tests."""
    L = (nz, ny, nx)
    n = nz * ny * nx
    plus, minus = {}, {}
    diag = jnp.full(n, 1e-8)  # slight regularization
    diag_lat = diag.reshape(L)
    for a, fl in ((0, (nz, ny, nx - 1)), (1, (nz, ny - 1, nx)),
                  (2, (nz - 1, ny, nx))):
        t = jnp.ones(fl)
        plus[a] = -t
        minus[a] = -t
        from jutul.jl_tpu.ops.stencil import _PADS, _PADS_R

        diag_lat = diag_lat + jnp.pad(t, _PADS[a]) + jnp.pad(t, _PADS_R[a])
    return ScalarStencil(L, diag_lat.reshape(-1), plus, minus)


def test_scalar_stencil_matvec_symmetry():
    A = poisson_stencil(4, 4, 4)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=64))
    y = jnp.asarray(rng.normal(size=64))
    assert np.isclose(float(x @ A.matvec(y)), float(y @ A.matvec(x)))
    # constant vector is (nearly) in the nullspace of the pure Laplacian
    ones = jnp.ones(64)
    assert np.allclose(np.asarray(A.matvec(ones)), 1e-8, atol=1e-12)


def test_galerkin_coarsening_exact():
    """A_c x_c == restrict(A prolong(x_c)) for pw-constant transfer."""
    A = poisson_stencil(4, 4, 4)
    Ac = _coarsen_scalar(A)
    rng = np.random.default_rng(0)
    xc = rng.normal(size=Ac.n)
    # prolong -> fine matvec -> restrict
    e = jnp.asarray(xc).reshape(Ac.L)
    for axis in range(3):
        e = jnp.repeat(e, 2, axis=axis)
    y_fine = A.matvec(e.reshape(-1)).reshape(A.L)
    rc = y_fine
    from jutul.jl_tpu.ops.stencil import _fold

    for axis in range(3):
        rc = _fold(rc, axis)
    got = np.asarray(Ac.matvec(jnp.asarray(xc)))
    assert np.allclose(got, np.asarray(rc).reshape(-1), rtol=1e-12)


def test_galerkin_coarsening_exact_factor4():
    """f=4 aggressive coarsening: A_c x_c == restrict(A prolong(x_c))
    for pw-constant transfer with 4x4x4 blocks (one hop replaces two 2x
    levels)."""
    A = poisson_stencil(8, 4, 8)
    Ac = _coarsen_scalar(A, 4)
    assert Ac.L == (2, 1, 2)
    rng = np.random.default_rng(1)
    xc = rng.normal(size=Ac.n)
    e = jnp.asarray(xc).reshape(Ac.L)
    for axis, n in enumerate(A.L):
        if n > 1:
            e = jnp.repeat(e, 4, axis=axis)
    y_fine = A.matvec(e.reshape(-1)).reshape(A.L)
    rc = y_fine
    from jutul.jl_tpu.ops.stencil import _fold

    for axis, n in enumerate(A.L):
        if n > 1:
            rc = _fold(rc, axis, 4)
    got = np.asarray(Ac.matvec(jnp.asarray(xc)))
    assert np.allclose(got, np.asarray(rc).reshape(-1), rtol=1e-12)


def test_galerkin_coarsening_factor4_padded():
    """Odd/non-multiple dims pad with identity rows and stay exact on the
    real part: compare the f=4 coarse operator's action restricted to
    real cells via the padded fine operator."""
    A = poisson_stencil(6, 3, 5)  # none a multiple of 4
    from jutul.jl_tpu.ops.stencil import _fold, _pad_even

    Apad = _pad_even(A, 4)
    Ac = _coarsen_scalar(A, 4)
    assert Ac.L == (2, 1, 2)
    rng = np.random.default_rng(2)
    xc = rng.normal(size=Ac.n)
    e = jnp.asarray(xc).reshape(Ac.L)
    for axis, n in enumerate(Apad.L):
        if n > 1:
            e = jnp.repeat(e, 4, axis=axis)
    y_fine = Apad.matvec(e.reshape(-1)).reshape(Apad.L)
    rc = y_fine
    for axis, n in enumerate(Apad.L):
        if n > 1:
            rc = _fold(rc, axis, 4)
    got = np.asarray(Ac.matvec(jnp.asarray(xc)))
    assert np.allclose(got, np.asarray(rc).reshape(-1), rtol=1e-12)


def test_gmg_factor4_solves_poisson():
    """The 2-level f=4 V-cycle still converges on Poisson (weaker than
    f=2 per cycle, but convergent — it backs the flagship's cheap
    cycle)."""
    A = poisson_stencil(16, 16, 16)
    gmg = GMG(n_smooth=2, n_coarse_sweeps=50, coarsen_factor=4,
              min_cells=64)
    ops = gmg.hierarchy(A)
    assert [o.L for o in ops] == [(16, 16, 16), (4, 4, 4)]
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=A.n))
    b = b - jnp.mean(b)
    u = jnp.zeros(A.n)
    r0 = float(jnp.linalg.norm(b))
    for _ in range(20):
        r = b - A.matvec(u)
        u = u + gmg.vcycle(ops, r)
    rN = float(jnp.linalg.norm(b - A.matvec(u)))
    assert rN < 0.05 * r0


def test_gmg_solves_poisson():
    A = poisson_stencil(8, 8, 8)
    gmg = GMG(n_smooth=2, n_coarse_sweeps=50)
    ops = gmg.hierarchy(A)
    assert len(ops) >= 2
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=A.n))
    b = b - jnp.mean(b)  # compatible RHS
    u = jnp.zeros(A.n)
    r0 = float(jnp.linalg.norm(b))
    for _ in range(10):
        r = b - A.matvec(u)
        u = u + gmg.vcycle(ops, r)
    rN = float(jnp.linalg.norm(b - A.matvec(u)))
    # piecewise-constant (unsmoothed-aggregation) transfer converges at
    # ~0.5-0.7 per V-cycle - adequate for the CPR pressure stage
    assert rN < 0.05 * r0


def test_stencil_cpr_reduces_residual():
    comp, full, full0 = darcy_setup(8, 8, 4)
    sc = StencilCompiledModel(comp)
    dt = 1e4
    r = sc.residual(full, full0, dt)
    A = sc.jacobian(full, full0, dt)
    cpr = StencilCPR()
    state = cpr.update(A)
    du = cpr.apply(state, A, -r)
    r1 = np.asarray(-r - A.matvec(du))
    # one CPR application contracts the residual
    assert np.linalg.norm(r1) < 0.6 * np.linalg.norm(np.asarray(r))


def test_simulator_stencil_path_matches_generic():
    """Simulator(use_stencil=True) + StencilKrylovSolver reproduces the
    generic path end-to-end."""
    from jutul.jl_tpu import Simulator, simulate
    from jutul.jl_tpu.models.darcy import PhaseSourceTerm
    from jutul.jl_tpu.ops.stencil import StencilKrylovSolver

    nc = 6 * 5 * 4
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((6, 5, 4), (6.0, 5.0, 4.0))
    model = setup_darcy_model(
        mesh, ImmiscibleFluid(viscosities=(1e-3, 3e-3)),
        permeability=rng.lognormal(0, 1, nc) * 0.5 * DARCY,
        porosity=0.25, gravity=False)
    sw = rng.uniform(0.2, 0.8, nc)
    state0 = setup_state(model, Pressure=100 * BAR,
                         Saturations=np.stack([sw, 1 - sw], 1))
    forces = {"src": PhaseSourceTerm([0], np.array([[0.01, 0.0]]))}
    DAY = si_unit("day")
    dts = [0.1 * DAY] * 2

    s_gen, _ = simulate(state0, model, dts, forces=forces, info_level=-1)
    sim = Simulator(model, state0=state0, use_stencil=True)
    s_st, rep = sim.simulate(dts, forces=forces, info_level=-1,
                             linear_solver=StencilKrylovSolver(rtol=1e-11))
    assert all(r["success"] for r in rep)
    assert np.allclose(s_gen[-1]["Pressure"], s_st[-1]["Pressure"], rtol=1e-7)
    assert np.allclose(s_gen[-1]["Saturations"], s_st[-1]["Saturations"],
                       atol=1e-8)


def test_three_phase_stencil_cpr():
    """StencilCPR general NxN blocks (r2: the 2x2 hard-limit is gone):
    a three-phase model runs through Simulator(use_stencil=True) +
    StencilKrylovSolver and matches the generic-path solution."""
    import numpy as np

    from jutul.jl_tpu import CartesianMesh, Simulator, si_unit
    from jutul.jl_tpu.models.darcy import (
        ImmiscibleFluid,
        PhaseSourceTerm,
        setup_darcy_model,
    )
    from jutul.jl_tpu.models.setup import setup_parameters, setup_state
    from jutul.jl_tpu.ops.stencil import GMG, StencilCPR, StencilKrylovSolver

    BAR = si_unit("bar")
    nx, ny, nz = 6, 5, 4
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny, nz), (60.0, 50.0, 20.0))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3, 5e-4),
                            reference_densities=(1000.0, 800.0, 100.0),
                            compressibilities=(1e-9, 1e-9, 5e-9),
                            corey_exponents=(2.0, 2.0, 2.0),
                            residual_saturations=(0.0, 0.0, 0.0))
    model = setup_darcy_model(
        mesh, fluid,
        permeability=rng.uniform(0.2, 1.0, nc) * si_unit("darcy"),
        porosity=0.25, gravity=False)
    s = rng.uniform(0.2, 0.5, (nc, 3))
    s = s / s.sum(axis=1, keepdims=True)
    state0 = setup_state(model, Pressure=100.0 * BAR, Saturations=s)
    params = setup_parameters(model)
    q = np.array([[0.01, 0.0, 0.0]])
    forces = {"src": PhaseSourceTerm([0], q)}
    dts = [3600.0, 7200.0]
    kw = dict(forces=forces, info_level=-1,
              tolerances={"mass_conservation": 1e-9},
              max_nonlinear_iterations=25)

    sim_ref = Simulator(model, state0=state0, parameters=params)
    ref = sim_ref.simulate(dts, **kw)

    sim_st = Simulator(model, state0=state0, parameters=params,
                       use_stencil=True)
    solver = StencilKrylovSolver(
        preconditioner=StencilCPR(gmg=GMG(min_cells=8, n_coarse_sweeps=20)),
        rtol=1e-12, max_iterations=300)
    st = sim_st.simulate(dts, linear_solver=solver, **kw)

    assert all(r["success"] for r in ref.reports + st.reports)
    np.testing.assert_allclose(np.asarray(st.states[-1]["Pressure"]),
                               np.asarray(ref.states[-1]["Pressure"]),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st.states[-1]["Saturations"]),
                               np.asarray(ref.states[-1]["Saturations"]),
                               atol=1e-8)
