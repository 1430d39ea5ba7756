"""Fully-jitted Newton / timestep paths vs the eager simulator.

Covers VERDICT r1 items: in-jit relaxation + check-before-solve ministep,
in-jit dt cutting (jit_timestep), use_stencil + StencilKrylovSolver driven
through simulate(), and extra_timing instrumentation feeding report_stats /
timing_breakdown (reference report timing embedding, simulator.jl:427-507).
"""

import numpy as np
import pytest

from jutul.jl_tpu import (
    CartesianMesh,
    SimpleRelaxation,
    Simulator,
    report_stats,
    si_unit,
    timing_breakdown,
)
from jutul.jl_tpu.linsolve.krylov import GenericKrylov
from jutul.jl_tpu.linsolve.precond import ILU0Preconditioner
from jutul.jl_tpu.models.darcy import ImmiscibleFluid, setup_darcy_model
from jutul.jl_tpu.models.setup import setup_parameters, setup_state

BAR = si_unit("bar")
DAY = si_unit("day")
DARCY = si_unit("darcy")


def darcy_case(nx=6, ny=5, nz=2, seed=0):
    nc = nx * ny * nz
    rng = np.random.default_rng(seed)
    mesh = CartesianMesh((nx, ny, nz), (30.0, 30.0, 6.0))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = setup_darcy_model(
        mesh, fluid,
        permeability=rng.uniform(0.2, 1.0, nc) * DARCY,
        porosity=0.3,
        gravity=True,
    )
    sw = rng.uniform(0.25, 0.75, nc)
    state0 = setup_state(
        model,
        Pressure=150.0 * BAR + rng.uniform(-2, 2, nc) * BAR,
        Saturations=np.stack([sw, 1 - sw], axis=1),
    )
    return model, state0, setup_parameters(model)


def final_pressure(states):
    return np.asarray(states[-1]["Pressure"])


def test_jit_ministep_matches_eager():
    model, state0, params = darcy_case()
    dts = [0.5 * DAY, 1.0 * DAY]
    kw = dict(relaxation=SimpleRelaxation(), info_level=-1,
              tolerances={"default": 1e-7})
    sim_e = Simulator(model, state0=state0, parameters=params)
    st_e, rep_e = sim_e.simulate(dts, **kw)
    sim_j = Simulator(model, state0=state0, parameters=params)
    st_j, rep_j = sim_j.simulate(dts, jit_ministep=True, **kw)
    p_e, p_j = final_pressure(st_e), final_pressure(st_j)
    assert np.allclose(p_e, p_j, rtol=1e-8)
    s_e = np.asarray(st_e[-1]["Saturations"])
    s_j = np.asarray(st_j[-1]["Saturations"])
    assert np.allclose(s_e, s_j, atol=1e-9)
    # iteration counts agree (same convergence decisions)
    its_e = [m["iterations"] for r in rep_e for m in r["ministeps"]]
    its_j = [m["iterations"] for r in rep_j for m in r["ministeps"]]
    assert its_e == its_j
    # linear iteration counts are reported by the jit path
    assert all(m["linear_iterations"] >= 1
               for r in rep_j for m in r["ministeps"])


def test_jit_timestep_in_jit_cutting_and_equivalence():
    model, state0, params = darcy_case(seed=3)
    # big dt + tight iteration budget forces at least one in-jit cut
    dts = [60.0 * DAY]
    kw = dict(info_level=-1, max_nonlinear_iterations=4,
              tolerances={"default": 1e-8})
    sim_e = Simulator(model, state0=state0, parameters=params)
    st_e, rep_e = sim_e.simulate(dts, **kw)
    sim_j = Simulator(model, state0=state0, parameters=params)
    st_j, rep_j = sim_j.simulate(dts, jit_timestep=True, **kw)
    minis_e = rep_e[0]["ministeps"]
    minis_j = rep_j[0]["ministeps"]
    assert any(not m["success"] for m in minis_j), \
        "expected an in-jit dt cut"
    assert [m["success"] for m in minis_e] == [m["success"] for m in minis_j]
    assert np.allclose([m["dt"] for m in minis_e],
                       [m["dt"] for m in minis_j], rtol=1e-12)
    assert np.allclose(final_pressure(st_e), final_pressure(st_j), rtol=1e-8)


def test_jit_timestep_abort_on_exhausted_cuts():
    model, state0, params = darcy_case(seed=4)
    sim = Simulator(model, state0=state0, parameters=params)
    states, reports = sim.simulate(
        [50.0 * DAY], jit_timestep=True, info_level=-1,
        max_nonlinear_iterations=1, max_timestep_cuts=2,
        tolerances={"default": 1e-14})
    assert reports[-1]["success"] is False
    assert len(states) == 0


def test_stencil_krylov_through_simulate():
    """use_stencil + StencilKrylovSolver driven by simulate() (the product
    path the 1M-cell bench uses) matches the generic engine."""
    from jutul.jl_tpu.ops.stencil import GMG, StencilCPR, StencilKrylovSolver

    model, state0, params = darcy_case(nx=8, ny=8, nz=4, seed=1)
    dts = [1.0 * DAY, 2.0 * DAY]
    kw = dict(info_level=-1, tolerances={"default": 1e-7})
    sim_ref = Simulator(model, state0=state0, parameters=params)
    st_ref, _ = sim_ref.simulate(
        dts, linear_solver=GenericKrylov(
            "bicgstab", preconditioner=ILU0Preconditioner(), rtol=1e-10),
        **kw)
    solver = StencilKrylovSolver(
        preconditioner=StencilCPR(gmg=GMG(n_smooth=2, min_cells=8)),
        rtol=1e-10, max_iterations=200)
    sim_st = Simulator(model, state0=state0, parameters=params,
                       use_stencil=True)
    st_st, rep_st = sim_st.simulate(dts, linear_solver=solver,
                                    jit_ministep=True, **kw)
    assert np.allclose(final_pressure(st_ref), final_pressure(st_st),
                       rtol=1e-6)
    s_ref = np.asarray(st_ref[-1]["Saturations"])
    s_st = np.asarray(st_st[-1]["Saturations"])
    assert np.allclose(s_ref, s_st, atol=1e-7)


def test_extra_timing_and_breakdown():
    model, state0, params = darcy_case(seed=2)
    sim = Simulator(model, state0=state0, parameters=params)
    states, reports = sim.simulate([1.0 * DAY], extra_timing=True,
                                   info_level=-1)
    mini = reports[0]["ministeps"][0]
    assert {"assembly", "convergence", "linear_solve", "update"} <= set(
        mini["timings"])
    stats = report_stats(reports)
    assert stats["timings"]["assembly"] > 0
    tb = timing_breakdown(reports)
    fracs = sum(v["fraction"] for k, v in tb.items() if isinstance(v, dict))
    assert abs(fracs - 1.0) < 1e-9


def test_simulate_jit_schedule_matches_eager():
    """Whole-schedule single-program runner (the bench path) matches
    the eager simulator and feeds report_stats."""
    from jutul.jl_tpu.models.darcy import PhaseSourceTerm

    model, state0, params = darcy_case(seed=5)
    nc = len(np.asarray(state0["Pressure"]))
    forces = {"sources": PhaseSourceTerm(
        [0, nc - 1], np.array([[1e-4, 0.0], [-5e-5, -5e-5]]))}
    dts = [0.5 * DAY, 1.0 * DAY, 2.0 * DAY]
    kw = dict(info_level=-1, tolerances={"default": 1e-7})
    sim_e = Simulator(model, state0=state0, parameters=params)
    st_e, rep_e = sim_e.simulate(dts, forces=forces, **kw)
    sim_j = Simulator(model, state0=state0, parameters=params)
    st_j, rep_j = sim_j.simulate_jit(dts, forces=forces, **kw)
    assert np.allclose(final_pressure(st_e), final_pressure(st_j), rtol=1e-8)
    its_e = [m["iterations"] for r in rep_e for m in r["ministeps"]]
    its_j = [m["iterations"] for r in rep_j for m in r["ministeps"]]
    assert its_e == its_j
    stats = report_stats(rep_j)
    assert stats["newtons"] == sum(its_j)
    assert stats["linear_iterations"] >= stats["newtons"]


def test_simulate_jit_output_states_per_step():
    """jit_output_states stacks an output state per report step inside the
    scan (reference behavior: simulate stores every report state); states
    match the eager simulator step by step."""
    from jutul.jl_tpu.models.darcy import PhaseSourceTerm

    model, state0, params = darcy_case(seed=7)
    nc = len(np.asarray(state0["Pressure"]))
    forces = {"sources": PhaseSourceTerm(
        [0, nc - 1], np.array([[1e-4, 0.0], [-5e-5, -5e-5]]))}
    dts = [0.5 * DAY, 1.0 * DAY, 2.0 * DAY]
    kw = dict(info_level=-1, tolerances={"default": 1e-7})
    sim_e = Simulator(model, state0=state0, parameters=params)
    st_e, _ = sim_e.simulate(dts, forces=forces, **kw)
    sim_j = Simulator(model, state0=state0, parameters=params)
    st_j, rep_j = sim_j.simulate_jit(dts, forces=forces,
                                     jit_output_states=True, **kw)
    assert len(st_j) == len(dts)
    for se, sj in zip(st_e, st_j):
        assert np.allclose(np.asarray(se["Pressure"]),
                           np.asarray(sj["Pressure"]), rtol=1e-8)
        assert np.allclose(np.asarray(se["Saturations"]),
                           np.asarray(sj["Saturations"]), atol=1e-10)
    # "primary" selection applies per step too
    sim_p = Simulator(model, state0=state0, parameters=params)
    st_p, _ = sim_p.simulate_jit(dts, forces=forces,
                                 jit_output_states=True,
                                 output_variables="primary", **kw)
    assert len(st_p) == len(dts)
    assert set(st_p[0]) <= set(model.primary_variables) | set(
        model.output_variables)


def test_relaxation_jit_matches_python():
    import jax.numpy as jnp

    relax = SimpleRelaxation()
    omega = 1.0
    errors = []
    for err in [10.0, 9.99, 5.0, 5.2, 1.0]:
        errors.append(err)
        prev = errors[-2] if len(errors) >= 2 else float("inf")
        py = relax.select_relaxation(omega, errors)
        jt = float(relax.select_relaxation_jit(
            jnp.asarray(omega), jnp.asarray(err), jnp.asarray(prev)))
        assert np.isclose(py, jt), (err, py, jt)
        omega = py


def test_eisenstat_walker_forcing():
    """linear_forcing="ew" adapts the Krylov rtol inside the jitted
    Newton: same converged answer, fewer total linear iterations than a
    tight fixed-rtol solve."""
    import numpy as np

    from jutul.jl_tpu import CartesianMesh, Simulator, si_unit
    from jutul.jl_tpu.linsolve.krylov import GenericKrylov
    from jutul.jl_tpu.linsolve.precond import ILU0Preconditioner
    from jutul.jl_tpu.models.darcy import (
        ImmiscibleFluid,
        PhaseSourceTerm,
        setup_darcy_model,
    )
    from jutul.jl_tpu.models.setup import setup_parameters, setup_state

    BAR = si_unit("bar")
    nx, ny = 10, 8
    nc = nx * ny
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny), (100.0, 80.0))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = setup_darcy_model(
        mesh, fluid, permeability=rng.uniform(0.2, 1.0, nc) * si_unit("darcy"),
        porosity=0.25, gravity=False)
    sw = rng.uniform(0.3, 0.7, nc)
    state0 = setup_state(model, Pressure=100 * BAR,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    params = setup_parameters(model)
    forces = {"src": PhaseSourceTerm([0], np.array([[0.02, 0.0]]))}
    dts = [3600.0, 7200.0]

    def run(**cfg):
        sim = Simulator(model, state0=state0, parameters=params)
        solver = GenericKrylov("bicgstab",
                               preconditioner=ILU0Preconditioner(),
                               rtol=1e-10, max_iterations=200)
        res = sim.simulate(dts, forces=forces, info_level=-1,
                           jit_ministep=True, linear_solver=solver,
                           tolerances={"mass_conservation": 1e-8},
                           max_nonlinear_iterations=20, **cfg)
        assert all(r["success"] for r in res.reports)
        lin = sum(m["linear_iterations"] for r in res.reports
                  for m in r["ministeps"])
        return res.states[-1], lin

    s_fixed, lin_fixed = run()
    s_ew, lin_ew = run(linear_forcing="ew")
    np.testing.assert_allclose(np.asarray(s_ew["Pressure"]),
                               np.asarray(s_fixed["Pressure"]), rtol=1e-7)
    assert lin_ew < lin_fixed, (lin_ew, lin_fixed)


def test_ew_forcing_with_default_and_schur_solvers():
    """linear_forcing='ew' must work with solvers that ignore rtol
    (DirectSolver default; Schur for grouped multimodels) — regression:
    their solve() signatures lacked the rtol override."""
    model, state0, params = darcy_case(nx=4, ny=3, nz=2)
    sim = Simulator(model, state0=state0, parameters=params)
    res = sim.simulate([0.5 * DAY], jit_ministep=True, linear_forcing="ew",
                       info_level=-1, tolerances={"default": 1e-8})
    assert res.reports[-1]["success"]

    from jutul.jl_tpu import SchurComplementSolver
    from jutul.jl_tpu.models.test_systems import (
        ScalarTestCrossTerm,
        ScalarTestDomain,
        ScalarTestForce,
        ScalarTestSystem,
    )
    from jutul.jl_tpu.models.forces import setup_forces
    from jutul.jl_tpu.multimodel.core import MultiModel
    from jutul.jl_tpu import SimulationModel as SM, setup_state as st

    A = SM(ScalarTestDomain(), ScalarTestSystem())
    B = SM(ScalarTestDomain(), ScalarTestSystem())
    mm = MultiModel({"A": A, "B": B})
    mm.add_cross_term(ScalarTestCrossTerm(), target="A", source="B",
                      equation="test_equation")
    s0 = st(mm, A=st(A, XVar=0.0), B=st(B, XVar=0.0))
    forces = setup_forces(mm, A=setup_forces(A, sources=ScalarTestForce(1.0)),
                          B=setup_forces(B, sources=ScalarTestForce(-1.0)))
    sim2 = Simulator(mm, state0=s0)
    res2 = sim2.simulate([0.5], forces=forces, jit_ministep=True,
                         linear_forcing="ew",
                         linear_solver=SchurComplementSolver(
                             elim_models=["B"]),
                         info_level=-1, tolerances={"default": 1e-10})
    assert res2.reports[-1]["success"]


def test_jit_config_change_rebuilds_programs():
    """Regression: jitted ministep/timestep/schedule closures bake the
    config in; a new config must invalidate them (previously the first
    call's tolerances were silently reused)."""
    model, state0, params = darcy_case(seed=6)
    sim = Simulator(model, state0=state0, parameters=params)
    res_loose = sim.simulate_jit([1.0 * DAY], tolerances={"default": 1e-2},
                                 info_level=-1)
    its_loose = sum(m["iterations"] for r in res_loose.reports
                    for m in r["ministeps"])
    res_tight = sim.simulate_jit([1.0 * DAY], tolerances={"default": 1e-9},
                                 info_level=-1)
    its_tight = sum(m["iterations"] for r in res_tight.reports
                    for m in r["ministeps"])
    assert its_tight > its_loose, (its_tight, its_loose)


def test_simulate_jit_per_step_forces():
    """Per-step force schedules through the single-program path (r3:
    VERDICT item 7 — stacked force pytrees scanned with the dt array;
    reference: per-step forces in a case, core_types.jl:946-1045)."""
    from jutul.jl_tpu.models.darcy import PhaseSourceTerm

    model, state0, params = darcy_case()
    dts = [0.5 * DAY, 0.5 * DAY, 0.5 * DAY]
    # changing well schedule: rates vary per report step, structure fixed
    schedule = [
        {"src": PhaseSourceTerm([0, 10], np.array([[0.02, 0.0],
                                                   [0.01, 0.0]]))},
        {"src": PhaseSourceTerm([0, 10], np.array([[0.0, 0.0],
                                                   [0.03, 0.0]]))},
        {"src": PhaseSourceTerm([0, 10], np.array([[-0.01, -0.01],
                                                   [0.02, 0.0]]))},
    ]
    kw = dict(info_level=-1, tolerances={"default": 1e-8},
              max_nonlinear_iterations=25)
    sim_e = Simulator(model, state0=state0, parameters=params)
    st_e, _ = sim_e.simulate(dts, forces=schedule, **kw)

    sim_j = Simulator(model, state0=state0, parameters=params)
    res = sim_j.simulate_jit(dts, forces=schedule, **kw)
    np.testing.assert_allclose(final_pressure(res.states),
                               final_pressure(st_e), rtol=1e-8)
    assert all(r["success"] for r in res.reports)

    # structure changes between steps -> clear error, not silence
    bad = [{"src": PhaseSourceTerm([0], np.array([[0.02, 0.0]]))},
           {"src": PhaseSourceTerm([3], np.array([[0.02, 0.0]]))},
           {"src": PhaseSourceTerm([3], np.array([[0.02, 0.0]]))}]
    with pytest.raises(NotImplementedError, match="structure"):
        sim_j.simulate_jit(dts, forces=bad, **kw)


def test_output_variables_option():
    """output_variables config: "primary" matches the reference's storage
    behavior (primaries + model output variables, models.jl:249); a list
    keeps named secondaries alongside the primaries; identical physics
    on both the eager and the whole-schedule jit paths."""
    model, state0, params = darcy_case()
    dts = [0.5 * DAY, 1.0 * DAY]
    kw = dict(info_level=-1)
    st_all, _ = Simulator(model, state0=state0, parameters=params).simulate(
        dts, **kw)
    st_pri, _ = Simulator(model, state0=state0, parameters=params).simulate(
        dts, output_variables="primary", **kw)
    assert set(st_pri[-1]) == {"Pressure", "Saturations"}
    assert "PhaseMassDensities" in st_all[-1]
    assert np.allclose(final_pressure(st_all), final_pressure(st_pri))
    st_lst, _ = Simulator(model, state0=state0, parameters=params).simulate(
        dts, output_variables=["PhaseMobilities"], **kw)
    assert set(st_lst[-1]) == {"Pressure", "Saturations", "PhaseMobilities"}
    # a BARE STRING is one variable name, not an iterable of characters
    st_str, _ = Simulator(model, state0=state0, parameters=params).simulate(
        dts, output_variables="PhaseMobilities", **kw)
    assert set(st_str[-1]) == {"Pressure", "Saturations", "PhaseMobilities"}
    res_j = Simulator(model, state0=state0, parameters=params).simulate_jit(
        dts, output_variables="primary", **kw)
    assert set(res_j.states[-1]) == {"Pressure", "Saturations"}
    assert np.allclose(final_pressure(res_j.states),
                       final_pressure(st_pri), rtol=1e-6)


def test_prepare_step_hook_eager_and_jit_guard():
    """prepare_step runs on the eager path and raises on both jit paths
    (ADVICE r3: the hook must not be silently ignored under jit)."""
    model, state0, params = darcy_case()
    dts = [0.5 * DAY]
    calls = []

    def prepare(state, dt, it):
        calls.append(it)
        return None  # observe-only hook

    sim = Simulator(model, state0=state0, parameters=params)
    sim.simulate(dts, info_level=-1, prepare_step=prepare)
    assert calls and calls[0] == 0

    for jit_kw in ({"jit_ministep": True}, {"jit_timestep": True}):
        sim2 = Simulator(model, state0=state0, parameters=params)
        with pytest.raises(ValueError, match="prepare_step|hooks"):
            sim2.simulate(dts, info_level=-1, prepare_step=prepare,
                          **jit_kw)
