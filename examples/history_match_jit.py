"""Example: history matching with the two-device-execution pipeline.

Each optimizer iteration costs exactly TWO device executions:

1. forward — ``simulate_jit`` (whole schedule as one ``lax.scan`` program)
   with ``jit_output_states=True`` so every report state comes back from
   the single execution;
2. gradient — ``solve_adjoint_sensitivities_jit`` (the whole backward
   sweep as one reversed ``lax.scan`` program, ILU(0)-preconditioned
   BiCGStab lambda-solves inside).

This is the accelerator-shaped version of the reference's optimization
loop (reference: src/simulator/optimization.jl:40 +
src/ad/gradients.jl:230 — a host loop of per-step assembles and
solves); host round-trips dominate anything at this scale, so both
loops compile into single programs. The observation misfit indexes per-step observations
with a traced step index (jnp gather), as the jitted sweep requires.

Run: python examples/history_match_jit.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from jutul.jl_tpu import (
    CartesianMesh,
    Simulator,
    setup_parameters,
    setup_state,
    si_units,
    solve_adjoint_sensitivities_jit,
    unit_box_bfgs,
)
from jutul.jl_tpu.adjoint.gradients import AdjointStorage
from jutul.jl_tpu.linsolve.krylov import GenericKrylov
from jutul.jl_tpu.linsolve.precond import ILU0Preconditioner
from jutul.jl_tpu.models.darcy import (
    ImmiscibleFluid,
    PhaseSourceTerm,
    setup_darcy_model,
)

DAY, BAR, DARCY = si_units("day", "bar", "darcy")
NX, NY = 10, 8
NC = NX * NY
DTS = [0.5 * DAY] * 4


def build(perm):
    mesh = CartesianMesh((NX, NY), (100.0, 80.0))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = setup_darcy_model(mesh, fluid, permeability=perm, porosity=0.25)
    state0 = setup_state(model, Pressure=100 * BAR,
                         Saturations=[0.3, 0.7])
    params = setup_parameters(model)
    forces = {"src": PhaseSourceTerm(
        [0, NC - 1], np.array([[0.02, 0.0], [-0.009, -0.009]]))}
    return model, state0, params, forces


def forward(sim, forces):
    states, reports = sim.simulate_jit(
        DTS, forces=forces, jit_output_states=True, info_level=-1,
        tolerances={"mass_conservation": 1e-9})
    assert all(r["success"] for r in reports)
    return states


def main():
    rng = np.random.default_rng(0)
    base_perm = np.full(NC, 0.5 * DARCY)
    truth_perm = base_perm * rng.uniform(0.4, 2.5, NC)

    # synthetic observations from the "true" field
    model_t, state0, _, forces = build(truth_perm)
    sim_t = Simulator(model_t, state0=state0,
                      parameters=setup_parameters(model_t))
    obs = jnp.stack([jnp.asarray(s["Pressure"])
                     for s in forward(sim_t, forces)])  # (N, nc)

    # optimize TRANSMISSIBILITIES (the assembled parameter the adjoint
    # differentiates) from a uniform start
    model, state0, params, forces = build(base_perm)
    sim = Simulator(model, state0=state0, parameters=params)
    t0 = np.asarray(params["Transmissibilities"], dtype=np.float64)
    lo, hi = t0 * 0.05, t0 * 20.0

    def G(model_, state, dt, n, forces_):
        # traced step index: gather the step's observation row
        d = (state["Pressure"] - obs[n]) / (1.0 * BAR)
        return dt / DTS[0] * jnp.sum(d * d) / NC

    lam_solver = GenericKrylov("bicgstab",
                               preconditioner=ILU0Preconditioner(),
                               rtol=0.0, atol=1e-14, max_iterations=300)
    storage = AdjointStorage(model, params, linear_solver=lam_solver)

    def objective(x):
        t = lo + np.asarray(x) * (hi - lo)  # unit box -> parameter space
        p = {**params, "Transmissibilities": t}
        sim.parameters = {k: jnp.asarray(v) for k, v in p.items()}
        states = forward(sim, forces)  # device execution 1
        val = sum(float(G(model, {k: jnp.asarray(v) for k, v in s.items()},
                          DTS[n], n, forces)) for n, s in enumerate(states))
        grads = solve_adjoint_sensitivities_jit(  # device execution 2
            model, states, DTS, G, parameters=p, state0=state0,
            forces=forces, storage=storage)
        g = grads["Transmissibilities"] * (hi - lo)  # chain rule to [0,1]
        return val, g

    x0 = (t0 - lo) / (hi - lo)
    f0, _ = objective(x0)
    f1, xs, hist = unit_box_bfgs(x0, objective, max_iterations=25,
                                 verbose=False)
    print(f"misfit: {f0:.4e} -> {f1:.4e} "
          f"({len(hist.values) - 1} L-BFGS its, "
          f"2 device executions per iteration)")
    assert f1 < 0.05 * f0, (f0, f1)
    print("history_match_jit: OK")


if __name__ == "__main__":
    main()
