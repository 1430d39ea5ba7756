"""Example: permeability history matching with adjoint gradients +
unit-box L-BFGS (DictParameters workflow).

Run: python examples/history_match.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from jutul.jl_tpu import (
    CartesianMesh,
    JutulCase,
    setup_parameters,
    setup_state,
    simulate,
    si_units,
)
from jutul.jl_tpu.adjoint.dict_opt import DictParameters
from jutul.jl_tpu.models.darcy import (
    ImmiscibleFluid,
    PhaseSourceTerm,
    setup_darcy_model,
)

DAY, BAR, DARCY = si_units("day", "bar", "darcy")


def build_case(trans=None, n=12):
    mesh = CartesianMesh((n,), (float(n),))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = setup_darcy_model(mesh, fluid, permeability=1.0 * DARCY,
                              porosity=0.25)
    state0 = setup_state(model, Pressure=100 * BAR, Saturations=[0.3, 0.7])
    params = setup_parameters(model)
    if trans is not None:
        params["Transmissibilities"] = np.asarray(trans)
    forces = {"src": PhaseSourceTerm([0], np.array([[0.02, 0.0]]))}
    return JutulCase(model, [0.5 * DAY] * 4, forces, state0=state0,
                     parameters=params)


def main():
    base = build_case()
    rng = np.random.default_rng(0)
    truth = np.asarray(base.parameters["Transmissibilities"]) * \
        rng.uniform(0.5, 2.0, base.parameters["Transmissibilities"].shape)
    obs_states, _ = simulate(build_case(truth), info_level=-1)
    obs = [jnp.asarray(s["Pressure"]) for s in obs_states]

    def misfit(model, state, dt, n_step, forces):
        d = (state["Pressure"] - obs[n_step]) / (1.0 * BAR)
        return dt * jnp.sum(d * d)

    def setup(params):
        c = build_case()
        c.parameters["Transmissibilities"] = np.asarray(
            params["Transmissibilities"])
        return c

    dopt = DictParameters(
        {"Transmissibilities": base.parameters["Transmissibilities"]},
        setup, verbose=True)
    dopt.free_optimization_parameter("Transmissibilities", rel_min=0.1,
                                     rel_max=10.0, scaler="log")
    best = dopt.optimize(misfit, max_iterations=25)
    err = np.abs(best["Transmissibilities"] / truth - 1.0)
    print(f"misfit: {dopt.history.values[0]:.3e} -> "
          f"{dopt.history.values[-1]:.3e}")
    print(f"recovered transmissibilities within "
          f"{100 * err.max():.1f}% (max relative error)")


if __name__ == "__main__":
    main()
