"""Example: permeability inversion through the DataDomain chain rule.

The adjoint gives dG/d(model parameters) — Transmissibilities on faces,
FluidVolume on cells. The chain rule
(``data_domain_parameter_gradient``, reference counterpart:
parameters_jacobian_wrt_data_domain, variables/vectorization.jl:281)
pulls those back to the RAW DataDomain field the engineer actually
controls: per-cell permeability. A log-scaled unit-box L-BFGS then
inverts a waterflood for the permeability field.

Run: python examples/perm_inversion_chain_rule.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from jutul.jl_tpu import (
    CartesianMesh,
    data_domain_parameter_gradient,
    setup_parameters,
    setup_state,
    si_unit,
    simulate,
    solve_adjoint_sensitivities,
    unit_box_bfgs,
)
from jutul.jl_tpu.models.darcy import (
    ImmiscibleFluid,
    PhaseSourceTerm,
    setup_darcy_model,
)

BAR = si_unit("bar")
DAY = si_unit("day")
DARCY = si_unit("darcy")

nx = ny = 12
nc = nx * ny
rng = np.random.default_rng(42)
mesh = CartesianMesh((nx, ny), (120.0, 120.0))
fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))

perm_true = np.exp(rng.normal(np.log(0.3 * DARCY), 0.6, nc))
log_lo, log_hi = np.log(0.03 * DARCY), np.log(3.0 * DARCY)

q = np.zeros((2, 2))
q[0, 0] = 0.03             # corner water injector (~0.5 PV over the run)
q[1] = (-0.002, -0.025)    # opposite-corner producer (mostly oil)
forces = {"wells": PhaseSourceTerm([0, nc - 1], q)}
dts = [5.0 * DAY] * 6
sim_kw = dict(forces=forces, info_level=-1,
              tolerances={"mass_conservation": 1e-9},
              max_nonlinear_iterations=25)


def run(perm):
    model = setup_darcy_model(mesh, fluid, permeability=perm, porosity=0.25)
    sw = np.full(nc, 0.2)
    state0 = setup_state(model, Pressure=100 * BAR,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    params = setup_parameters(model)
    states, reports = simulate(state0, model, dts, parameters=params,
                               **sim_kw)
    assert all(r["success"] for r in reports)
    return model, state0, params, states


_, _, _, obs_states = run(perm_true)
obs = [np.asarray(s["Saturations"][:, 0]) for s in obs_states]


def objective_fns(perm):
    model, state0, params, states = run(perm)

    def G(model_, state, dt, n, forces_):
        return jnp.sum((state["Saturations"][:, 0] - obs[n]) ** 2)

    val = sum(float(G(model, s, dt, n, forces))
              for n, (s, dt) in enumerate(zip(states, dts)))
    adj = solve_adjoint_sensitivities(model, states, dts, G,
                                      parameters=params, state0=state0,
                                      forces=forces)
    # chain rule: faces/cells parameter gradients -> per-cell permeability
    gdd = data_domain_parameter_gradient(model, {
        "Transmissibilities": adj["Transmissibilities"],
        "FluidVolume": adj["FluidVolume"],
    })
    return val, np.ravel(gdd["permeability"])


def f_and_g(x):
    logk = log_lo + np.asarray(x) * (log_hi - log_lo)
    perm = np.exp(logk)
    val, gperm = objective_fns(perm)
    # d/dx = d/dlogk * k * (hi - lo)
    return val, gperm * perm * (log_hi - log_lo)


x0 = np.full(nc, 0.5)  # homogeneous initial guess
f0, _ = f_and_g(x0)
f_opt, x_opt, hist = unit_box_bfgs(x0, f_and_g, max_iterations=25)
perm_opt = np.exp(log_lo + x_opt * (log_hi - log_lo))

err0 = np.linalg.norm(np.log(np.full(nc, np.exp(0.5 * (log_lo + log_hi))))
                      - np.log(perm_true))
err1 = np.linalg.norm(np.log(perm_opt) - np.log(perm_true))
print(f"objective: {f0:.4e} -> {f_opt:.4e} "
      f"({f_opt / f0:.2%} of initial)")
print(f"log-perm error: {err0:.3f} -> {err1:.3f}")
assert f_opt < 0.1 * f0, "inversion should reduce the misfit by >10x"
print("OK")
