"""Example: CO2-style buoyant plume migration with adjoint permeability
gradients (BASELINE.md benchmark config 5 in miniature).

A light phase is injected at the bottom of a 2D vertical cross-section and
rises under gravity; the adjoint then computes the gradient of a plume-
containment objective with respect to every cell transmissibility, checked
against finite differences on a few entries.

Run: python examples/co2_plume.py
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
    solve_adjoint_sensitivities,
)
from jutul.jl_tpu.models.darcy import (
    ImmiscibleFluid,
    PhaseSourceTerm,
    setup_darcy_model,
)

DAY, BAR, DARCY = si_units("day", "bar", "darcy")


def build_case(trans=None):
    nx, nz = 16, 12
    # vertical x-z cross-section: z is the last axis -> gravity acts on it
    mesh = CartesianMesh((nx, 1, nz), (160.0, 10.0, 60.0))
    fluid = ImmiscibleFluid(
        reference_densities=(700.0, 1000.0),   # CO2-ish vs brine
        viscosities=(6e-5, 8e-4),
        compressibilities=(1e-8, 1e-10),
        corey_exponents=(2.0, 2.0),
    )
    # a low-perm caprock layer two cells below the top
    nc = nx * 1 * nz
    perm = np.full(nc, 0.2 * DARCY)
    k = np.arange(nc) // nx  # z-layer index (z slowest)
    perm[k == nz - 3] = 0.002 * DARCY
    model = setup_darcy_model(mesh, fluid, permeability=perm, porosity=0.2,
                              gravity=True)
    state0 = setup_state(model, Pressure=150 * BAR, Saturations=[0.0, 1.0])
    params = setup_parameters(model)
    if trans is not None:
        params["Transmissibilities"] = np.asarray(trans)
    q = np.array([[0.3, 0.0]])  # kg/s CO2 at bottom center
    forces = {"inj": PhaseSourceTerm([nx // 2], q)}
    return JutulCase(model, [5 * DAY] * 8, forces, state0=state0,
                     parameters=params), nx, nz


def main():
    case, nx, nz = build_case()
    states, reports = simulate(case, info_level=0)
    sg = np.asarray(states[-1]["Saturations"])[:, 0].reshape(nz, nx)
    top = sg[nz - 1].max()
    below_cap = sg[nz - 4].max()
    print(f"plume: max CO2 saturation below caprock {below_cap:.3f}, "
          f"at top {top:.4f} (caprock holds)")

    # objective: CO2 mass above the caprock (to be minimized by a design)
    k_above = nz - 2

    def leakage(model, state, dt, n_step, forces):
        sat = state["Saturations"][:, 0].reshape(nz, nx)
        return dt * jnp.sum(sat[k_above:] ** 2)

    grad = solve_adjoint_sensitivities(case, states, case.dt, leakage)
    gT = np.asarray(grad["Transmissibilities"])
    print(f"adjoint: d(leakage)/dT over {gT.size} transmissibilities, "
          f"max |g| = {np.abs(gT).max():.3e}")

    # FD spot-check on the 3 largest-sensitivity faces
    idx = np.argsort(-np.abs(gT))[:3]
    T0 = np.asarray(case.parameters["Transmissibilities"])

    def total(trans):
        c2, _, _ = build_case(trans)
        sts, _ = simulate(c2, info_level=-1)
        return sum(float(leakage(None, {k: jnp.asarray(v)
                                        for k, v in s.items()},
                                 case.dt[i], i, None))
                   for i, s in enumerate(sts))

    for i in idx:
        h = 1e-6 * abs(T0[i])
        tp, tm = T0.copy(), T0.copy()
        tp[i] += h
        tm[i] -= h
        fd = (total(tp) - total(tm)) / (2 * h)
        print(f"  face {i}: adjoint {gT[i]:+.6e}  fd {fd:+.6e}")
        assert np.isclose(gT[i], fd, rtol=2e-3), (i, gT[i], fd)
    print("adjoint gradients FD-verified.")


if __name__ == "__main__":
    main()
