"""Example: two reservoir compartments coupled through a low-permeability
fault connection (MultiModel + DarcyTransferCrossTerm).

The left compartment is waterflooded; the right compartment only feels it
through the fault. Demonstrates the coupled Jacobian (diagonal blocks +
cross-coupling) solved monolithically.

Run: python examples/coupled_reservoirs.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from jutul.jl_tpu import (
    CartesianMesh,
    Simulator,
    setup_parameters,
    setup_state,
    si_units,
)
from jutul.jl_tpu.models.darcy import (
    DarcyTransferCrossTerm,
    ImmiscibleFluid,
    PhaseSourceTerm,
    PressureBoundaryCondition,
    setup_darcy_model,
)
from jutul.jl_tpu.multimodel.core import MultiModel

DAY, BAR, DARCY = si_units("day", "bar", "darcy")


def compartment(nx, ny):
    mesh = CartesianMesh((nx, ny), (10.0 * nx, 10.0 * ny))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 5e-3),
                            corey_exponents=(2.0, 2.0))
    return setup_darcy_model(mesh, fluid, permeability=0.1 * DARCY,
                             porosity=0.2)


def main():
    nx, ny = 10, 6
    left = compartment(nx, ny)
    right = compartment(nx, ny)
    mm = MultiModel({"left": left, "right": right})

    # fault connection along the shared edge: rightmost column of "left"
    # to leftmost column of "right", 10x lower transmissibility
    prm = {"left": setup_parameters(left), "right": setup_parameters(right)}
    T_fault = float(np.median(prm["left"]["Transmissibilities"])) / 10.0
    t_cells = [(j + 1) * nx - 1 for j in range(ny)]
    s_cells = [j * nx for j in range(ny)]
    mm.add_cross_term(DarcyTransferCrossTerm([T_fault] * ny),
                      target="left", source="right",
                      equation="mass_conservation",
                      target_cells=t_cells, source_cells=s_cells)

    state0 = {
        "left": setup_state(left, Pressure=200 * BAR, Saturations=[0.0, 1.0]),
        "right": setup_state(right, Pressure=180 * BAR,
                             Saturations=[0.0, 1.0]),
    }
    # inject water at the left compartment's far corner; produce from the
    # right compartment's far corner at fixed pressure — all flow between
    # them must cross the fault
    q = np.array([[0.5, 0.0]])  # water injection, kg/s
    T_prod = float(np.median(prm["right"]["Transmissibilities"]))
    forces = {
        "left": {"inj": PhaseSourceTerm([0], q)},
        "right": {"prod": PressureBoundaryCondition([nx * ny - 1],
                                                    180 * BAR, 10 * T_prod)},
    }

    sim = Simulator(mm, state0=state0, parameters=prm)
    schedule = [1 * DAY, 2 * DAY, 5 * DAY] + [10 * DAY] * 3 + [20 * DAY] * 6
    states, reports = sim.simulate(schedule, forces=forces, info_level=0,
                                   max_timestep=10 * DAY)
    pL = np.asarray(states[-1]["left"]["Pressure"]) / BAR
    pR = np.asarray(states[-1]["right"]["Pressure"]) / BAR
    swL = np.asarray(states[-1]["left"]["Saturations"])[:, 0]
    print(f"left:  p in [{pL.min():.1f}, {pL.max():.1f}] bar, "
          f"max water sat {swL.max():.3f}")
    print(f"right: p in [{pR.min():.1f}, {pR.max():.1f}] bar "
          "(supported through the fault)")
    assert pL.min() > pR.max()  # pressure drop concentrates at the fault
    assert pR.mean() > 180.0  # the fault transmits pressure support


if __name__ == "__main__":
    main()
