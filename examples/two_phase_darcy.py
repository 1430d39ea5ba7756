"""Example: two-phase waterflood on an SPE10-style layered permeability
field, with VTK output for visualization.

Run: python examples/two_phase_darcy.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from jutul.jl_tpu import (
    CartesianMesh,
    GenericKrylov,
    CPRPreconditioner,
    setup_parameters,
    setup_state,
    simulate,
    si_units,
)
from jutul.jl_tpu.models.darcy import (
    ImmiscibleFluid,
    PhaseSourceTerm,
    PressureBoundaryCondition,
    setup_darcy_model,
)
from jutul.jl_tpu.simulator.io import print_stats
from jutul.jl_tpu.utils.vtk import export_time_series_pvd

DAY, BAR, DARCY = si_units("day", "bar", "darcy")


def layered_permeability(nx, ny, nz, seed=0):
    """Lognormal layers with strong vertical contrast (SPE10 flavor)."""
    rng = np.random.default_rng(seed)
    layers = rng.lognormal(mean=0.0, sigma=1.5, size=nz)
    perm = np.repeat(layers, nx * ny) * 0.1 * DARCY
    jitter = rng.lognormal(0.0, 0.3, nx * ny * nz)
    return perm * jitter


def main():
    nx, ny, nz = 32, 32, 8
    nc = nx * ny * nz
    mesh = CartesianMesh((nx, ny, nz), (320.0, 320.0, 40.0))
    fluid = ImmiscibleFluid(
        reference_densities=(1000.0, 850.0),
        viscosities=(1e-3, 5e-3),
        corey_exponents=(2.0, 2.0),
    )
    model = setup_darcy_model(mesh, fluid,
                              permeability=layered_permeability(nx, ny, nz),
                              porosity=0.2)
    state0 = setup_state(model, Pressure=200 * BAR, Saturations=[0.0, 1.0])
    params = setup_parameters(model)
    T = float(np.median(params["Transmissibilities"]))
    inject = 5.0  # kg/s water at one corner
    forces = {
        "inj": PhaseSourceTerm([0], np.array([[inject, 0.0]])),
        "prod": PressureBoundaryCondition([nc - 1], 200 * BAR, 10 * T),
    }
    schedule = [30 * DAY] * 12
    states, reports = simulate(
        state0, model, schedule, forces=forces, parameters=params,
        info_level=1,
        linear_solver=GenericKrylov("gmres",
                                    preconditioner=CPRPreconditioner(),
                                    rtol=1e-8),
    )
    print_stats(reports)
    out = export_time_series_pvd("examples/out/waterflood", mesh, states,
                                 schedule, fields=["Pressure", "Saturations"])
    sw_final = states[-1]["Saturations"][:, 0]
    print(f"final water saturation: min={sw_final.min():.3f} "
          f"max={sw_final.max():.3f}; VTK series at {out}")


if __name__ == "__main__":
    main()
