"""Example: general-partition SPMD simulation + distributed adjoint.

Runs a two-phase waterflood on an UnstructuredMesh over an 8-device mesh
(virtual CPU devices here — the same `jax.shard_map` program runs over
the GPUs of one host), with a non-trivial graph partition, packed `all_to_all` halo
exchange, distributed CPR-free Krylov, and the distributed adjoint
(transposed halos via `jax.linear_transpose`), checked against the
single-device answer.

Run: python examples/distributed_general.py
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from jutul.jl_tpu import (
    CartesianMesh,
    GeneralDistributedSimulator,
    Simulator,
    UnstructuredMesh,
    si_unit,
    solve_adjoint_sensitivities,
    solve_adjoint_sensitivities_general,
)
from jutul.jl_tpu.models.darcy import (
    ImmiscibleFluid,
    ImmiscibleSystem,
    PhaseSourceTerm,
)
from jutul.jl_tpu.parallel.partition import GreedyGraphPartitioner

BAR, DAY, DARCY = si_unit("bar"), si_unit("day"), si_unit("darcy")

mesh = UnstructuredMesh.from_cartesian(CartesianMesh((10, 8, 4),
                                                     (100.0, 80.0, 20.0)))
nc = mesh.number_of_cells()
rng = np.random.default_rng(0)
perm = rng.lognormal(np.log(0.2 * DARCY), 0.8, nc)
poro = np.full(nc, 0.25)
system = ImmiscibleSystem(ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
                          gravity=True)

part = GreedyGraphPartitioner().partition(mesh.neighborship(), nc, 8)
print(f"{nc} cells over 8 shards; shard sizes:",
      np.bincount(part).tolist())

dmesh = Mesh(np.array(jax.devices()[:8]), ("d",))
dsim = GeneralDistributedSimulator(
    mesh, system, dmesh, partition=part,
    data_fields={"permeability": perm, "porosity": poro})

sw = np.full(nc, 0.25)
state0 = dsim.initial_state(
    Pressure=np.full(nc, 150.0 * BAR),
    Saturations=np.stack([sw, 1 - sw], axis=1))
q = np.array([[0.05, 0.0], [-0.01, -0.03]])
forces = {"wells": PhaseSourceTerm([0, nc - 1], q)}
dts = [2.0 * DAY] * 3

states, reports = dsim.simulate(state0, dts, forces=forces,
                                tol_cnv=1e-11, max_newton=30,
                                info_level=-1)

# single-device cross-check
sim = Simulator(dsim.global_model, state0=state0)
ref_states, _ = sim.simulate(dts, forces=forces, info_level=-1,
                             tolerances={"default": 1e-11},
                             max_nonlinear_iterations=30)
dp = np.abs(states[-1]["Pressure"]
            - np.asarray(ref_states[-1]["Pressure"])).max()
print(f"max |P_dist - P_single| = {dp:.3e} Pa (of ~1.5e7)")
assert dp < 1.0

# distributed adjoint: water-in-place objective, gradient wrt all params
def G(model, state, dt, n, forces_):
    return dt * jnp.sum(state["Saturations"][:, 0] ** 2)

grads = solve_adjoint_sensitivities_general(
    dsim, [dict(s) for s in ref_states], dts, G, state0,
    forces=forces, rtol=1e-12, max_lin_it=2000)
ref_grads = solve_adjoint_sensitivities(
    dsim.global_model, [dict(s) for s in ref_states], dts, G,
    parameters=sim.parameters, state0=state0, forces=forces)
for k in ("Transmissibilities", "FluidVolume"):
    gr, gd = np.asarray(ref_grads[k]), np.asarray(grads[k])
    rel = np.abs(gd - gr).max() / max(np.abs(gr).max(), 1e-300)
    print(f"adjoint {k}: max rel diff vs single-device = {rel:.2e}")
    assert rel < 1e-5
print("OK")
