"""Example: P2D-battery-style coupled diffusion with Schur group
elimination (BASELINE config 4: multimodel coupled system with
cross-terms and block elimination; reference src/multimodel/ +
linsolve/multimodel.jl:17).

Structure mirrors a pseudo-2D battery stack: a fine "electrolyte"
1D domain exchanges with a coarse "particle" domain through a linear
exchange cross-term (Butler-Volmer linearized about equilibrium). The
particle model is declared in its own GROUP with
``reduction="schur_apply"``, so the default solver eliminates it from
the Krylov space exactly — the reference's block elimination — and the
result matches the monolithic solve to roundoff.

Run: python examples/battery_p2d_schur.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from jutul.jl_tpu import (
    CartesianMesh,
    SimpleHeatSystem,
    SimulationModel,
    Simulator,
    setup_parameters,
    setup_state,
)
from jutul.jl_tpu.multimodel.core import MultiModel


class ExchangeCrossTerm:
    """k * (C_target - C_source): linearized interfacial exchange."""

    symmetric = True

    def __init__(self, k=0.35):
        self.k = k

    def value(self, model_t, model_s, local_t, local_s, dt):
        return jnp.reshape(self.k * (local_t["T"] - local_s["T"]), (1,))


def build(reduction=None):
    electrolyte = SimulationModel(CartesianMesh((24,), (1.0,)),
                                  SimpleHeatSystem())
    particle = SimulationModel(CartesianMesh((6,), (0.25,)),
                               SimpleHeatSystem())
    mm = MultiModel({"electrolyte": electrolyte, "particle": particle})
    if reduction:
        mm.groups = {"electrolyte": 1, "particle": 2}
        mm.reduction = reduction
    # each particle cell exchanges with every 4th electrolyte cell
    t_cells = [4 * i for i in range(6)]
    s_cells = list(range(6))
    mm.add_cross_term(ExchangeCrossTerm(), target="electrolyte",
                      source="particle", equation="heat",
                      target_cells=t_cells, source_cells=s_cells)
    state0 = {
        "electrolyte": setup_state(electrolyte, T=1.0),
        "particle": setup_state(particle,
                                T=np.linspace(2.0, 3.0, 6)),
    }
    params = {"electrolyte": setup_parameters(electrolyte),
              "particle": setup_parameters(particle)}
    return mm, state0, params


def run(reduction=None):
    mm, state0, params = build(reduction)
    sim = Simulator(mm, state0=state0, parameters=params)
    res = sim.simulate([0.05] * 10, info_level=-1,
                       tolerances={"default": 1e-11},
                       max_nonlinear_iterations=20)
    assert all(r["success"] for r in res.reports)
    return res.states[-1]


monolithic = run(reduction=None)
schur = run(reduction="schur_apply")

for name in ("electrolyte", "particle"):
    d = np.abs(np.asarray(schur[name]["T"])
               - np.asarray(monolithic[name]["T"])).max()
    print(f"{name}: max |Schur - monolithic| = {d:.3e}")
    assert d < 1e-8

total = (np.asarray(monolithic["electrolyte"]["T"]).sum()
         + np.asarray(monolithic["particle"]["T"]).sum())
print(f"total 'charge' after exchange: {total:.6f}")
print("OK")
