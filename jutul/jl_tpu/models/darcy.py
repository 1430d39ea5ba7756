"""Two-phase immiscible Darcy flow — the flagship physics pack.

Counterpart of the conservation-law physics the reference framework hosts
(reference: src/conservation/conservation.jl ConservationLaw + flux.jl TPFA/
SPU upwinding; the concrete two-phase system lives downstream in
JutulDarcy.jl, but BASELINE config 3 — SPE10-style two-phase with
CPR-preconditioned GMRES — is the benchmark target this module serves).

Formulation (standard immiscible two-phase, slightly compressible):
  per phase α in {w, n}:  d/dt (pv ρ_α s_α) + div(ρ_α λ_α T ΔΦ_α) = q_α
  ΔΦ_α = Δp - ρ_α_avg g Δz,  λ_α = kr_α/μ_α single-point upwinded (SPU)
  kr via Brooks–Corey power laws, ρ_α(p) = ρ_ref exp(c_α (p - p_ref)).

Primary variables: Pressure (scalar), Saturations (unit-sum fractions, 1 dof).
Parameters: Transmissibilities (faces), GravityPotentialDifference (faces,
g·Δz), FluidVolume (cells, pore volume). Secondary chain:
PhaseMassDensities -> RelativePermeabilities -> PhaseMobilities ->
TotalMasses. All elementwise along cells (the local-AD contract), so the
vmap(jacfwd) face closures differentiate the full chain exactly as the
reference's dual numbers do.

Convergence uses the CNV/MB pair standard for reservoir simulation
(scaled by dt/pore-volume), mirroring the reference's scaled criteria
(src/models.jl:818-884).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.entities import CELLS, FACES
from ..discretization.tpfa import compute_face_gdz, compute_face_trans
from .equations import ConservationLaw
from .forces import JutulForce
from .system import JutulSystem
from .variables import (
    FractionVariables,
    JutulParameter,
    ScalarVariable,
    SecondaryVariable,
)


@dataclass(frozen=True)
class ImmiscibleFluid:
    """Per-phase fluid description (two entries: wetting, non-wetting)."""

    reference_densities: tuple = (1000.0, 800.0)  # kg/m^3
    compressibilities: tuple = (1e-10, 1e-9)  # 1/Pa
    viscosities: tuple = (1e-3, 5e-3)  # Pa s
    reference_pressure: float = 1.0e5  # Pa
    corey_exponents: tuple = (2.0, 2.0)
    residual_saturations: tuple = (0.0, 0.0)

    @property
    def n_phases(self) -> int:
        return len(self.reference_densities)


class Pressure(ScalarVariable):
    def default_value(self, model=None):
        return 1.0e5

    def minimum_value(self, model=None):
        return 1.0  # Pa; matches the reference's hard floor on pressure

    def absolute_increment_limit(self, model=None):
        return None

    def relative_increment_limit(self, model=None):
        return 0.2

    def variable_scale(self, model=None):
        return 1e5


class Saturations(FractionVariables):
    def __init__(self, n_phases: int = 2, ds_max: float = 0.2):
        super().__init__(n_phases, minimum_fraction=0.0, ds_max=ds_max)


class Transmissibilities(JutulParameter):
    def __init__(self):
        super().__init__(default=1.0, entity=FACES, minimum=0.0)

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        perm = dd.get("permeability")
        if perm is None:
            perm = np.ones(model.number_of_cells()) * 1e-13
        return compute_face_trans(dd.geometry, perm)

    # DataDomain -> parameter chain rule (reference vectorization.jl:281):
    # jnp-traceable recompute from the differentiable DataDomain fields.
    data_domain_dependencies = ("permeability",)

    def initialize_parameter_ad(self, model, dd_fields: dict):
        from ..discretization.tpfa import compute_face_trans_ad

        return compute_face_trans_ad(model.data_domain.geometry,
                                     dd_fields["permeability"])


class GravityPotentialDifference(JutulParameter):
    def __init__(self, gravity=None):
        super().__init__(default=0.0, entity=FACES)
        self.gravity = gravity

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        g = self.gravity
        if g is False or (dd.geometry is not None and dd.geometry.dim < 2 and g is None):
            return np.zeros(n)
        if g is None or g is True:  # default: down the last axis
            return compute_face_gdz(dd.geometry, None)
        g = np.asarray(g, dtype=np.float64)
        if g.ndim == 0:  # scalar magnitude, down the last axis
            vec = np.zeros(dd.geometry.dim)
            vec[-1] = -float(g)
            return compute_face_gdz(dd.geometry, vec)
        return compute_face_gdz(dd.geometry, g)


class FluidVolume(JutulParameter):
    def __init__(self):
        super().__init__(default=1.0, entity=CELLS, minimum=0.0)

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        vol = dd["volumes"]
        poro = dd.get("porosity")
        if poro is None:
            poro = np.ones(n)
        return vol * poro

    data_domain_dependencies = ("porosity", "volumes")

    def initialize_parameter_ad(self, model, dd_fields: dict):
        import jax.numpy as jnp

        return jnp.asarray(dd_fields["volumes"]) * jnp.asarray(
            dd_fields["porosity"])


class PhaseMassDensities(SecondaryVariable):
    dependencies = ("Pressure",)

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, Pressure):
        f = self.fluid
        rho0 = jnp.asarray(f.reference_densities)
        c = jnp.asarray(f.compressibilities)
        dp = Pressure[..., None] - f.reference_pressure
        return rho0 * jnp.exp(c * dp)


class BrooksCoreyRelativePermeabilities(SecondaryVariable):
    dependencies = ("Saturations",)

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, Saturations):
        f = self.fluid
        sr = jnp.asarray(f.residual_saturations)
        n = jnp.asarray(f.corey_exponents)
        sr_tot = jnp.sum(sr)
        s_eff = jnp.clip((Saturations - sr) / (1.0 - sr_tot), 0.0, 1.0)
        return s_eff**n


class PhaseMobilities(SecondaryVariable):
    dependencies = ("RelativePermeabilities",)

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, RelativePermeabilities):
        mu = jnp.asarray(self.fluid.viscosities)
        return RelativePermeabilities / mu


class TotalMasses(SecondaryVariable):
    dependencies = ("FluidVolume", "PhaseMassDensities", "Saturations")

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, FluidVolume, PhaseMassDensities, Saturations):
        return FluidVolume[..., None] * PhaseMassDensities * Saturations


class TwoPhaseDarcyEquation(ConservationLaw):
    """Mass conservation per phase with SPU-upwinded TPFA flux
    (reference: conservation.jl:78-99 + flux.jl SPU :35)."""

    def __init__(self, n_phases: int = 2):
        def mass(model, cs):
            return cs["TotalMasses"]

        def flux(model, cs, fs):
            T = fs["Transmissibilities"]
            gdz = fs["GravityPotentialDifference"]
            p = cs["Pressure"]  # (2,)
            rho = cs["PhaseMassDensities"]  # (2, nph)
            mob = cs["PhaseMobilities"]  # (2, nph)
            rho_avg = 0.5 * (rho[0] + rho[1])
            dpot = (p[0] - p[1]) - rho_avg * gdz  # (nph,) phase potential drop
            upwind_is_left = dpot >= 0.0
            mob_up = jnp.where(upwind_is_left, mob[0], mob[1])
            rho_up = jnp.where(upwind_is_left, rho[0], rho[1])
            return rho_up * mob_up * T * dpot

        super().__init__(flux_fn=flux, mass_fn=mass, neq=n_phases)

    def convergence_parts(self, model, eq_name, r, state, dt):
        """CNV (max local scaled residual) + MB (global mass balance),
        the standard pair (reference-scaled criteria, models.jl:818). MB is
        expressed as a ratio of global sums so the distributed reduction is
        exact (psum of numerator and denominator)."""
        pv = state["FluidVolume"]
        rho = state["PhaseMassDensities"]
        scale = dt / (pv[:, None] * rho)
        cnv = jnp.max(jnp.abs(r) * scale, axis=0)
        mb_num = jnp.sum(r, axis=0) * dt  # signed; |.| applied after psum
        mb_den = jnp.sum(pv[:, None] * rho, axis=0)
        return {"CNV": ("max", cnv), "MB": ("ratio", (mb_num, mb_den))}

    def default_tolerance(self, model) -> float:
        return 1e-3


class ImmiscibleSystem(JutulSystem):
    """Two-phase immiscible Darcy system."""

    def __init__(self, fluid: ImmiscibleFluid | None = None, gravity=None):
        self.fluid = fluid or ImmiscibleFluid()
        self.gravity = gravity

    def select_primary_variables(self, model):
        return OrderedDict(
            Pressure=Pressure(),
            Saturations=Saturations(self.fluid.n_phases),
        )

    def select_secondary_variables(self, model):
        f = self.fluid
        return OrderedDict(
            PhaseMassDensities=PhaseMassDensities(f),
            RelativePermeabilities=BrooksCoreyRelativePermeabilities(f),
            PhaseMobilities=PhaseMobilities(f),
            TotalMasses=TotalMasses(f),
        )

    def select_parameters(self, model):
        return OrderedDict(
            Transmissibilities=Transmissibilities(),
            GravityPotentialDifference=GravityPotentialDifference(self.gravity),
            FluidVolume=FluidVolume(),
        )

    def select_equations(self, model):
        return OrderedDict(mass_conservation=TwoPhaseDarcyEquation(
            self.fluid.n_phases))


class DarcyTransferCrossTerm:
    """Pressure-driven, upwinded phase-mass transfer between two Darcy
    models — the coupling used for faults, shared boundaries, or simple
    aquifer/well connections (reference: the well-perforation cross terms
    in downstream JutulDarcy compose the same ingredients; protocol per
    src/multimodel/crossterm.jl:3-660).

    For connection i with transmissibility ``trans[i]``, the transfer out
    of the target is ``T_i * mob_up * rho_up * (p_t - p_s)`` per phase,
    with mobilities and densities upwinded from the side the flow leaves.
    Skew-symmetric: the source model receives the negated value.
    """

    symmetric = True

    def __init__(self, trans):
        self.conn_data = {
            "trans": np.atleast_1d(np.asarray(trans, dtype=np.float64))}

    def value(self, model_t, model_s, local_t, local_s, dt, conn):
        dp = local_t["Pressure"] - local_s["Pressure"]
        up = dp > 0  # flow leaves the target
        mob = jnp.where(up, local_t["PhaseMobilities"],
                        local_s["PhaseMobilities"])
        rho = jnp.where(up, local_t["PhaseMassDensities"],
                        local_s["PhaseMassDensities"])
        return conn["trans"] * mob * rho * dp


class PhaseSourceTerm(JutulForce):
    """Phase mass sources q_α [kg/s] in given cells: residual -= q."""

    def __init__(self, cells, values):
        self.cells = np.atleast_1d(np.asarray(cells, dtype=np.int32))
        self.values = values  # (ns, n_phases) mass rates

    def apply(self, model, eq, eq_name, r, state, dt):
        if not isinstance(eq, TwoPhaseDarcyEquation):
            return r
        v = jnp.atleast_2d(jnp.asarray(self.values))
        return r.at[self.cells].add(-v)


jax.tree_util.register_pytree_node(
    PhaseSourceTerm,
    lambda f: ((f.values,), tuple(f.cells.tolist())),
    lambda aux, ch: PhaseSourceTerm(np.asarray(aux, dtype=np.int32), ch[0]),
)


class PressureBoundaryCondition(JutulForce):
    """Dirichlet-like pressure BC on boundary cells via a half-face
    transmissibility connection to a fixed-pressure reservoir.

    State-dependent force: contributes to residual AND diagonal Jacobian
    (the counterpart of the reference's boundary-condition force path,
    equations.jl:603 apply_forces_to_equation!).
    """

    def __init__(self, cells, pressure, trans, saturations=None):
        if isinstance(cells, (jax.Array, jax.core.Tracer)):
            # traced cell indices: used by the distributed path, where
            # per-shard BC rows are data, not trace constants (padding
            # rows carry trans=0 and contribute exactly zero)
            self.cells = jnp.atleast_1d(cells).astype(jnp.int32)
        else:
            self.cells = np.atleast_1d(np.asarray(cells, dtype=np.int32))
        self.pressure = pressure  # scalar or (ns,)
        self.trans = trans  # (ns,) half-face trans to boundary
        self.saturations = saturations  # inflow saturations (ns, nph)

    def shift_pressure_datum(self, p_ref):
        """Boundary pressure is absolute — rebase it with the cell
        pressures (JutulForce.shift_pressure_datum protocol)."""
        import copy as _copy

        g = _copy.copy(self)
        g.pressure = self.pressure - p_ref
        return g

    def _flux_one(self, model, p, mob, rho, pb, T, s_in=None):
        """Boundary out-flux for ONE cell: p scalar, mob/rho/s_in (nph,)."""
        dp = p - pb  # > 0: outflow
        fluid = model.system.fluid
        mu = jnp.asarray(fluid.viscosities)
        if s_in is None:
            s_in = jnp.full(mob.shape, 1.0 / mob.shape[-1])
        # Inflow mobility uses the system's own relative permeability at the
        # boundary saturation, kr(s_in)/mu, consistent with interior fluxes
        # (reference boundary-condition upwinding, equations.jl:603).
        relperm = model.secondary_variables.get("RelativePermeabilities")
        kr_in = relperm.evaluate(model, s_in) if relperm is not None else s_in
        mob_in = kr_in / mu
        mob_up = jnp.where(dp >= 0, mob, mob_in)
        return rho * mob_up * T * dp

    def _per_source(self, nph):
        ns = self.cells.shape[0]
        pb = jnp.broadcast_to(jnp.asarray(self.pressure), (ns,))
        T = jnp.broadcast_to(jnp.asarray(self.trans), (ns,))
        if self.saturations is None:
            s_in = jnp.full((ns, nph), 1.0 / nph)
        else:
            s_in = jnp.broadcast_to(jnp.asarray(self.saturations), (ns, nph))
        return pb, T, s_in

    def apply(self, model, eq, eq_name, r, state, dt):
        if not isinstance(eq, TwoPhaseDarcyEquation):
            return r
        nph = model.system.fluid.n_phases
        pb, T, s_in = self._per_source(nph)
        q = jax.vmap(lambda p, m, rho, pbi, Ti, si: self._flux_one(
            model, p, m, rho, pbi, Ti, si))(
            jnp.asarray(state["Pressure"])[self.cells],
            jnp.asarray(state["PhaseMobilities"])[self.cells],
            jnp.asarray(state["PhaseMassDensities"])[self.cells],
            pb, T, s_in,
        )
        return r.at[self.cells].add(q)

    def diagonal_jacobian(self, model, eq, eq_name, compiled, state, dt):
        if not isinstance(eq, TwoPhaseDarcyEquation):
            return None
        cells = self.cells
        U = compiled.get_dofs(state)[cells]  # (ns, ndof)
        params = {k: jnp.asarray(v)[cells] for k, v in state.items()
                  if k in compiled.model.parameters
                  and compiled.cell_entry_entity.get(k) == CELLS}
        pb, T, s_in = self._per_source(model.system.fluid.n_phases)

        def one_cell(u, p, pbi, Ti, si):
            local = dict(p)
            local.update(compiled.unpack_dofs(u))
            local = compiled._eval_secondaries_local(local)
            return self._flux_one(model, local["Pressure"],
                                  local["PhaseMobilities"],
                                  local["PhaseMassDensities"], pbi, Ti, si)

        jac = jax.vmap(jax.jacfwd(one_cell, argnums=0))(U, params, pb, T,
                                                        s_in)
        return cells, jac


jax.tree_util.register_pytree_node(
    PressureBoundaryCondition,
    lambda f: ((f.pressure, f.trans, f.saturations),
               tuple(f.cells.tolist())),
    lambda aux, ch: PressureBoundaryCondition(
        np.asarray(aux, dtype=np.int32), ch[0], ch[1], ch[2]),
)


def setup_darcy_model(mesh, fluid: ImmiscibleFluid | None = None,
                      permeability=None, porosity=None, gravity=None):
    """Convenience constructor: DataDomain + ImmiscibleSystem model."""
    from ..core.domains import DataDomain
    from .system import SimulationModel

    dd = DataDomain(mesh)
    nc = dd.number_of_cells()
    if permeability is not None:
        perm = np.asarray(permeability, dtype=np.float64)
        if perm.ndim == 0:
            perm = np.full(nc, float(perm))
        dd.set("permeability", perm)
    if porosity is not None:
        poro = np.asarray(porosity, dtype=np.float64)
        if poro.ndim == 0:
            poro = np.full(nc, float(poro))
        dd.set("porosity", poro)
    return SimulationModel(dd, ImmiscibleSystem(fluid, gravity=gravity))
