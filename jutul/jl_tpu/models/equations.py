"""Equations: residual/Jacobian contribution declarations.

Counterpart of Jutul's equations layer (reference: src/equations.jl —
``number_of_equations_per_entity``, ``update_equation!`` :541-595,
``convergence_criterion`` :620; src/conservation/conservation.jl —
``ConservationLaw`` core_types.jl:850, ``update_equation_in_entity!`` :78,
TPFA storage :101; src/conservation/fvm_assembly.jl).

JAX-native design: an equation is compiled into a list of *contributions*,
each a pure per-entity function plus static index arrays. The assembly
engine (ops/assembly.py) vmaps the functions for residual values and
``vmap(jacfwd(...))``'s them for Jacobian blocks — the JAX equivalent of the
reference's entity-local dual numbers (src/ad/local_ad.jl).

Local-function contracts (single-entity view; the engine vmaps):
- accumulation: ``fn(model, cell_state, cell_state0, dt) -> (neq,)``
  where ``cell_state`` maps names -> scalar or (m,) component vector.
- face flux: ``fn(model, cell_states, face_state) -> (neq,)`` where
  ``cell_states`` entries are stacked over the K stencil cells: (K,) or
  (K, m); ``face_state`` entries are per-face scalars/(m,) vectors.
  For TPFA, K = 2 with index 0 = left, 1 = right; positive flux flows
  left -> right and is added to the left row, subtracted from the right.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np

from ..core.entities import CELLS, JutulEntity


@dataclass
class AccumulationContribution:
    """(M(u) - M(u0)) / dt style cell-local residual term."""

    fn: Callable  # (model, cell_state, cell_state0, dt) -> (neq,)
    name: str = "accumulation"


@dataclass
class CellTermContribution:
    """Arbitrary cell-local residual term r[c] += fn(cell_state)."""

    fn: Callable  # (model, cell_state, cell_state0, dt) -> (neq,)
    name: str = "cell_term"


@dataclass
class FaceFluxContribution:
    """Stencil flux over interior faces, scattered ± to two target rows."""

    fn: Callable  # (model, cell_states, face_state) -> (neq,)
    stencil: np.ndarray  # (n_faces, K) int — cells the flux reads
    plus: np.ndarray  # (n_faces,) int — row receiving +flux
    minus: np.ndarray  # (n_faces,) int — row receiving -flux
    name: str = "flux"


@dataclass
class CrossCoupling:
    """Cross-ENTITY residual coupling for mixed-entity models
    (reference: equations on arbitrary entities with cross-entity
    alignment, src/equations.jl:328-434). Declared by an equation via
    ``cross_couplings(model)``; consumed by the mixed-entity compiler
    (ops/mixed.py), which adds the value to the owning equation's rows
    and derives both Jacobian blocks (row-diagonal and the off-entity
    coupling block) by vmapped jacfwd.

    ``fn(model, local_row, local_source, dt, conn) -> (neq,)`` receives
    the row-entity and source-entity local states of ONE (row, col) pair;
    ``conn`` is the per-pair slice of ``conn_data`` (or None).
    ``symmetric``: the negated value is also added to the source entity's
    same-named equation (CTSkewSymmetry).
    """

    rows: np.ndarray  # (m,) row-entity indices (the equation's entity)
    cols: np.ndarray  # (m,) source-entity indices
    source_entity: JutulEntity
    fn: Callable
    conn_data: "dict | None" = None
    symmetric: bool = False


class JutulEquation:
    """Abstract equation (reference core_types.jl JutulEquation)."""

    def entity(self, model) -> JutulEntity:
        return CELLS

    def number_of_equations_per_entity(self, model) -> int:
        return 1

    def contributions(self, model) -> list:
        raise NotImplementedError

    def cross_couplings(self, model) -> "list[CrossCoupling]":
        """Cross-entity couplings (mixed-entity models only)."""
        return []

    # --- convergence -----------------------------------------------------
    def convergence_parts(self, model, eq_name, r, state, dt):
        """Distributable criterion pieces: dict name -> (kind, payload).

        kind "max": payload is a (neq,) array reduced by max across shards.
        kind "ratio": payload is (numerator, denominator) (neq,) arrays,
        each summed (signed) across shards; the criterion value is
        |sum(num)| / sum(den) (for global-balance criteria like MB).
        """
        return {"Max": ("max", jnp.max(jnp.abs(r), axis=0))}

    def convergence_criterion(self, model, eq_name, r, state, dt):
        """Return dict criterion-name -> (neq,) array of errors.

        Default = max abs residual (reference equations.jl:620). Derived
        from convergence_parts; override convergence_parts, not this.
        """
        out = {}
        for name, (kind, payload) in self.convergence_parts(
                model, eq_name, r, state, dt).items():
            if kind == "max":
                out[name] = payload
            else:
                num, den = payload
                out[name] = jnp.abs(num) / den
        return out

    def default_tolerance(self, model) -> float:
        return 1e-6


class ConservationLaw(JutulEquation):
    """d(M)/dt + div(F) = q on cells (reference core_types.jl:850,
    conservation/conservation.jl:78-99).

    Parameters
    ----------
    flux_fn : callable(model, cell_states, face_state) -> (neq,)
        Flux from stencil cell 0 (left) to cell 1 (right) across the face.
    mass_fn : callable(model, cell_state) -> (neq,), optional
        Conserved quantity per cell (including volume factors). ``None``
        gives a steady-state equation (no accumulation term).
    neq : number of conserved quantities.
    scale_fn : optional callable(model, cell_state, dt) -> (neq,) used by the
        convergence criterion to scale residuals (e.g. dt / pore-volume as in
        the reference's CNV-style criterion).
    """

    def __init__(self, flux_fn, mass_fn=None, neq: int = 1, scale_fn=None,
                 flow_discretization=None, stencil=None):
        self.flux_fn = flux_fn
        self.mass_fn = mass_fn
        self.neq = int(neq)
        self.scale_fn = scale_fn
        self.flow_discretization = flow_discretization
        # optional wider flux stencil (nf, K), cols 0/1 = left/right —
        # used by WENO/NFVM discretizations (reference: flux.jl ad=:generic)
        self.stencil = stencil

    def number_of_equations_per_entity(self, model) -> int:
        return self.neq

    def contributions(self, model) -> list:
        out: list = []
        if self.mass_fn is not None:
            mass = self.mass_fn

            def acc(model_, cs, cs0, dt):
                return (mass(model_, cs) - mass(model_, cs0)) / dt

            out.append(AccumulationContribution(acc, name="accumulation"))
        geo = model.domain.geometry
        if self.flux_fn is not None and geo is not None and geo.n_faces > 0:
            st = self.stencil if self.stencil is not None else geo.neighbors
            st = np.asarray(st)
            out.append(
                FaceFluxContribution(
                    fn=self.flux_fn,
                    stencil=st,
                    plus=st[:, 0],
                    minus=st[:, 1],
                    name="flux",
                )
            )
        return out

    def convergence_parts(self, model, eq_name, r, state, dt):
        if self.scale_fn is not None:
            s = self.scale_fn(model, state, dt)  # (n_cells, neq) or (neq,)
            return {"CNV": ("max", jnp.max(jnp.abs(r * s), axis=0))}
        return {"Max": ("max", jnp.max(jnp.abs(r), axis=0))}
