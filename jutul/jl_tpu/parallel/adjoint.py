"""Distributed discrete adjoint over the slab decomposition.

JAX-native counterpart of the reference's distributed adjoint story: the
reference solves adjoints through the same PArray machinery it uses
forward (src/ad/gradients.jl:17-284 driving per-rank simulators;
ext/JutulPartitionedArraysExt/ for the transposed distributed solves).
Here the whole backward step for one report step is ONE jitted SPMD
program under ``jax.shard_map``:

- the transposed Jacobian operator is ``jax.linear_transpose`` of the
  forward halo-exchange matvec — the ``lax.ppermute`` halos transpose
  automatically (reverse permutation), so ghost-row couplings flow back
  to their owner shard without any hand-written reverse plan;
- parameter cotangents come from per-shard ``jax.vjp`` pulls of the local
  residual; cell parameters enter through the same halo exchange, so
  gradient contributions that a neighbor's residual makes to MY cells
  ride the transposed ppermute too;
- objective gradients assume the sum-objective form (reference
  core_types.jl:1582): ``G = Σ_shards g(owned cells)``, so ``∂G/∂u`` is
  shard-local and the total gradient is exact without extra collectives.

Gradients w.r.t. face parameters (e.g. Transmissibilities) are summed
across shards on the host: an interface face is assembled by BOTH
adjacent shards (each contributing its own owned row), and the global
∂G/∂T_f is the sum of the two shard-local contributions.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..linsolve.krylov import bicgstab
from ..models.setup import setup_parameters
from ..ops.smallmat import block_inv, bmv
from ..ops.blockell import ell_matvec
from .slab import local_to_global_cells


def _local_face_indices(dec, shard: int, global_mesh) -> np.ndarray:
    """(nf_loc,) global face index per local face; -1 for dead faces."""
    nb_l = dec.local_mesh.neighborship()
    gcell = local_to_global_cells(dec, shard)
    gl = gcell[nb_l[:, 0]]
    gr = gcell[nb_l[:, 1]]
    ok = (gl >= 0) & (gr >= 0)
    gnb = global_mesh.neighborship()
    n_glob = int(np.prod(dec.global_dims))
    key = gnb[:, 0].astype(np.int64) * n_glob + gnb[:, 1]
    order = np.argsort(key)
    key_sorted = key[order]
    out = np.full(nb_l.shape[0], -1, dtype=np.int64)
    q = gl[ok].astype(np.int64) * n_glob + gr[ok]
    pos = np.searchsorted(key_sorted, q)
    hit = key_sorted[np.clip(pos, 0, len(key_sorted) - 1)] == q
    idx = np.flatnonzero(ok)[hit]
    out[idx] = order[pos[hit]]
    return out


class DistributedAdjoint:
    """Adjoint sweeps over a ``DistributedSimulator``'s slab decomposition
    (reference counterpart: adjoints through PArraySimulator ranks)."""

    def __init__(self, dsim, parameters: dict | None = None):
        self.dsim = dsim
        dec = dsim.dec
        D = dsim.n_devices
        gparams = parameters or setup_parameters(dsim.global_model)
        self.global_params = gparams

        # cell parameters stay GLOBAL-shaped (slab order is contiguous, so
        # P(axis) sharding hands each shard its owned block); the residual
        # halo-exchanges them, so vjp returns OWNED cotangents with neighbor
        # contributions already routed home through the reversed ppermute.
        self.cp_names, self.fp_names = [], []
        cp_own, fp_loc = {}, {}
        for name, var in dsim.global_model.parameters.items():
            ent = var.associated_entity(dsim.global_model).name()
            g = np.asarray(gparams[name], dtype=np.float64)
            if ent == "Cells":
                cp_own[name] = g
                self.cp_names.append(name)
            elif ent == "Faces":
                fp_loc[name] = dsim.face_params[name]  # (D, nf_loc), dead=0
                self.fp_names.append(name)
            else:
                raise NotImplementedError(ent)
        self.cp_own = {k: jnp.asarray(v) for k, v in cp_own.items()}
        self.fp_loc = {k: jnp.asarray(v) for k, v in fp_loc.items()}
        self.face_l2g = np.stack([
            _local_face_indices(dec, d, dsim.global_mesh) for d in range(D)
        ])  # (D, nf_loc)
        self._step_cache = {}

    # ------------------------------------------------------------------
    def _local_residual(self, u_own, u0_own, cp_own, fp, q_own, dt):
        """Owned-row residual of this shard as a pure function of owned
        dofs and OWNED cell parameters (halo exchange inside — this is
        what makes the vjp cotangent routing exact)."""
        dsim = self.dsim
        comp = dsim.comp
        dec = dsim.dec
        halo = dsim._halo_exchange
        u_ext = halo(u_own)
        u0_ext = halo(u0_own)
        cp_ext = {k: halo(v) for k, v in cp_own.items()}
        state = {**comp.unpack_dofs(u_ext), **cp_ext, **fp}
        state0 = {**comp.unpack_dofs(u0_ext), **cp_ext, **fp}
        state = comp.evaluate_secondaries(state)
        state0 = comp.evaluate_secondaries(state0)
        r = comp.residual(state, state0, dt, None)
        return r[dec.own_slice] - q_own

    def _local_g(self, u_own, cp_own, G, dt, n):
        """Shard-local objective contribution g(owned cells); the global
        objective is the implicit psum of these (sum-objective form)."""
        comp = self.dsim.comp
        state = {**comp.unpack_dofs(u_own), **cp_own}
        state = comp.evaluate_secondaries(state)
        return G(self.dsim.global_model, state, dt, n, None)

    # ------------------------------------------------------------------
    def _build_step(self, G: Callable, n: int, has_next: bool):
        """One backward step as a single SPMD program: rhs build,
        transposed distributed solve, parameter cotangent pulls.
        NOTE: ``n`` is baked in statically (G may index host data by
        step), so an N-step sweep compiles N programs; make G read
        observations from a traced array and key on has_next alone if
        that compile cost matters."""
        dsim = self.dsim
        comp = dsim.comp
        dec = dsim.dec
        ax = dsim.axis
        own = dec.own_slice
        n_own, ndof, neq = dec.n_own, comp.ndof, comp.neq_total

        def local_step(u_n, u_prev, u_next, lam_next, cp_own, fp, q, dts):
            cp_own = {k: v for k, v in cp_own.items()}
            fp1 = {k: v[0] for k, v in fp.items()}
            q_own = q[0][own]
            dt_n, dt_next = dts[0], dts[1]

            # rhs = -dG/du_n - (dF_{n+1}/du_n)^T λ_{n+1}
            g_u, g_cp = jax.grad(
                lambda u, cp: self._local_g(u, cp, G, dt_n, n),
                argnums=(0, 1))(u_n, cp_own)
            rhs = -g_u
            if has_next:
                _, pull0 = jax.vjp(
                    lambda u0_: self._local_residual(
                        u_next, u0_, cp_own, fp1, q_own, dt_next), u_n)
                (du0_bar,) = pull0(lam_next)
                rhs = rhs - du0_bar

            # assemble J_n at (u_n, u_prev) and build the transposed op
            cp_ext = {k: dsim._halo_exchange(v) for k, v in cp_own.items()}
            full = {**comp.unpack_dofs(dsim._halo_exchange(u_n)),
                    **cp_ext, **fp1}
            full0 = {**comp.unpack_dofs(dsim._halo_exchange(u_prev)),
                     **cp_ext, **fp1}
            _r, J, _fe = comp.assemble(comp.evaluate_secondaries(full),
                                       comp.evaluate_secondaries(full0), dt_n)
            blocks = J.blocks
            cols = jnp.asarray(J.structure.cols)

            def matvec(x_flat):
                x_ext = dsim._halo_exchange(x_flat.reshape(n_own, ndof))
                return ell_matvec(blocks, cols, x_ext)[own].reshape(-1)

            matvec_T = jax.linear_transpose(matvec,
                                            jnp.zeros(n_own * ndof))
            # block-Jacobi on the transposed diagonal
            dinvT = jnp.swapaxes(block_inv(blocks[own.start:own.stop, 0]),
                                 1, 2)

            def precond(x_flat):
                return bmv(dinvT, x_flat.reshape(n_own, neq)).reshape(-1)

            def dot(a, b):
                return jax.lax.psum(jnp.dot(a, b), ax)

            lam_flat, stats = bicgstab(
                lambda y: matvec_T(y)[0], rhs.reshape(-1),
                maxiter=self.max_lin_it, rtol=self.rtol, precond=precond,
                dot_fn=dot)
            lam = lam_flat.reshape(n_own, neq)

            # parameter cotangents: ∇_p G += (dF_n/dp)^T λ + dG/dp
            _, pull = jax.vjp(
                lambda cp_, fp_: self._local_residual(
                    u_n, u_prev, cp_, fp_, q_own, dt_n), cp_own, fp1)
            cp_bar, fp_bar = pull(lam)
            cp_bar = {k: cp_bar[k] + g_cp[k] for k in cp_bar}
            fp_bar = {k: v[None] for k, v in fp_bar.items()}
            return lam, cp_bar, fp_bar, stats["iterations"]

        state_cp = {k: P(ax) for k in self.cp_own}
        state_fp = {k: P(ax) for k in self.fp_loc}
        u_spec = P(ax)
        return jax.jit(jax.shard_map(
            local_step,
            mesh=dsim.device_mesh,
            in_specs=(u_spec, u_spec, u_spec, u_spec, state_cp, state_fp,
                      P(ax), P()),
            out_specs=(u_spec, state_cp, state_fp, P()),
            check_vma=False,
        ))

    # ------------------------------------------------------------------
    def solve(self, states: list, timesteps, G: Callable, state0: dict,
              forces=None, rtol: float = 1e-10, max_lin_it: int = 400,
              reports: list | None = None):
        """Backward sweep; returns dict of GLOBAL gradient arrays for all
        model parameters (cells in mesh order, faces in global face order).

        ``states`` are the accepted global output states of the forward
        distributed run; ``G(model, state, dt, n, forces)`` must be a sum
        over cells (evaluated per shard on owned cells; constant forces
        only — the distributed path's current force surface).

        EXACTNESS REQUIREMENT: states[n] must solve ONE implicit step of
        size dts[n] (see general_adjoint.py) — pass ``reports`` to have
        cut ministeps detected."""
        if reports is not None:
            for i, rep in enumerate(reports):
                ok_minis = [m for m in rep.get("ministeps", [])
                            if m.get("success", True)]
                if len(ok_minis) > 1:
                    raise ValueError(
                        f"report step {i} used {len(ok_minis)} ministeps; "
                        "expand to ministep states for an exact adjoint.")
        dsim = self.dsim
        comp = dsim.comp
        dec = dsim.dec
        self.rtol = rtol
        self.max_lin_it = max_lin_it
        dts = np.atleast_1d(np.asarray(timesteps, dtype=np.float64))
        N = len(states)
        assert N == len(dts)
        # per-solve program cache: (n, has_next) keys are only valid for
        # THIS (G, rtol, max_lin_it) triple
        self._step_cache = {}

        sh = NamedSharding(dsim.device_mesh, P(dsim.axis))

        def dofs_of(state):
            u = comp.get_dofs({k: jnp.asarray(v) for k, v in state.items()
                               if k in dsim.global_model.primary_variables})
            return jax.device_put(u, sh)

        u0 = dofs_of(state0)
        us = [dofs_of(s) for s in states]
        q = jnp.asarray(dsim.stack_cell_sources(forces)) if forces else \
            jnp.zeros((dsim.n_devices, dec.n_ext, comp.neq_total))
        if forces and dsim.stack_boundary_conditions(forces) is not None:
            raise NotImplementedError(
                "distributed adjoint with pressure BCs not supported yet")

        cp_sh = {k: jax.device_put(v, sh) for k, v in self.cp_own.items()}
        cp_grad = {k: np.zeros(v.shape, dtype=np.float64)
                   for k, v in self.cp_own.items()}
        fp_grad = {k: np.zeros((dsim.n_devices,) + v.shape[1:])
                   for k, v in self.fp_loc.items()}
        lam = jnp.zeros_like(us[-1])
        u_next = us[-1]

        for n in range(N - 1, -1, -1):
            has_next = n < N - 1
            key = (n, has_next)
            if key not in self._step_cache:
                self._step_cache[key] = self._build_step(G, n, has_next)
            step = self._step_cache[key]
            u_prev = us[n - 1] if n > 0 else u0
            dt_pair = jnp.asarray([dts[n],
                                   dts[n + 1] if has_next else dts[n]])
            lam, cp_bar, fp_bar, _lin = step(
                us[n], u_prev, u_next, lam, cp_sh, self.fp_loc, q,
                dt_pair)
            for k in cp_grad:
                cp_grad[k] += np.asarray(cp_bar[k], dtype=np.float64)
            for k in fp_grad:
                fp_grad[k] += np.asarray(fp_bar[k], dtype=np.float64)
            u_next = us[n]

        out = dict(cp_grad)
        nfg = dsim.global_mesh.number_of_faces()
        for k, v in fp_grad.items():
            g = np.zeros(nfg)
            for d in range(dsim.n_devices):
                l2g = self.face_l2g[d]
                okm = l2g >= 0
                np.add.at(g, l2g[okm], v[d][okm])
            out[k] = g
        return out


def solve_adjoint_sensitivities_distributed(
        dsim, states: list, timesteps, G: Callable, state0: dict,
        forces=None, parameters: dict | None = None, **kw):
    """Distributed counterpart of ``solve_adjoint_sensitivities``
    (reference: BASELINE config 5 — dd-partitioned adjoint; the reference
    reuses its PArray machinery, src/ad/gradients.jl:17)."""
    return DistributedAdjoint(dsim, parameters=parameters).solve(
        states, timesteps, G, state0, forces=forces, **kw)
