"""Discrete adjoint gradients.

Counterpart of the reference adjoint solver (reference: src/ad/gradients.jl —
``solve_adjoint_sensitivities`` :17,230, ``setup_adjoint_storage`` :108,
``update_sensitivities!`` :483, ``next_lagrange_multiplier!`` :519; and the
AdjointsDI generic path src/ad/AdjointsDI/adjoints.jl:4).

Same mathematics — backward-in-time Lagrange multipliers
    (dF_n/dx_n)^T λ_n = -(dG/dx_n)^T - (dF_{n+1}/dx_n)^T λ_{n+1}
    ∇_p G = dG/dp + Σ_n (dF_n/dp)^T λ_n
— but a fraction of the machinery: the reference builds THREE specially
laid-out simulators (forward/backward/parameter, gradients.jl:168-224,
swap_primary_with_parameters! :623). Here:

- (dF_n/dx_n)^T is the block-ELL Jacobian we already assemble, applied
  transposed (ell_rmatvec) or solved directly;
- (dF_{n+1}/dx_n)^T λ and (dF_n/dp)^T λ are single ``jax.vjp`` reverse
  passes through the SAME jitted residual function — no second model, no
  adjoint layouts, no sparsity re-detection.

States must be the accepted ministep sequence for exactness (reference
requirement too); use ``expand_to_ministeps`` when ministeps were cut.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..models.setup import merge_state
from ..ops.assembly import CompiledModel, compile_model
from ..ops.blockell import BlockELL, ell_rmatvec, ell_to_dense, ell_transpose
from ..linsolve.krylov import gmres


class AdjointStorage:
    """Precompiled jitted kernels for adjoint sweeps
    (reference setup_adjoint_storage, gradients.jl:108)."""

    def __init__(self, model, parameters: dict, forces=None,
                 direct_limit: int = 20_000, linear_solver=None,
                 use_stencil: bool = False):
        self.model = model
        self.comp = compile_model(model)
        # STENCIL adjoint mode (r4, VERDICT r3 item 4 — the 1M adjoint):
        # residual/Jacobian through the structured fast path and the
        # transposed lambda-solves as StencilKrylovSolver(CPR-GMG) on the
        # TRANSPOSED StencilMatrix (ops/stencil.py stencil_transpose) —
        # the same preconditioner stack as the forward flagship, so the
        # sweep compiles and runs at sizes where the generic BlockELL +
        # ILU0 path is compile- and memory-prohibitive.
        self._stencil = None
        self._stencil_solver = None
        if use_stencil:
            from ..ops.stencil import (
                GMG,
                StencilCompiledModel,
                StencilCPR,
                StencilKrylovSolver,
            )

            from ..models.wells import WellGraphMesh

            mesh = getattr(getattr(model, "domain", None), "mesh", None)
            if isinstance(mesh, WellGraphMesh):
                from ..ops.stencil_wells import BorderedStencilModel

                self._stencil = BorderedStencilModel(self.comp)
            else:
                self._stencil = StencilCompiledModel(self.comp)
            if linear_solver is None:
                linear_solver = StencilKrylovSolver(
                    preconditioner=StencilCPR(gmg=GMG(
                        n_smooth=2, n_coarse_sweeps=12, min_cells=16384)),
                    rtol=1e-8, max_iterations=100)
            if not isinstance(linear_solver, StencilKrylovSolver):
                raise TypeError("use_stencil=True needs a "
                                "StencilKrylovSolver (or None for the "
                                "CPR-GMG default)")
            self._stencil_solver = linear_solver
            linear_solver = None  # the BlockELL tsolve path stays off
        # optional preconditioned Krylov for the transposed lambda-solves
        # (reference behavior: the adjoint-layout system goes through the
        # SAME GenericKrylov+preconditioner stack as the forward solve,
        # gradients.jl:168-224) — required in practice for f32 device sweeps
        # where unpreconditioned GMRES at rtol 1e-10 stagnates. Jitted ONCE
        # here: an eager per-step call would retrace the Krylov while_loop
        # every backward step (fresh matvec closure = cache miss).
        self.linear_solver = linear_solver
        if linear_solver is not None:
            comp_ = self.comp
            comp_.ell.transpose_idx()  # host-build (and symmetry-check)
            # the plan eagerly, before tracing

            @jax.jit
            def tsolve(blocks, rhs):
                Jt = BlockELL(
                    comp_.ell,
                    ell_transpose(blocks, comp_.ell.transpose_idx()))
                lam, _ = linear_solver.solve(Jt, -rhs)
                return lam

            self._tsolve = tsolve
        self.parameters = {k: jnp.asarray(v) for k, v in parameters.items()}
        # integer parameters (e.g. WENO membership index tables) are not
        # differentiable: close over them, differentiate the float ones
        self.params_f = {k: v for k, v in self.parameters.items()
                         if jnp.issubdtype(v.dtype, jnp.floating)}
        self.params_i = {k: v for k, v in self.parameters.items()
                         if k not in self.params_f}
        self.forces = forces
        self.direct_limit = direct_limit
        comp = self.comp
        params_i = self.params_i
        engine = self._stencil if self._stencil is not None else comp

        def residual_from_dofs(u, u0, params, dt, forces_):
            params = {**params_i, **params}
            state = merge_state(comp.unpack_dofs(u), params)
            state0 = merge_state(comp.unpack_dofs(u0), params)
            state = comp.evaluate_secondaries(state)
            state0 = comp.evaluate_secondaries(state0)
            return engine.residual(state, state0, dt, forces_)

        self._residual_from_dofs = residual_from_dofs

        @jax.jit
        def jac_blocks(u, u0, params, dt, forces_):
            params = {**params_i, **params}
            state = merge_state(comp.unpack_dofs(u), params)
            state0 = merge_state(comp.unpack_dofs(u0), params)
            state = comp.evaluate_secondaries(state)
            state0 = comp.evaluate_secondaries(state0)
            if self._stencil is not None:
                return self._stencil.jacobian(state, state0, dt, forces_)
            return comp.jacobian_blocks(state, state0, dt, forces_)

        @jax.jit
        def vjp_u0_p(u, u0, params, dt, forces_, lam):
            _, pull = jax.vjp(
                lambda u0_, p_: residual_from_dofs(u, u0_, p_, dt, forces_),
                u0, params)
            return pull(lam)

        self._jac_blocks = jac_blocks
        self._vjp_u0_p = vjp_u0_p

    def float_params(self, parameters: dict | None = None) -> dict:
        """Float parameters for a solve call: the storage's own when
        ``parameters`` is None, else the call's values (must carry the
        same float/int key split — the integer tables are closed over)."""
        if parameters is None:
            return self.params_f
        out = {k: jnp.asarray(v) for k, v in parameters.items()
               if k in self.params_f}
        missing = set(self.params_f) - set(out)
        if missing:
            raise KeyError(f"reused AdjointStorage: missing float "
                           f"parameters {sorted(missing)}")
        return out

    # -- transpose solve ---------------------------------------------------
    def solve_transposed(self, blocks, rhs):
        """Solve J^T lam = rhs; rhs (n, ndof) -> lam (n, neq)."""
        comp = self.comp
        n = comp.n_cells
        ndof = comp.ndof
        if self._stencil is not None:
            from ..ops.stencil import stencil_transpose
            from ..ops.stencil_wells import (
                BorderedStencilMatrix,
                bordered_transpose,
            )

            # blocks IS a StencilMatrix (or its bordered well variant);
            # the transpose has the same structure, solved by the forward
            # CPR-GMG stack (solver.solve solves A du = -r, so pass -rhs)
            tr = (bordered_transpose
                  if isinstance(blocks, BorderedStencilMatrix)
                  else stencil_transpose)
            lam, _ = self._stencil_solver.solve(
                tr(blocks), -rhs.reshape(n, ndof))
            return lam.reshape(n, comp.neq_total)
        if self.linear_solver is not None:
            # _tsolve flips the sign (GenericKrylov solves J du = -r)
            lam = self._tsolve(blocks, rhs.reshape(n, ndof))
            return lam.reshape(n, comp.neq_total)
        if n * ndof <= self.direct_limit:
            dense = ell_to_dense(blocks, comp.ell.cols)
            lam = jnp.linalg.solve(dense.T, rhs.reshape(-1))
            return lam.reshape(n, comp.neq_total)

        cols = jnp.asarray(comp.ell.cols)

        def matvec(x):
            return ell_rmatvec(blocks, cols, x.reshape(n, comp.neq_total)
                               ).reshape(-1)

        # f64 CPU path where certainty beats matmul throughput: keep the
        # sequential MGS formulation for the adjoint lambda solves
        lam, stats = gmres(matvec, rhs.reshape(-1), rtol=1e-10, maxiter=500,
                           orth="mgs")
        return lam.reshape(n, comp.neq_total)


def setup_adjoint_storage(model, parameters: dict, forces=None,
                          direct_limit: int = 20_000,
                          linear_solver=None,
                          use_stencil: bool = False) -> AdjointStorage:
    """Reference-named constructor (gradients.jl:108): precompile the
    adjoint sweep kernels once and reuse across solves."""
    return AdjointStorage(model, parameters, forces=forces,
                          direct_limit=direct_limit,
                          linear_solver=linear_solver,
                          use_stencil=use_stencil)


def solve_adjoint_sensitivities(
    model_or_case,
    states: list,
    timesteps_or_reports,
    G: Callable,
    parameters: dict | None = None,
    state0: dict | None = None,
    forces=None,
    include_state0: bool = False,
    linear_solver=None,
    storage: "AdjointStorage | None" = None,
    use_stencil: bool = False,
):
    """∇_p G for G = Σ_n g(model, state_n, dt_n, n, forces)
    (reference gradients.jl:17).

    ``states`` are output states (dicts with at least the primaries) of the
    accepted step sequence; ``G(model, state, dt, step_no, forces) ->
    scalar`` is the per-step objective (reference's sum-objective form,
    core_types.jl:1582).

    Returns dict of gradients with the parameter shapes (plus
    ``"state0"`` entry when requested).
    """
    from ..core.case import JutulCase

    if isinstance(model_or_case, JutulCase):
        case = model_or_case
        model = case.model
        parameters = parameters if parameters is not None else case.parameters
        state0 = state0 if state0 is not None else case.state0
        forces = forces if forces is not None else case.forces
        dts = np.atleast_1d(np.asarray(case.dt, dtype=np.float64))
    else:
        model = model_or_case
        dts = np.atleast_1d(np.asarray(timesteps_or_reports, dtype=np.float64))
    if parameters is None or state0 is None:
        raise ValueError("parameters and state0 are required")

    from ..multimodel.core import MultiModel

    if isinstance(model, MultiModel):
        return solve_adjoint_sensitivities_multimodel(
            model, states, dts, G, parameters, state0, forces)

    if storage is None:
        storage = AdjointStorage(model, parameters, forces,
                                 linear_solver=linear_solver,
                                 use_stencil=use_stencil)
    comp = storage.comp
    # params from THIS call (a reused storage keeps only the structure and
    # jitted kernels — reference optimization.jl caches adjoint storage
    # between optimizer iterations while the parameters change)
    params = storage.float_params(parameters)

    def dofs_of(state) -> jnp.ndarray:
        return comp.get_dofs({k: jnp.asarray(v) for k, v in state.items()
                              if k in model.primary_variables})

    u0 = dofs_of(state0)
    us = [dofs_of(s) for s in states]
    N = len(us)
    assert N == len(dts), (N, len(dts))

    # dG/dx_n in dof space and dG/dp, via vjp through the evaluated state
    def g_of(u, params_, dt, n):
        state = merge_state(comp.unpack_dofs(u),
                            {**storage.params_i, **params_})
        state = comp.evaluate_secondaries(state)
        return G(model, state, dt, n, _forces_for(forces, n))

    g_grad_u = jax.jit(jax.grad(g_of, argnums=0), static_argnums=(3,))
    g_grad_p = jax.jit(jax.grad(g_of, argnums=1), static_argnums=(3,))

    grad_p = jax.tree_util.tree_map(jnp.zeros_like, params)
    lam_next = None
    u_next = None

    for n in range(N - 1, -1, -1):
        u_n = us[n]
        u_prev = us[n - 1] if n > 0 else u0
        dt_n = float(dts[n])
        f_n = _forces_for(forces, n)

        rhs = -g_grad_u(u_n, params, dt_n, n)
        grad_p = _tree_add(grad_p, g_grad_p(u_n, params, dt_n, n))
        if lam_next is not None:
            dt_np1 = float(dts[n + 1])
            f_np1 = _forces_for(forces, n + 1)
            du0_bar, _ = storage._vjp_u0_p(u_next, u_n, params, dt_np1,
                                           f_np1, lam_next)
            rhs = rhs - du0_bar

        blocks = storage._jac_blocks(u_n, u_prev, params, dt_n, f_n)
        lam = storage.solve_transposed(blocks, rhs)

        _, dp_bar = storage._vjp_u0_p(u_n, u_prev, params, dt_n, f_n, lam)
        grad_p = _tree_add(grad_p, dp_bar)
        # the u_prev cotangent also flows into p when n == 0 via state0?
        # state0 is data, not a parameter; exposed separately below.
        lam_next = lam
        u_next = u_n

    out = {k: np.asarray(v) for k, v in grad_p.items()}
    for k, v in storage.params_i.items():  # zero grads for int params
        out[k] = np.zeros(np.asarray(v).shape)
    if include_state0:
        du0_bar, _ = storage._vjp_u0_p(us[0], u0, params, float(dts[0]),
                                       _forces_for(forces, 0), lam_next)
        out["state0"] = np.asarray(du0_bar)
    return out


def solve_adjoint_sensitivities_jit(
    model,
    states: list,
    timesteps,
    G: Callable,
    parameters: dict | None = None,
    state0: dict | None = None,
    forces=None,
    include_state0: bool = False,
    linear_solver=None,
    storage: AdjointStorage | None = None,
    use_stencil: bool = False,
):
    """Whole adjoint sweep as ONE device execution: a reversed
    ``lax.scan`` over steps with the transposed lambda-solves (optionally
    preconditioned Krylov) inside the program.

    JAX-native counterpart of the reference's backward-in-time host loop
    (gradients.jl:230-284): where the reference re-assembles and solves
    per step from the host, here the stacked dof states ride a scan and
    the entire sweep — residual transposes, Krylov while_loops, vjp
    pulls, gradient accumulation — compiles to one XLA program. Pairs
    with ``simulate_jit(jit_output_states=True)`` for a
    two-device-execution forward+gradient pipeline.

    Same contract as :func:`solve_adjoint_sensitivities`, except ``G``
    receives a TRACED step index ``n`` (index per-step observations with
    jnp gathers, not Python lists). Pass ``storage`` to reuse the
    compiled sweep across calls (it is cached per (storage, G) anyway).
    """
    if parameters is None or state0 is None:
        raise ValueError("parameters and state0 are required")
    if storage is None:
        storage = AdjointStorage(model, parameters,
                                 linear_solver=linear_solver,
                                 use_stencil=use_stencil)
    comp = storage.comp
    params = storage.float_params(parameters)
    dts_np = np.atleast_1d(np.asarray(timesteps, dtype=np.float64))
    N = len(states)
    assert N == len(dts_np), (N, len(dts_np))

    def dofs_of(state):
        return comp.get_dofs({k: jnp.asarray(v) for k, v in state.items()
                              if k in model.primary_variables})

    u0 = dofs_of(state0)
    U = jnp.stack([dofs_of(s) for s in states])  # (N, n, ndof)
    per_step = isinstance(forces, (list, tuple))
    if per_step:
        if len(forces) != N:
            raise ValueError(f"per-step forces: {len(forces)} for {N} steps")
        defs = [jax.tree_util.tree_structure(f) for f in forces]
        if any(d != defs[0] for d in defs[1:]):
            raise NotImplementedError(
                "jit adjoint sweep: per-step forces must share one "
                "structure (same force names/types/cells)")
        forces_t = jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *forces)
    else:
        forces_t = None

    key = (id(G), per_step, bool(include_state0))
    cache = getattr(storage, "_sweep_cache", None)
    if cache is None:
        cache = storage._sweep_cache = {}
    if key not in cache:
        const_forces = forces if not per_step else None

        def g_of(u, params_, dt, n, f):
            state = merge_state(comp.unpack_dofs(u),
                                {**storage.params_i, **params_})
            state = comp.evaluate_secondaries(state)
            return G(model, state, dt, n, f)

        def sweep(U_, u0_, params_, dts_, forces_s):
            dts_ = dts_.astype(U_.dtype)
            U_prev = jnp.concatenate([u0_[None], U_[:-1]])
            # step n's cross term needs (dt, forces) of step n+1; the
            # last step has lam_next = 0, so any valid pad works
            dt_next = jnp.concatenate([dts_[1:], dts_[-1:]])
            if per_step:
                f_next_s = jax.tree_util.tree_map(
                    lambda a: jnp.concatenate([a[1:], a[-1:]]), forces_s)
            ns = jnp.arange(N)

            def body(carry, xs):
                grad_p, lam_next, u_next = carry
                if per_step:
                    u_n, u_prev, dt_n, dt_np1, n, f_n, f_np1 = xs
                else:
                    u_n, u_prev, dt_n, dt_np1, n = xs
                    f_n = f_np1 = const_forces
                rhs = -jax.grad(g_of, argnums=0)(u_n, params_, dt_n, n, f_n)
                gp = jax.grad(g_of, argnums=1)(u_n, params_, dt_n, n, f_n)
                # lam_next is exactly zero on the first (last-step) trip:
                # the pull-back is linear in it, so the pad contributes 0
                du0_bar, _ = storage._vjp_u0_p(u_next, u_n, params_, dt_np1,
                                               f_np1, lam_next)
                rhs = rhs - du0_bar
                blocks = storage._jac_blocks(u_n, u_prev, params_, dt_n, f_n)
                lam = storage.solve_transposed(blocks, rhs)
                _, dp_bar = storage._vjp_u0_p(u_n, u_prev, params_, dt_n,
                                              f_n, lam)
                grad_p = _tree_add(grad_p, _tree_add(gp, dp_bar))
                return (grad_p, lam, u_n), None

            xs = ((U_, U_prev, dts_, dt_next, ns, forces_s, f_next_s)
                  if per_step else (U_, U_prev, dts_, dt_next, ns))
            init = (jax.tree_util.tree_map(jnp.zeros_like, params_),
                    jnp.zeros((comp.n_cells, comp.neq_total), U_.dtype),
                    U_[-1])
            (grad_p, lam0, _), _ = jax.lax.scan(body, init, xs,
                                                reverse=True)
            out = (grad_p,)
            if include_state0:
                f0 = (jax.tree_util.tree_map(lambda a: a[0], forces_s)
                      if per_step else const_forces)
                du0_bar, _ = storage._vjp_u0_p(U_[0], u0_, params_,
                                               dts_[0], f0, lam0)
                out = out + (du0_bar,)
            return out

        cache[key] = jax.jit(sweep)

    res = cache[key](U, u0, params, jnp.asarray(dts_np), forces_t)
    out = {k: np.asarray(v) for k, v in res[0].items()}
    for k, v in storage.params_i.items():
        out[k] = np.zeros(np.asarray(v).shape)
    if include_state0:
        out["state0"] = np.asarray(res[1])
    return out


def solve_numerical_sensitivities(model, states, dts, G, parameters,
                                  state0, forces=None, eps_scale: float = 1e-6,
                                  targets=None, **sim_kwargs):
    """Finite-difference gradient checker (reference gradients.jl:700).

    Re-simulates with perturbed parameters; O(n_params) cost — tests only.
    Extra kwargs are forwarded to ``simulate`` (e.g. tight tolerances).
    """
    from ..simulator.simulator import simulate

    def total_objective(params_np: dict) -> float:
        res = simulate(dict(state0), model, dts, forces=forces,
                       parameters=params_np, info_level=-1, **sim_kwargs)
        tot = 0.0
        for n, st in enumerate(res.states):
            full = dict(st)
            tot += float(G(model, {k: jnp.asarray(v) for k, v in full.items()},
                           float(dts[n]), n, _forces_for(forces, n)))
        return tot

    grads = {}
    names = targets if targets is not None else list(parameters)
    for name in names:
        base = np.asarray(parameters[name], dtype=np.float64)
        g = np.zeros_like(base)
        it = np.nditer(base, flags=["multi_index"])
        for _ in it:
            ix = it.multi_index
            # relative perturbation (parameters span ~30 orders of magnitude
            # across units; an absolute step would destroy e.g. trans ~1e-11)
            h = eps_scale * abs(base[ix]) if base[ix] != 0 else eps_scale
            pp = {k: np.array(v, dtype=np.float64) for k, v in parameters.items()}
            pp[name][ix] = base[ix] + h
            fp = total_objective(pp)
            pm = {k: np.array(v, dtype=np.float64) for k, v in parameters.items()}
            pm[name][ix] = base[ix] - h
            fm = total_objective(pm)
            g[ix] = (fp - fm) / (2 * h)
        grads[name] = g
    return grads


def _forces_for(forces, n):
    if isinstance(forces, list):
        return forces[n]
    return forces


def _tree_add(a, b):
    return jax.tree_util.tree_map(lambda x, y: x + y, a, b)


def solve_adjoint_forces(model, states, dts, G, parameters, state0,
                         forces):
    """Gradient of G with respect to force VALUES (reference:
    src/ad/force_gradients.jl — vectorize_forces + adjoint; here one
    jax.vjp through the force-application path replaces the whole module).

    Returns a pytree of the same structure as ``forces`` with gradients in
    the traced leaves (static fields untouched).
    """
    import jax

    storage = AdjointStorage(model, parameters, forces)
    comp = storage.comp
    params = storage.params_f

    def dofs_of(state):
        return comp.get_dofs({k: jnp.asarray(v) for k, v in state.items()
                              if k in model.primary_variables})

    u0 = dofs_of(state0)
    us = [dofs_of(s) for s in states]
    N = len(us)
    dts = np.atleast_1d(np.asarray(dts, dtype=np.float64))

    def residual_f(u, u_prev, f, dt):
        return storage._residual_from_dofs(u, u_prev, params, dt, f)

    def g_of(u, f, dt, n):
        state = merge_state(comp.unpack_dofs(u), params)
        state = comp.evaluate_secondaries(state)
        return G(model, state, dt, n, f)

    grad_f = None
    lam_next = None
    u_next = None
    for n in range(N - 1, -1, -1):
        u_n = us[n]
        u_prev = us[n - 1] if n > 0 else u0
        dt_n = float(dts[n])
        f_n = _forces_for(forces, n)

        rhs = -jax.grad(g_of, argnums=0)(u_n, f_n, dt_n, n)
        gf_direct = jax.grad(g_of, argnums=1, allow_int=True)(
            u_n, f_n, dt_n, n)
        if lam_next is not None:
            dt_np1 = float(dts[n + 1])
            f_np1 = _forces_for(forces, n + 1)
            du0_bar, _ = storage._vjp_u0_p(u_next, u_n, params, dt_np1,
                                           f_np1, lam_next)
            rhs = rhs - du0_bar
        blocks = storage._jac_blocks(u_n, u_prev, params, dt_n, f_n)
        lam = storage.solve_transposed(blocks, rhs)

        _, pull = jax.vjp(lambda f_: residual_f(u_n, u_prev, f_, dt_n), f_n)
        (df_bar,) = pull(lam)
        step_grad = jax.tree_util.tree_map(lambda a, b: a + b, df_bar,
                                           gf_direct)
        if isinstance(forces, list):
            if grad_f is None:
                grad_f = [None] * N
            grad_f[n] = step_grad
        else:
            grad_f = step_grad if grad_f is None else jax.tree_util.tree_map(
                lambda a, b: a + b, grad_f, step_grad)
        lam_next = lam
        u_next = u_n
    return grad_f


# ---------------------------------------------------------------------------
# multimodel adjoints (reference: src/multimodel/gradients.jl:2-160)
# ---------------------------------------------------------------------------
def solve_adjoint_sensitivities_multimodel(
    mm, states: list, dts, G, parameters: dict, state0: dict, forces=None,
    direct_limit: int = 20_000,
):
    """Discrete adjoint for MultiModel cases: same backward recursion with
    the coupled MultiLinearizedSystem transposed (dense for the small
    coupled systems this targets — wells etc.).

    ``states``/``state0``/``parameters`` are dicts model-name -> dict;
    ``G(mm, state, dt, n, forces)`` sees the nested state. Returns nested
    gradients for all parameters.
    """
    from ..multimodel.core import compile_multi_model

    comp = compile_multi_model(mm)
    params = {m: {k: jnp.asarray(v) for k, v in p.items()}
              for m, p in parameters.items()}
    dts = np.atleast_1d(np.asarray(dts, dtype=np.float64))

    def dofs_of(state):
        return {m: comp.comps[m].get_dofs(
            {k: jnp.asarray(v) for k, v in state[m].items()
             if k in mm.models[m].primary_variables}) for m in comp.comps}

    def merge_all(u_dict, p_dict):
        return {m: merge_state(comp.comps[m].unpack_dofs(u_dict[m]),
                               p_dict[m]) for m in comp.comps}

    def residual_from_dofs(u, u0, p, dt, f):
        full = comp.evaluate_secondaries(merge_all(u, p))
        full0 = comp.evaluate_secondaries(merge_all(u0, p))
        return comp.residual(full, full0, dt, f)

    def g_of(u, p, dt, n):
        full = comp.evaluate_secondaries(merge_all(u, p))
        return G(mm, full, dt, n, _forces_for(forces, n))

    u0 = dofs_of(state0)
    us = [dofs_of(s) for s in states]
    N = len(us)

    lay = comp.layout

    def flatten_res(rd):
        return jnp.concatenate([rd[m].reshape(-1) for m in lay.names])

    def unflatten_res(v):
        return {m: v[lay.res_slices[m][0]].reshape(lay.res_slices[m][1])
                for m in lay.names}

    def transpose_solve(u_n, u_prev, dt_n, f_n, rhs_dofs):
        full = comp.evaluate_secondaries(merge_all(u_n, params))
        full0 = comp.evaluate_secondaries(merge_all(u_prev, params))
        _r, J, _fe = comp.assemble(full, full0, dt_n, f_n)
        rhs = jnp.concatenate([rhs_dofs[m].reshape(-1) for m in lay.names])
        if lay.total_dof <= direct_limit:
            lam = jnp.linalg.solve(J.to_dense().T, rhs)
            return unflatten_res(lam)
        # large coupled systems: matrix-free transposed Krylov (densifying
        # the whole MultiLinearizedSystem is dead past ~10k coupling rows)
        from ..linsolve.krylov import bicgstab
        from ..ops.smallmat import block_inv, bmv

        matvec_T = jax.linear_transpose(J.matvec_flat,
                                        jnp.zeros(lay.total_dof))
        dinvT = {m: jnp.swapaxes(block_inv(J.diag[m].blocks[:, 0]), 1, 2)
                 for m in lay.names}

        def precond(v):
            x = J.unflatten_res(v)
            return jnp.concatenate(
                [bmv(dinvT[m], x[m]).reshape(-1) for m in lay.names])

        lam, _stats = bicgstab(lambda v: matvec_T(v)[0], rhs,
                               maxiter=1000, rtol=1e-10, precond=precond)
        return unflatten_res(lam)

    grad_p = jax.tree_util.tree_map(jnp.zeros_like, params)
    lam_next = None
    u_next = None
    for n in range(N - 1, -1, -1):
        u_n = us[n]
        u_prev = us[n - 1] if n > 0 else u0
        dt_n = float(dts[n])
        f_n = _forces_for(forces, n)
        rhs = jax.tree_util.tree_map(
            lambda a: -a, jax.grad(g_of, argnums=0)(u_n, params, dt_n, n))
        grad_p = _tree_add(grad_p,
                           jax.grad(g_of, argnums=1)(u_n, params, dt_n, n))
        if lam_next is not None:
            dt_np1 = float(dts[n + 1])
            f_np1 = _forces_for(forces, n + 1)
            _, pull = jax.vjp(
                lambda u0_: residual_from_dofs(u_next, u0_, params, dt_np1,
                                               f_np1), u_n)
            (du0_bar,) = pull(lam_next)
            rhs = jax.tree_util.tree_map(lambda a, b: a - b, rhs, du0_bar)
        lam = transpose_solve(u_n, u_prev, dt_n, f_n, rhs)
        _, pull = jax.vjp(
            lambda p_: residual_from_dofs(u_n, u_prev, p_, dt_n, f_n), params)
        (dp_bar,) = pull(lam)
        grad_p = _tree_add(grad_p, dp_bar)
        lam_next = lam
        u_next = u_n
    return jax.tree_util.tree_map(np.asarray, grad_p)


def state_gradient(model, state, G, parameters, dt: float = 1.0,
                   step_no: int = 0, forces=None):
    """dG/d(primary state) for a single state (reference export
    ``state_gradient``; gradients.jl state_gradient_inner! role). Returns a
    dict of per-variable gradients in VALUE space."""
    import jax

    comp = compile_model(model)
    params = {k: jnp.asarray(v) for k, v in parameters.items()}

    def g_of(prim):
        full = merge_state(prim, params)
        full = comp.evaluate_secondaries(full)
        return G(model, full, dt, step_no, forces)

    prim = {k: jnp.asarray(v) for k, v in state.items()
            if k in model.primary_variables}
    grads = jax.grad(g_of)(prim)
    return {k: np.asarray(v) for k, v in grads.items()}
