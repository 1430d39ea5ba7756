"""Stencil assembly (ops/stencil.py: slicing residual, jvp Jacobian)
against the generic gather assembly (ops/assembly.py) and its BlockELL
Jacobian on the same two-phase Darcy model."""

import jax.numpy as jnp
import numpy as np

from jutul.jl_tpu import CartesianMesh, compile_model, setup_parameters, \
    setup_state, si_unit
from jutul.jl_tpu.models.darcy import ImmiscibleFluid, setup_darcy_model
from jutul.jl_tpu.models.setup import merge_state
from jutul.jl_tpu.ops.blockell import BlockELL
from jutul.jl_tpu.ops.stencil import StencilCompiledModel

BAR = si_unit("bar")
DARCY = si_unit("darcy")


def darcy_setup(nx=6, ny=8, nz=4, gravity=True):
    nc = nx * ny * nz
    rng = np.random.default_rng(3)
    mesh = CartesianMesh((nx, ny, nz), (6.0, 8.0, 4.0))
    model = setup_darcy_model(
        mesh, ImmiscibleFluid(viscosities=(1e-3, 3e-3),
                              compressibilities=(1e-9, 5e-10),
                              residual_saturations=(0.1, 0.15),
                              corey_exponents=(2.0, 3.0)),
        permeability=rng.lognormal(0, 1, nc) * 0.1 * DARCY,
        porosity=0.25, gravity=9.81 if gravity else False)
    sw = rng.uniform(0.15, 0.8, nc)
    state0 = setup_state(
        model, Pressure=100 * BAR + rng.uniform(-1, 1, nc) * BAR,
        Saturations=np.stack([sw, 1 - sw], 1))
    params = setup_parameters(model)
    comp = compile_model(model)
    full = comp.evaluate_secondaries(merge_state(
        {k: jnp.asarray(v) for k, v in state0.items()},
        {k: jnp.asarray(v) for k, v in params.items()}))
    full0 = dict(full)
    full0["Saturations"] = jnp.roll(full["Saturations"], 1, axis=0)
    full0 = comp.evaluate_secondaries(full0)
    return comp, full, full0


def _dense(J):
    """Dense (n*neq, n*ndof) matrix of a Jacobian from its action on the
    unit vectors."""
    n, ndof = J.n_rows, J.ndof
    eye = np.eye(n * ndof).reshape(n * ndof, n, ndof)
    return np.stack([np.asarray(J.matvec(jnp.asarray(e))).reshape(-1)
                     for e in eye], axis=1)


class _Generic:
    def __init__(self, comp, blocks):
        self.J = BlockELL(comp.ell, blocks)
        self.n_rows, self.ndof = comp.n_cells, comp.ndof

    def matvec(self, x):
        return self.J.matvec(x)


class _Stencil:
    def __init__(self, A):
        self.A = A
        self.n_rows, self.ndof = A.n, A.diag.shape[1]

    def matvec(self, x):
        return self.A.matvec(x)


def _assemble_both(gravity, forces=None):
    comp, full, full0 = darcy_setup(gravity=gravity)
    sc = StencilCompiledModel(comp)
    dt = 3e4
    r_st, A_st, _ = sc.assemble(full, full0, dt, forces)
    r_g = comp.residual(full, full0, dt, forces)
    blocks = comp.jacobian_blocks(full, full0, dt, forces)
    return (r_st, _Stencil(A_st)), (r_g, _Generic(comp, blocks))


def _assert_close(a, b, tol=1e-11):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def test_stencil_assembly_matches_gather_gravity():
    (r_st, J_st), (r_g, J_g) = _assemble_both(gravity=True)
    _assert_close(r_st, r_g)
    _assert_close(_dense(J_st), _dense(J_g))


def test_stencil_assembly_matches_gather_no_gravity():
    (r_st, J_st), (r_g, J_g) = _assemble_both(gravity=False)
    _assert_close(r_st, r_g)
    _assert_close(_dense(J_st), _dense(J_g))


def test_stencil_matvec_matches_blockell():
    (_, J_st), (_, J_g) = _assemble_both(gravity=True)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(J_g.n_rows, J_g.ndof)))
    _assert_close(J_st.matvec(x), J_g.matvec(x), 1e-12)


def test_stencil_assembly_with_source_forces():
    """Forces go through the same _apply_forces hook on both engines."""
    from jutul.jl_tpu.models.darcy import PhaseSourceTerm

    forces = {"sources": PhaseSourceTerm(
        [0, 17], np.array([[1e-3, 0.0], [-3e-4, -2e-4]]))}
    (r_st, J_st), (r_g, J_g) = _assemble_both(gravity=True, forces=forces)
    _assert_close(r_st, r_g)
    _assert_close(_dense(J_st), _dense(J_g))
