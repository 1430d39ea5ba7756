"""Execution contexts drive working precision and placement
(reference: src/core_types/contexts/, src/context.jl:12-96 —
float_type/index_type/transfer/select_contexts)."""

import jax
import jax.numpy as jnp
import numpy as np

from jutul.jl_tpu import (
    CartesianMesh,
    SimulationModel,
    Simulator,
    setup_parameters,
    setup_state,
)
import pytest

from jutul.jl_tpu.core import context as context_mod
from jutul.jl_tpu.core.context import (
    CPUContext,
    DefaultContext,
    GPUContext,
    select_contexts,
)
from jutul.jl_tpu.models.test_systems import ScalarTestForce, ScalarTestSystem


def _model(ctx):
    return SimulationModel(CartesianMesh((4,), (1.0,)), ScalarTestSystem(),
                           context=ctx)


F32 = CPUContext(float_dtype=np.float32)  # f32 working precision here


class _Dev:
    def __init__(self, platform):
        self.platform = platform


def test_select_contexts():
    assert isinstance(select_contexts("default"), DefaultContext)
    assert isinstance(select_contexts("gpu"), GPUContext)
    assert isinstance(select_contexts("cuda"), GPUContext)
    # CPU-only test rig: auto must not pick the GPU
    assert isinstance(select_contexts("auto"), DefaultContext)


def test_select_auto_picks_gpu_when_attached(monkeypatch):
    monkeypatch.setattr(context_mod.jax, "devices",
                        lambda *a: [_Dev("gpu"), _Dev("gpu")])
    ctx = select_contexts("auto")
    assert isinstance(ctx, GPUContext)
    assert ctx.float_type() == np.float32 and ctx.platform == "gpu"


def test_select_auto_without_gpu(monkeypatch):
    monkeypatch.setattr(context_mod.jax, "devices", lambda *a: [_Dev("cpu")])
    assert isinstance(select_contexts("auto"), DefaultContext)


def test_tpu_kind_raises():
    with pytest.raises(ValueError, match="tpu"):
        select_contexts("tpu")


def test_gpu_transfer_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no 'gpu' device"):
        GPUContext().transfer(np.ones(3))


def test_context_controls_simulator_dtype():
    for ctx, want in ((DefaultContext(), jnp.float64), (F32, jnp.float32)):
        model = _model(ctx)
        sim = Simulator(model,
                        state0=setup_state(model, XVar=1.0),
                        parameters=setup_parameters(model))
        assert sim.state0["XVar"].dtype == want, ctx
        res = sim.simulate([1.0], forces={"sources": ScalarTestForce(3.0)},
                           info_level=-1)
        x = np.asarray(res.states[-1]["XVar"])
        assert x.dtype == np.dtype(want)
        np.testing.assert_allclose(x, 4.0, rtol=1e-6)


def test_transfer_preserves_integer_arrays():
    ctx = F32
    idx = ctx.transfer(np.arange(5, dtype=np.int32))
    assert idx.dtype == jnp.int32


def test_mixed_precision_refinement():
    """f32 solve + f64-residual iterative refinement reaches <=1e-8
    (SURVEY hard part (e); the BASELINE north-star residual)."""
    import numpy as np

    from jutul.jl_tpu import si_unit
    from jutul.jl_tpu.models.darcy import (
        ImmiscibleFluid,
        PhaseSourceTerm,
        setup_darcy_model,
    )

    BAR = si_unit("bar")
    DARCY = si_unit("darcy")
    nx, ny = 8, 6
    nc = nx * ny
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny), (80.0, 60.0))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = setup_darcy_model(
        mesh, fluid, permeability=rng.uniform(0.2, 1.0, nc) * DARCY,
        porosity=0.25, gravity=False)

    model.context = F32
    sw = rng.uniform(0.3, 0.7, nc)
    state0 = setup_state(model, Pressure=100.0 * BAR,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    params = setup_parameters(model)
    forces = {"src": PhaseSourceTerm([0], np.array([[0.02, 0.0]]))}
    sim = Simulator(model, state0=state0, parameters=params)
    assert sim.state0["Pressure"].dtype == jnp.float32
    dt = 3600.0
    res = sim.simulate([dt], forces=forces, info_level=-1,
                       tolerances={"default": 1e-5},
                       max_nonlinear_iterations=20)
    assert res.reports[-1]["success"]

    # refinement: f64 state carry, f64 residual, f32 Jacobian solves
    final = {k: np.asarray(res.states[-1][k])
             for k in model.primary_variables}
    st64, info = sim.refine_solution(final, state0, dt, forces=forces,
                                     tol=1e-9, max_refine=10)
    assert info["converged"], info
    assert info["f64_max_abs_residual"] <= 1e-9
    # refinement must have actually improved on the f32 result
    assert info["f64_residual_history"][0] > info["f64_max_abs_residual"]


def test_refinement_with_solve_device():
    """solve_device= routes the f32 correction assembly+solve through ONE
    jitted program on the given device with resident params (the 1e-8
    on-device path, VERDICT r3 item 3; on CPU rigs the device is the CPU,
    exercising the identical program structure)."""
    import numpy as np

    from jutul.jl_tpu import si_unit
    from jutul.jl_tpu.models.darcy import (
        ImmiscibleFluid,
        PhaseSourceTerm,
        setup_darcy_model,
    )

    BAR = si_unit("bar")
    DARCY = si_unit("darcy")
    nx, ny, nz = 8, 6, 4
    nc = nx * ny * nz
    rng = np.random.default_rng(1)
    mesh = CartesianMesh((nx, ny, nz), (80.0, 60.0, 20.0))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = setup_darcy_model(
        mesh, fluid, permeability=rng.uniform(0.2, 1.0, nc) * DARCY,
        porosity=0.25, gravity=True)
    model.context = F32
    sw = rng.uniform(0.3, 0.7, nc)
    state0 = setup_state(model, Pressure=100.0 * BAR,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    params = setup_parameters(model)
    forces = {"src": PhaseSourceTerm([0], np.array([[0.02, 0.0]]))}
    # the flagship shape: stencil engine + StencilKrylovSolver
    from jutul.jl_tpu.ops.stencil import GMG, StencilCPR, StencilKrylovSolver

    solver = StencilKrylovSolver(
        preconditioner=StencilCPR(gmg=GMG(n_smooth=2, n_coarse_sweeps=30,
                                          min_cells=32)),
        rtol=1e-10, max_iterations=80)
    sim = Simulator(model, state0=state0, parameters=params,
                    use_stencil=True)
    dt = 3600.0
    res = sim.simulate([dt], forces=forces, info_level=-1,
                       linear_solver=solver,
                       tolerances={"default": 1e-5},
                       max_nonlinear_iterations=20)
    assert res.reports[-1]["success"]
    final = {k: np.asarray(res.states[-1][k])
             for k in model.primary_variables}
    dev = jax.devices()[0]
    st64, info = sim.refine_solution(final, state0, dt, forces=forces,
                                     tol=1e-9, max_refine=10,
                                     solver=solver, solve_device=dev)
    assert info["converged"], info
    assert info["f64_max_abs_residual"] <= 1e-9
    assert info["f64_residual_history"][0] > info["f64_max_abs_residual"]


@pytest.mark.gpu
def test_gpu_transfer_places_on_gpu():
    a = GPUContext().transfer(np.arange(4.0))
    assert a.dtype == jnp.float32
    assert {d.platform for d in a.devices()} == {"gpu"}
