"""jutul.jl_tpu — an implicit finite-volume multiphysics framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of Jutul.jl
(sintefmath/Jutul.jl): declarative models (primary/secondary variables,
parameters, residual equations on mesh entities), implicit adaptive
time-stepping with Newton's method, vmap(jacfwd) entity-local AD assembly
into block-ELL Jacobians, Krylov solvers + preconditioners, multimodel
coupling, discrete adjoints + optimization, and SPMD domain decomposition
over a jax.sharding.Mesh.
"""

from . import dtypes  # noqa: F401  (enables x64; must import first)

from .config import JutulConfig
from .core.case import JutulCase
from .core.domains import DataDomain, DiscretizedDomain
from .core.entities import (
    BoundaryFaces,
    Cells,
    Faces,
    HalfFaces,
    NoEntity,
    Nodes,
)
from .discretization.tpfa import (
    compute_boundary_trans,
    compute_face_gdz,
    compute_face_trans,
    compute_half_face_trans,
    expand_perm,
    half_face_map,
)
from .interpolation import (
    BilinearInterpolant,
    LinearInterpolant,
    UnaryTabulatedVariable,
    get_1d_interpolator,
    get_2d_interpolator,
)
from .meshes.cartesian import CartesianMesh, JutulMesh, tpfv_geometry
from .meshes.unstructured import (
    IndexRenumerator,
    IndirectionMap,
    UnstructuredMesh,
)
from .models.equations import (
    AccumulationContribution,
    CellTermContribution,
    ConservationLaw,
    FaceFluxContribution,
    JutulEquation,
)
from .models.forces import JutulForce, SourceTerm, setup_forces
from .models.setup import (
    setup_parameters,
    setup_state,
    setup_state_and_parameters,
)
from .models.system import JutulSystem, SimulationModel
from .models.test_systems import (
    PoissonSource,
    ScalarTestCrossTerm,
    ScalarTestDomain,
    ScalarTestForce,
    ScalarTestSystem,
    SimpleHeatSystem,
    VariablePoissonSystem,
)
from .models.variables import (
    ConstantVariables,
    FractionVariables,
    JutulParameter,
    JutulVariable,
    ScalarVariable,
    SecondaryVariable,
    VectorVariables,
    secondary_variable,
)
from .multimodel.core import (CrossTerm, AdditiveCrossTerm,
                              MultiModel, add_cross_term)
from .ops.assembly import CompiledModel, compile_model
from .ops.blockell import BlockELL, ELLStructure
from .simulator.io import (
    print_stats,
    read_results,
    report_stats,
    store_output,
    timing_breakdown,
    valid_restart_indices,
)
from .simulator.relaxation import NoRelaxation, SimpleRelaxation
from .simulator.reporting import (
    EndTimeTerminationCriterion,
    TerminationCriterion,
)
from .simulator.simulator import (
    SimResult,
    Simulator,
    expand_to_ministeps,
    simulate,
    simulator_config,
)
from .simulator.timesteps import (
    IterationTimestepSelector,
    LimitByFailedTimestepSelector,
    TimestepSelector,
    VariableChangeTimestepSelector,
)
from .adjoint.dict_opt import (
    DictParameters,
    DictParametersSampler,
    free_optimization_parameter,
    freeze_optimization_parameter,
    optimize,
    parameters_gradient,
)
from .simulator.distance_functions import (
    compute_distance,
    nonconverged_equations,
    scaled_residual_norm,
)
from .adjoint.gradients import (
    AdjointStorage,
    setup_adjoint_storage,
    solve_adjoint_forces,
    solve_adjoint_sensitivities,
    solve_adjoint_sensitivities_jit,
    solve_numerical_sensitivities,
    state_gradient,
)
from .adjoint.lbfgs import unit_box_bfgs
from .adjoint.trust_region import box_trust_region
from .adjoint.optimization import (
    optimization_config,
    setup_parameter_optimization,
)
from .linsolve.amg import AMGPreconditioner, SmoothedAggregationAMG
from .linsolve.cpr import CPRPreconditioner
from .linsolve.direct import DirectSolver
from .linsolve.krylov import GenericKrylov, bicgstab, gmres
from .linsolve.precond import (
    BlockJacobiPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SPAI0Preconditioner,
    TrivialPreconditioner,
)
from .meshes.coarse import CoarseMesh, coarsen_data_domain
from .meshes.radial import radial_mesh, spiral_mesh
from .meshes.tags import (
    MeshEntityTags,
    get_mesh_entity_tag,
    set_mesh_entity_tag,
)
from .meshes.trajectories import (
    find_enclosing_cells,
    trajectory_intersections,
)
from .meshes.embedded import (
    SurfaceMesh,
    embed_surface,
    fracture_matrix_trans,
)
from .meshes.cutcell import (
    PlaneCut,
    SurfaceCut,
    cut_mesh,
    embed_mesh,
    glue_mesh,
    merge_faces,
)
from .meshes.extruded import (
    check_and_fix_mesh,
    check_mesh,
    check_mesh_quality,
    extrude_mesh,
    face_planarity,
)
from .models.composite import CompositeSystem
from .models.helper import (
    HelperSimulator,
    model_accumulation,
    model_residual,
)
from .models.transport import NFVMPressureSystem, TransportSystem
from .models.vectorization import (
    data_domain_parameter_gradient,
    devectorize_variables,
    parameters_from_data_domain,
    parameters_jacobian_wrt_data_domain,
    vectorize_variables,
)
from .adjoint.generic import solve_adjoint_generic
from .adjoint.objectives import GlobalObjective, SumObjective
from .linsolve.schur import SchurComplementSolver
from .linsolve.system import LinearizedSystem
from .ops.stencil import (
    GMG,
    StencilCPR,
    StencilCompiledModel,
    StencilKrylovSolver,
)
from .parallel.adjoint import solve_adjoint_sensitivities_distributed
from .parallel.dd import subdomain, subforces, submodel, substate
from .parallel.partition import (
    GreedyGraphPartitioner,
    LinearPartitioner,
    MetisPartitioner,
)
from .parallel.general import GeneralDistributedSimulator
from .parallel.general_adjoint import solve_adjoint_sensitivities_general
from .parallel.sharded import DistributedSimulator, simulate_parray
from .units import convert_from_si, convert_to_si, si_unit, si_units
from .utils.gmsh import mesh_from_gmsh
from .utils.mrst import mesh_from_mat, mesh_from_mrst_grid
from .utils.plotting import triangulate_mesh

# Reference-compatible aliases (SURVEY appendix export list)
LUSolver = DirectSolver  # reference LUSolver = dense/direct fallback

__version__ = "0.1.0"
