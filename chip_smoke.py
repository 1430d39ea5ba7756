"""Smoke run of the flagship simulation on one GPU.

Drives the system's main path once, through the entry points a user
calls, at the flagship size (``bench.py``), and checks what comes out:

1. device    — JAX version, device kind and count, the card's name and
               power limit (nvidia-smi), the matmul precision; then the
               test suite's ``gpu``-marked tests;
2. flagship  — the 1,048,576-cell two-phase flow with five well models,
               three report steps; compile and run seconds, Newtons,
               linear iterations, peak device memory; the final accepted
               step must meet the run's own acceptance in f64;
3. reference — the stencil engine's operators against the generic
               gather/BlockELL engine on the card, and a small case run
               end to end on the card (stencil engine) and on the host
               CPU (generic engine), both in f64;
4. adjoint   — the gradient sweep at the flagship size, and its f64
               central-difference dot test at 32x32x8.

The last line of standard output is the JSON object
``{"ok": true, "device": {...}}``, printed only when every phase passed;
any failure propagates and the exit code is non-zero. Without a GPU the
script exits non-zero before running anything.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # only the four-card phase

``--four-cards`` runs the distributed simulator over a 4-card mesh and
compares it with the single-card simulator (forward states and adjoint
gradient), and nothing else.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402

# Operator reference: f32 stencil matvec against the f64 generic engine.
# Inputs are the f64 Jacobian rounded to f32 (relative 6e-8) and each row
# sums 14 products; 1e-5 of the output's max leaves room for two decades
# of cancellation between the diagonal and off-diagonal terms.
TOL_MATVEC_F32 = 1e-5
# f64 against f64: the two engines sum the same terms in other orders,
# so they agree to a few ulps of the largest entry.
TOL_F64 = 1e-12
# End-to-end reference: both runs converge Newton to 1e-10 with linear
# solves at 1e-10, so the states agree far below the 1e-8 bound.
TOL_E2E = 1e-8
# Adjoint dot test: the sweep runs in f32 with lambda-solves at rtol
# 1e-6, and the central difference uses h = 1e-3 (truncation ~h^2).
TOL_DOT = 1e-2
# Four cards against one, both f64 with Newton tolerance 1e-10.
TOL_FOUR = 1e-6


def log(msg):
    print(msg, flush=True)


def parse_smi(line: str) -> tuple[str, str]:
    """(name, power limit) from one line of ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line {line!r}")
    return name.strip(), limit.strip()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def last_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def phase_device(n_cards: int = 1):
    bench.require_gpu()
    if len(jax.devices()) < n_cards:
        raise SystemExit(f"{n_cards} GPUs needed, JAX sees "
                         f"{len(jax.devices())}")
    d = jax.devices()[0]
    log(f"# jax {jax.__version__}  device_kind {d.device_kind}  "
        f"count {len(jax.devices())}")
    name, limit = parse_smi(nvidia_smi())
    log(f"{name}, {limit}")
    prec = jax.config.jax_default_matmul_precision
    log(f"# jax_default_matmul_precision {prec}")
    if prec != "highest":
        raise RuntimeError(f"matmul precision {prec!r}: float32 "
                           "contractions would run in TF32")


def gpu_test_files(root=ROOT) -> list[str]:
    """Test files that hold tests marked ``gpu``."""
    tests = os.path.join(root, "tests")
    return sorted(os.path.join(tests, f) for f in os.listdir(tests)
                  if f.startswith("test_") and f.endswith(".py")
                  and "mark.gpu" in open(os.path.join(tests, f)).read())


def phase_gpu_tests():
    """The suite's ``gpu``-marked tests, in this process (it already
    holds the card), through pytest."""
    import pytest

    class Outcomes:
        def __init__(self):
            self.n = {"passed": 0, "skipped": 0, "failed": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] += 1

    files = gpu_test_files()
    seen = Outcomes()
    env = dict(os.environ)
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          *files], plugins=[seen])
    finally:  # conftest defaults JAX_PLATFORMS for the CPU suite
        os.environ.clear()
        os.environ.update(env)
    log(f"# gpu-marked tests in {len(files)} file(s): {seen.n}, "
        f"pytest exit {rc}")
    if rc != 0 or seen.n["passed"] == 0 or seen.n["skipped"]:
        raise RuntimeError(f"gpu-marked tests did not all pass: {seen.n}")


def phase_flagship(shape=bench.FLAGSHIP):
    rec, ctx = bench.run_product(*shape)
    log(f"# flagship {rec['cells']} cells: compile "
        f"{rec['compile_seconds']:.2f} s (persistent cache hits "
        f"{rec['compile_cache_hits']}), run {rec['run_seconds']:.4f} s, "
        f"ministeps {rec['ministeps']}, newtons "
        f"{rec['newton_iterations']}, linear iterations "
        f"{rec['linear_iterations']}")
    log(f"# flagship memory {json.dumps(rec['memory'])}")
    log(f"# flagship f64 final step: max|r| "
        f"{rec['f64_max_abs_residual']:.6e}  CNV {rec['f64_CNV']:.6e}  "
        f"MB {rec['f64_MB']:.6e}")
    bench.check_f64_acceptance(rec)
    return rec


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _check(name, err, tol):
    log(f"# reference {name}: {err:.3e} (limit {tol:g})")
    if not err <= tol:
        raise RuntimeError(f"reference {name}: {err:.3e} > {tol:g}")


def phase_operators(shape):
    """First-Newton residual and Jacobian of the flagship deployment at
    ``shape``, stencil engine against the generic engine, on the card."""
    from jutul.jl_tpu.models.setup import merge_state
    from jutul.jl_tpu.ops.blockell import BlockELL
    from jutul.jl_tpu.ops.stencil_wells import BorderedStencilModel

    t0 = time.perf_counter()
    model, comp, state0, params, forces = bench.build(*shape)
    log(f"# reference operators at {shape} "
        f"({int(np.prod(shape))} cells), host setup "
        f"{time.perf_counter() - t0:.1f} s")
    eng = BorderedStencilModel(comp)
    dt = 0.25 * 6 * 3600.0  # the flagship's first ministep
    with bench.x64(True):
        full = merge_state({k: jnp.asarray(v) for k, v in state0.items()},
                           {k: jnp.asarray(v) for k, v in params.items()})

        @jax.jit
        def stencil_side(full):
            r, B, _ = eng.assemble(full, full, dt, forces)
            return r, B

        @jax.jit
        def generic_side(full):
            fe = comp.evaluate_secondaries(full)
            r = comp.residual(fe, fe, dt, forces)
            return r, comp.jacobian_blocks(fe, fe, dt, forces)

        r_s, B = stencil_side(full)
        r_g, blocks = generic_side(full)
        J = BlockELL(comp.ell, blocks)
        x = jnp.asarray(np.random.default_rng(1).standard_normal(
            (comp.n_cells, comp.ndof)))
        # matrices go in as arguments, never as constants of the program
        matvec = jax.jit(lambda M, v: M.matvec(v))
        y_g = matvec(J, x)
        y_s = matvec(B, x)
        B32 = jax.tree_util.tree_map(lambda v: v.astype(jnp.float32)
                                     if v.dtype == jnp.float64 else v, B)
        y_32 = matvec(B32, x.astype(jnp.float32))
    _check("f64 residual, stencil vs generic", _rel(r_s, r_g), TOL_F64)
    _check("f64 Jacobian action, stencil vs generic", _rel(y_s, y_g),
           TOL_F64)
    _check("f32 stencil matvec vs f64 generic", _rel(y_32, y_g),
           TOL_MATVEC_F32)


def phase_end_to_end(shape=(32, 32, 8), n_step=3):
    """The small deployment on the card (stencil engine) and on the host
    CPU (generic engine), both f64, same fixed ministep sequence."""
    from jutul.jl_tpu import GenericKrylov, Simulator, report_stats
    from jutul.jl_tpu.linsolve.precond import ILU0Preconditioner
    from jutul.jl_tpu.ops.stencil import GMG, StencilCPR, StencilKrylovSolver

    model, comp, state0, params, forces = bench.build(*shape)
    dts = [3600.0] * n_step
    tols = {"mass_conservation/CNV": 1e-10, "mass_conservation/MB": 1e-10}

    def run(use_stencil, solver):
        t0 = time.perf_counter()
        sim = Simulator(model, state0=state0, parameters=params,
                        use_stencil=use_stencil)
        res = sim.simulate(dts, forces=forces, linear_solver=solver,
                           tolerances=tols, max_nonlinear_iterations=30,
                           info_level=-1)
        stats = report_stats(res.reports)
        if not all(r["success"] for r in res.reports) \
                or int(stats["ministeps"]) != n_step:
            raise RuntimeError(
                f"end-to-end run (stencil={use_stencil}) did not take the "
                f"fixed {n_step} ministeps: {stats}")
        return res.states[-1], stats, time.perf_counter() - t0

    with bench.x64(True):
        card, st_c, t_c = run(True, StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=GMG(n_smooth=2,
                                              n_coarse_sweeps=12,
                                              min_cells=64)),
            rtol=1e-10, max_iterations=300))
        with jax.default_device(jax.devices("cpu")[0]):
            host, st_h, t_h = run(False, GenericKrylov(
                "bicgstab", preconditioner=ILU0Preconditioner(),
                rtol=1e-10, max_iterations=1000))
    log(f"# end to end at {shape}: card {t_c:.1f} s ({st_c['newtons']} "
        f"newtons), host CPU {t_h:.1f} s ({st_h['newtons']} newtons)")
    _check("end-to-end pressure (relative)",
           _rel(card["Pressure"], host["Pressure"]), TOL_E2E)
    _check("end-to-end saturations (absolute)",
           float(np.abs(np.asarray(card["Saturations"])
                        - np.asarray(host["Saturations"])).max()), TOL_E2E)


def phase_adjoint(shape=bench.FLAGSHIP, dot_shape=(32, 32, 8)):
    rec = bench.run_adjoint(*shape)
    log(f"# adjoint {rec['cells']} cells: forward {rec['forward_seconds']:.4f}"
        f" s ({rec['newton_iterations']} newtons), sweep "
        f"{rec['adjoint_seconds']:.4f} s (first sweep "
        f"{rec['adjoint_first_sweep_seconds']:.2f} s), ratio "
        f"{rec['adjoint_over_forward']:.3f}")
    small = bench.run_adjoint(*dot_shape, dot_test=True)
    _check(f"adjoint dot test at {dot_shape}",
           small["grad_dot_test_rel_err"], TOL_DOT)
    return rec


def phase_four_cards(shape=(64, 64, 16), n_dev=4):
    """GeneralDistributedSimulator over a 1-D mesh of ``n_dev`` devices
    against the single-device Simulator on the same case, forward states
    and adjoint gradient, in f64."""
    from jax.sharding import Mesh

    from jutul.jl_tpu import (
        CartesianMesh,
        GenericKrylov,
        Simulator,
        si_unit,
        solve_adjoint_sensitivities,
    )
    from jutul.jl_tpu.linsolve.cpr import CPRPreconditioner
    from jutul.jl_tpu.meshes.unstructured import UnstructuredMesh
    from jutul.jl_tpu.models.darcy import (
        ImmiscibleFluid,
        PhaseSourceTerm,
        PressureBoundaryCondition,
    )
    from jutul.jl_tpu.models.wells import WellSpec, setup_well_graph_model
    from jutul.jl_tpu.parallel.general import GeneralDistributedSimulator
    from jutul.jl_tpu.parallel.general_adjoint import (
        solve_adjoint_sensitivities_general,
    )
    from jutul.jl_tpu.parallel.partition import GreedyGraphPartitioner

    BAR, DARCY, DAY = si_unit("bar"), si_unit("darcy"), si_unit("day")
    nx, ny, nz = shape
    t0 = time.perf_counter()
    base = UnstructuredMesh.from_cartesian(CartesianMesh(
        (nx, ny, nz), (10.0 * nx, 10.0 * ny, 5.0 * nz)))
    nc = base.number_of_cells()
    rng = np.random.default_rng(0)
    perm = rng.lognormal(0.0, 1.0, nc) * 0.2 * DARCY
    poro = np.full(nc, 0.25)
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))

    def cell(ix, iy, iz):
        return (iz * ny + iy) * nx + ix

    wells = [WellSpec("inj", [cell(0, 0, 0), cell(0, 0, 1)],
                      WI=[2e-12, 3e-12], volume=0.5),
             WellSpec("prod", [cell(nx - 1, ny - 1, nz - 1)], WI=4e-12,
                      volume=0.5)]
    with bench.x64(True):
        model, wmesh, params = setup_well_graph_model(
            base, fluid, wells, permeability=perm, porosity=poro,
            gravity=True)
        forces = {
            "rate": PhaseSourceTerm([wmesh.well_cells["inj"]],
                                    np.array([[0.05, 0.0]])),
            "bhp": PressureBoundaryCondition([wmesh.well_cells["prod"]],
                                             120.0 * BAR, 1e-11,
                                             saturations=[0.5, 0.5]),
        }
        groups = wmesh.partition_groups()
        part = GreedyGraphPartitioner().partition(
            wmesh.neighborship(), wmesh.number_of_cells(), n_dev,
            groups=groups)
        dmesh = Mesh(np.array(jax.devices()[:n_dev]), ("d",))
        perm_aug = np.concatenate([perm, np.full(len(wells), perm.mean())])
        poro_aug = np.concatenate([poro, np.ones(len(wells))])
        dsim = GeneralDistributedSimulator(
            wmesh, model.system, dmesh, partition=part, parameters=params,
            data_fields={"permeability": perm_aug, "porosity": poro_aug},
            halo_mode="ppermute")
        state0 = dsim.initial_state(Pressure=150.0 * BAR,
                                    Saturations=[0.3, 0.7])
        log(f"# four cards: {shape} lattice ({nc} cells + {len(wells)} "
            f"wells) on {n_dev} devices, host setup "
            f"{time.perf_counter() - t0:.1f} s")
        dts = [0.1 * DAY, 0.2 * DAY]
        tols = {"default": 1e-10}
        t0 = time.perf_counter()
        sd, _ = dsim.simulate(state0, dts, forces=forces, tolerances=tols,
                              max_newton=40, preconditioner="cpr",
                              cpr_smoother="chebyshev", info_level=-1)
        t_dist = time.perf_counter() - t0
        holders = sorted({str(shard.device)
                          for arr in dsim.shard_state(state0).values()
                          for shard in arr.addressable_shards})
        log(f"# four cards: distributed run {t_dist:.2f} s; state shards "
            f"on {holders}")
        if len(holders) != n_dev:
            raise RuntimeError(f"state sharded over {holders}, not "
                               f"{n_dev} distinct devices")
        t0 = time.perf_counter()
        solver = GenericKrylov("bicgstab",
                               preconditioner=CPRPreconditioner(),
                               rtol=1e-12, max_iterations=1000)
        sim = Simulator(model, state0=state0, parameters=params)
        sr, _ = sim.simulate(dts, forces=forces, info_level=-1,
                             tolerances=tols, linear_solver=solver,
                             max_nonlinear_iterations=40)
        log(f"# four cards: single-device run "
            f"{time.perf_counter() - t0:.2f} s")
        _check("four cards vs one, pressure (relative)",
               _rel(sd[-1]["Pressure"], sr[-1]["Pressure"]), TOL_FOUR)
        _check("four cards vs one, saturations (absolute)",
               float(np.abs(np.asarray(sd[-1]["Saturations"])
                            - np.asarray(sr[-1]["Saturations"])).max()),
               TOL_FOUR)

        def G(model_, state, dt_, n_, forces_):
            return dt_ * jnp.sum((state["Pressure"] / (150.0 * BAR)) ** 2)

        t0 = time.perf_counter()
        g_ref = solve_adjoint_sensitivities(
            model, [dict(s) for s in sr], dts, G, parameters=params,
            state0=state0, forces=forces, linear_solver=solver)
        g_dist = solve_adjoint_sensitivities_general(
            dsim, [dict(s) for s in sr], dts, G, state0, forces=forces,
            parameters=params, rtol=1e-13, max_lin_it=2000)
        err = max(_rel(np.asarray(g_dist[k]).reshape(
            np.shape(g_ref[k])), g_ref[k]) for k in g_ref)
        log(f"# four cards: adjoint gradients {time.perf_counter() - t0:.2f}"
            f" s")
        _check("four cards vs one, adjoint gradient (relative)", err,
               TOL_FOUR)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    from jutul.jl_tpu.utils.compile_cache import enable_compile_cache

    phase_device(4 if args.four_cards else 1)
    log(f"# compile cache {enable_compile_cache()}")
    if args.four_cards:
        phase_four_cards()
        device = dict(bench.device_record(), count=4)
    else:
        phase_gpu_tests()
        phase_flagship()
        phase_operators(bench.FLAGSHIP)
        phase_end_to_end()
        phase_adjoint()
        device = bench.device_record()
    log(last_line(device))


if __name__ == "__main__":
    main()
