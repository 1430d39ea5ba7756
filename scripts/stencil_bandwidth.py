"""Stencil matvec and Jacobi sweep against a plain copy of the same bytes.

Times, at the flagship lattice (256x64x64, C = K = 2, f32) and at the
sizes of the first two GMG levels:

- the block stencil matvec (``StencilMatrix.matvec``: coefficient
  layout plus apply) and the per-Krylov-iteration apply alone
  (``apply_lattice`` on coefficients laid out once per solve),
- the scalar stencil matvec (``ScalarStencil.matvec``),
- one weighted-Jacobi sweep ``u + omega * dinv * (b - A u)``,
- a device-to-device copy of as many bytes as the operation must move.

Each time is the mean over a burst of back-to-back calls ended by
``block_until_ready``; a profiler trace of a few calls gives the number
of device kernels per call and their summed device time. The rate of an
operation is the bytes it must move (coefficients and vectors read once,
result written once) over its time; the copy's rate counts its read and
its write. Run on a GPU:

    python scripts/stencil_bandwidth.py [--out chiprun_out/stencil_bandwidth.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

F32 = 4


def _block_matrix(L, C, K, rng):
    from jutul.jl_tpu.ops.stencil import StencilMatrix

    nz, ny, nx = L
    n = nz * ny * nx
    fl = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    mk = lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32)  # noqa
    return StencilMatrix(L, mk((C, K, n)),
                         {a: mk((C, K) + s) for a, s in fl.items()},
                         {a: mk((C, K) + s) for a, s in fl.items()})


def _scalar_matrix(L, rng):
    from jutul.jl_tpu.ops.stencil import ScalarStencil

    nz, ny, nx = L
    n = nz * ny * nx
    fl = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    mk = lambda s: jnp.asarray(-rng.uniform(0.1, 1.0, s), jnp.float32)  # noqa
    return ScalarStencil(L, jnp.full((n,), 8.0, jnp.float32),
                         {a: mk(s) for a, s in fl.items()},
                         {a: mk(s) for a, s in fl.items()})


def _time(fn, args, reps):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _trace_kernels(fn, args, calls):
    """(kernels per call, device seconds per call) from a profiler trace."""
    d = tempfile.mkdtemp(prefix="stencil_trace_", dir=os.environ.get("TMPDIR"))
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(d):
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    n_ev, dur_ns, lines = 0, 0.0, {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            # kernel executions live on the stream lines; "XLA Ops" and
            # "XLA Modules" lines repeat the same work at other levels
            if not line.name.startswith("Stream"):
                continue
            n_ev += len(evs)
            dur_ns += sum(e.duration_ns for e in evs)
    return n_ev / calls, dur_ns * 1e-9 / calls, lines


def measure(label, fn, args, nbytes, reps):
    t = _time(fn, args, reps)
    k, t_dev, lines = _trace_kernels(fn, args, 10)
    r = {"op": label, "seconds": t, "bytes": nbytes,
         "GB_per_s": nbytes / t / 1e9, "kernels_per_call": k,
         "device_seconds_from_trace": t_dev, "trace_lines": lines}
    print(f"{label:40s} {t * 1e6:10.2f} us {r['GB_per_s']:9.1f} GB/s  "
          f"kernels/call {k:.1f}  device {t_dev * 1e6:.2f} us", flush=True)
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/stencil_bandwidth.json")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"no GPU: JAX reports {d.platform}")
    jax.config.update("jax_enable_x64", False)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"# {smi}")
    rng = np.random.default_rng(0)
    copy = jax.jit(lambda v: v + 1.0)
    omega = 0.8
    rows = []
    for L, label in (((64, 64, 256), "L0"), ((32, 32, 128), "L1"),
                     ((16, 16, 64), "L2")):
        n = int(np.prod(L))
        if label == "L0":
            A = _block_matrix(L, 2, 2, rng)
            x = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
            mv = jax.jit(lambda A_, x_: A_.matvec(x_))
            nb = (2 * 2 * n + 6 * 2 * 2 * n + 2 * n + 2 * n) * F32
            rows.append(measure(f"{label} block matvec C=K=2", mv, (A, x),
                                nb, args.reps))
            from jutul.jl_tpu.ops.stencil import (
                apply_lattice,
                lattice_coefficients,
            )

            ap = jax.jit(lambda c_, x_: apply_lattice(c_, x_, L))
            rows.append(measure(f"{label} block apply C=K=2", ap,
                                (lattice_coefficients(A), x), nb,
                                args.reps))
            buf = jnp.zeros(nb // F32, jnp.float32)
            rows.append(measure(f"{label} copy of block-matvec bytes", copy,
                                (buf,), 2 * nb, args.reps))
        S = _scalar_matrix(L, rng)
        u = jnp.asarray(rng.standard_normal(n), jnp.float32)
        b = jnp.asarray(rng.standard_normal(n), jnp.float32)
        smv = jax.jit(lambda S_, u_: S_.matvec(u_))
        nb = (7 * n + n + n) * F32
        rows.append(measure(f"{label} scalar matvec", smv, (S, u), nb,
                            args.reps))
        jac = jax.jit(lambda S_, u_, b_: u_ + omega / S_.diag
                      * (b_ - S_.matvec(u_)))
        nbj = (7 * n + 3 * n) * F32
        rows.append(measure(f"{label} Jacobi sweep", jac, (S, u, b), nbj,
                            args.reps))
        buf = jnp.zeros(nb // F32, jnp.float32)
        rows.append(measure(f"{label} copy of scalar-matvec bytes", copy,
                            (buf,), 2 * nb, args.reps))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": d.device_kind, "nvidia_smi": smi, "rows": rows},
                  f, indent=1)


if __name__ == "__main__":
    main()
