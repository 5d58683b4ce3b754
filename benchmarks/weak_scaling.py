"""Weak-scaling benchmark (BASELINE.json config 5).

Row-partitioned CG on a 3-D Poisson system whose size grows with the
device count (fixed rows per device), reporting per-step time and
scaling efficiency.  On a single-device environment this runs the
simulated-mesh validation path (CPU virtual devices) to verify the
distributed program compiles and converges at every width; on a host
with several GPUs the same script measures real scaling.

    python benchmarks/weak_scaling.py --rows-per-device 250000 \
        --devices 1 2 4 8 [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run(rows_per_device: int, widths, platform):
    import os

    if platform == "cpu":
        os.environ.setdefault(
            "XLA_FLAGS",
            f"--xla_force_host_platform_device_count={max(widths)}",
        )
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from sparse_matrix_math_tpu.formats.dia import try_dia_from_csr
    from sparse_matrix_math_tpu.parallel import (
        collect,
        dist_dia_solve,
        dist_solve,
        distribute_csr,
        distribute_dia,
        make_mesh,
    )
    from sparse_matrix_math_tpu.utils.generate import poisson_3d

    results = []
    for p in widths:
        n_target = rows_per_device * p
        nx = max(round(n_target ** (1 / 3)), 4)
        a = poisson_3d(nx, dtype=np.float32)
        mesh = make_mesh(p)
        da = distribute_csr(a, mesh)
        b = np.asarray(a.rmult(__import__("jax.numpy", fromlist=["ones"]).ones(
            a.shape[0], dtype=np.float32)))

        # fixed iteration count isolates per-iteration cost from
        # convergence-rate effects (weak scaling measures throughput)
        iters = 50
        r = dist_solve(da, b, solver="cg", max_iterations=iters,
                       epsilon=1e-30, mesh=mesh)
        jax.block_until_ready(r.x)
        t0 = time.perf_counter()
        r = dist_solve(da, b, solver="cg", max_iterations=iters,
                       epsilon=1e-30, mesh=mesh)
        jax.block_until_ready(r.x)
        dt = (time.perf_counter() - t0) / iters
        assert np.isfinite(collect(r.x, da)).all()
        B = da.block_rows
        # analytic collective volume per device per CG iteration:
        # halo exchange bytes for the SpMV + 2 psum latencies for dots
        halo_bytes = (
            4 * B * (p - 1) if da.mode == "allgather" else 2 * 4 * B
        )
        row = {
            "devices": p,
            "n": a.shape[0],
            "nnz": a.nnz,
            "mode": da.mode,
            "s_per_iteration": round(dt, 6),
            "gnnz_per_s": round(a.nnz / dt / 1e9, 3),
            "halo_bytes_per_device_per_spmv": halo_bytes,
            "psums_per_iteration": 2,
        }
        # DIA fast path (overlapped neighbor halo) on the same system
        dia = try_dia_from_csr(a)
        if dia is not None:
            dd = distribute_dia(dia, mesh)
            rd = dist_dia_solve(dd, b, solver="cg", max_iterations=iters,
                                epsilon=1e-30, mesh=mesh)
            jax.block_until_ready(rd.x)
            t0 = time.perf_counter()
            rd = dist_dia_solve(dd, b, solver="cg", max_iterations=iters,
                                epsilon=1e-30, mesh=mesh)
            jax.block_until_ready(rd.x)
            dtd = (time.perf_counter() - t0) / iters
            assert np.isfinite(collect(rd.x, dd)).all()
            row["dia_s_per_iteration"] = round(dtd, 6)
            row["dia_gnnz_per_s"] = round(a.nnz / dtd / 1e9, 3)
            row["dia_halo_bytes_per_device_per_spmv"] = 2 * 4 * dd.block_rows
        results.append(row)

    base = results[0]["s_per_iteration"]
    for r in results:
        # weak scaling: perfect efficiency keeps s/iter flat as devices
        # and problem size grow together
        r["efficiency"] = round(base / r["s_per_iteration"], 3)
    print(json.dumps({"rows_per_device": rows_per_device,
                      "results": results}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-device", type=int, default=32768)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--platform", default=None,
                    help="'cpu' forces the simulated virtual-device mesh")
    args = ap.parse_args()
    run(args.rows_per_device, args.devices, args.platform)
