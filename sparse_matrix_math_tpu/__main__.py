"""Command-line interface.

The reference is a header-only library with no CLI; a production solver
framework deserves one.  Examples:

    python -m sparse_matrix_math_tpu solve matrix.mtx --method cg --tol 1e-8
    python -m sparse_matrix_math_tpu solve matrix.mtx --method bicgstab \\
        --preconditioner sgs --rhs ones --output x.npy
    python -m sparse_matrix_math_tpu info matrix.mtx
    python -m sparse_matrix_math_tpu bench-spmv matrix.mtx
"""

from __future__ import annotations

import argparse
import json
import sys


def _load(path, dtype_name):
    import numpy as np

    if dtype_name == "f64":
        # without x64, JAX silently downcasts device arrays to f32
        import jax

        jax.config.update("jax_enable_x64", True)

    from .io.dispatch import load_matrix_csr

    dtype = {"f32": np.float32, "f64": np.float64}[dtype_name]
    return load_matrix_csr(path, dtype=dtype)


def cmd_info(args) -> int:
    import numpy as np

    a = _load(args.matrix, args.dtype)
    row_nnz = np.diff(np.asarray(a.indptr))
    offs = np.asarray(a.indices, np.int64) - np.asarray(a.row_ids, np.int64)
    print(json.dumps({
        "shape": list(a.shape),
        "nnz": a.nnz,
        "dtype": str(a.dtype),
        "row_nnz": {"min": int(row_nnz.min()), "max": int(row_nnz.max()),
                    "mean": float(row_nnz.mean())},
        "distinct_diagonals": int(np.unique(offs).size),
        "bandwidth": int(np.abs(offs).max()) if offs.size else 0,
        "symmetric_pattern": bool(_pattern_symmetric(a)),
    }))
    return 0


def _pattern_symmetric(a) -> bool:
    import numpy as np

    r = np.asarray(a.row_ids, np.int64)
    c = np.asarray(a.indices, np.int64)
    fwd = set(zip(r.tolist(), c.tolist()))
    return all((cc, rr) in fwd for rr, cc in fwd)


def cmd_solve(args) -> int:
    import numpy as np

    from . import solve
    from .solvers.types import SolverStatus
    from .utils.profiling import solve_with_stats

    a = _load(args.matrix, args.dtype)
    if args.rhs == "ones":
        import jax.numpy as jnp

        b = a @ jnp.ones(a.shape[0], dtype=a.dtype)
    else:
        b = np.load(args.rhs)

    import jax.numpy as jnp

    res = solve(
        a, jnp.asarray(b),
        method=args.method,
        epsilon=args.tol,
        max_iterations=args.max_iterations,
        preconditioner=args.preconditioner,
    )
    out = {
        "status": SolverStatus(int(res.status)).name,
        "iterations": int(res.iterations),
        "residual_norm": float(res.residual_norm),
    }
    if args.output:
        np.save(args.output, np.asarray(res.x))
        out["output"] = args.output
    print(json.dumps(out))
    return 0 if int(res.status) == SolverStatus.SUCCESS else 1


def cmd_bench_spmv(args) -> int:
    from .formats.dia import try_dia_from_csr
    from .formats.ell import ell_from_csr
    from .utils.profiling import spmv_throughput

    a = _load(args.matrix, args.dtype)
    report = {"csr": spmv_throughput(a, iters=args.iters)}
    dia = try_dia_from_csr(a)
    if dia is not None:
        report["dia"] = spmv_throughput(dia, iters=args.iters)
    report["ell"] = spmv_throughput(ell_from_csr(a), iters=args.iters)
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sparse_matrix_math_tpu")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("info", help="matrix statistics")
    pi.add_argument("matrix")
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser("solve", help="solve A x = b")
    ps.add_argument("matrix")
    ps.add_argument("--method", default="cg",
                    choices=["cg", "bicg_symmetric", "cgs", "bicgstab",
                             "gmres"])
    ps.add_argument("--preconditioner", default="none",
                    choices=["none", "jacobi", "sgs", "ilu0", "ic0",
                             "chebyshev", "multigrid"])
    ps.add_argument("--tol", type=float, default=1e-8)
    ps.add_argument("--max-iterations", type=int, default=-1)
    ps.add_argument("--rhs", default="ones",
                    help="'ones' (row-sum oracle) or a .npy path")
    ps.add_argument("--output", default=None, help=".npy path for x")
    ps.set_defaults(fn=cmd_solve)

    pb = sub.add_parser("bench-spmv", help="SpMV throughput per format")
    pb.add_argument("matrix")
    pb.add_argument("--iters", type=int, default=20)
    pb.set_defaults(fn=cmd_bench_spmv)

    args = p.parse_args(argv)
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
