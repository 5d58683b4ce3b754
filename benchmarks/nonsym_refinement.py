"""Double-word refinement of a nonsymmetric system, with x64 off and on.

Runs ``bicgstab_ir_df64`` (f32 BiCGStab corrections, inner SGS(4) on the
DIA factors, double-word true residual) on upwind convection-diffusion,
the system of ``bench.py``'s nonsymmetric cell, for two right-hand
sides: ``b = A·1`` (the bench cell's, non-zero only next to the
boundary) and a seeded random unit vector.  Each case runs twice, with
``jax_enable_x64`` off (pure-f32 error-free transforms) and on (the
transforms go through native float64), and prints one JSON line with
the status, iteration counts and the host float64 relative residual.
It tells a fault of the refinement's arithmetic, which would differ
between the two x64 settings, from a breakdown of the f32 inner solve
on the right-hand side, which would not.

    python benchmarks/nonsym_refinement.py [--nx 1414] [--epsilon 1e-8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run(nx: int, epsilon: float, max_iterations: int, seed: int = 0):
    import jax
    import scipy.sparse as sp

    from sparse_matrix_math_tpu import SGSPreconditioner, dia_from_csr
    from sparse_matrix_math_tpu.ops.df32 import df_operator_from_host_csr
    from sparse_matrix_math_tpu.solvers.ir_df64 import bicgstab_ir_df64
    from sparse_matrix_math_tpu.solvers.types import SolverStatus
    from sparse_matrix_math_tpu.utils.generate import convection_diffusion_2d

    a64 = convection_diffusion_2d(nx, dtype=np.float64)
    data = np.asarray(a64.data, np.float64)
    indices = np.asarray(a64.indices, np.int64)
    indptr = np.asarray(a64.indptr, np.int64)
    a_ref = sp.csr_matrix((data, indices, indptr), shape=a64.shape)
    dfa = df_operator_from_host_csr(data, indices, indptr, a64.shape)
    pre = SGSPreconditioner.from_dia(
        dia_from_csr(convection_diffusion_2d(nx, dtype=np.float32)), sweeps=4
    )
    rand = np.random.default_rng(seed).standard_normal(a64.shape[0])
    rhs = {"A@ones": a_ref @ np.ones(a64.shape[0]),
           "random_unit": rand / np.linalg.norm(rand)}
    out = []
    for name, b in rhs.items():
        for x64 in (False, True):
            with jax.enable_x64(x64):
                t0 = time.perf_counter()
                res = bicgstab_ir_df64(
                    dfa, b, max_iterations=max_iterations, epsilon=epsilon,
                    preconditioner=pre,
                )
                float(res.residual_norm2)
                wall = time.perf_counter() - t0
            r = b - a_ref @ res.x_f64()
            rec = {
                "system": f"convection_diffusion_2d {nx}^2",
                "rhs": name, "jax_enable_x64": x64, "epsilon": epsilon,
                "status": SolverStatus(int(res.status)).name,
                "inner_iterations": int(res.iterations),
                "outer_rounds": int(res.outer_rounds),
                "residual_abs": float(np.linalg.norm(r)),
                "residual_rel": float(np.linalg.norm(r) / np.linalg.norm(b)),
                "wall_s_with_compile": wall,
                "device": jax.devices()[0].device_kind,
            }
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=1414)
    ap.add_argument("--epsilon", type=float, default=1e-8)
    ap.add_argument("--max-iterations", type=int, default=30000)
    args = ap.parse_args(argv)
    run(args.nx, args.epsilon, args.max_iterations)


if __name__ == "__main__":
    main()
