"""Example: precision floors and automatic accuracy escalation.

A single-precision Krylov solve cannot push its TRUE residual below
~u_f32 * ||A|| * ||x|| no matter how many iterations it runs.  The
library makes that limit a first-class part of the API:

* every verified-convergence solver reports ``floor_hit`` on its
  SolveResult — a MAX_ITERATIONS_REACHED exit that was actually a
  measured precision floor (a restart failed to shrink the true
  residual), so raising ``max_iterations`` cannot help;
* the :func:`~sparse_matrix_math_tpu.solve` front door reads it (plus a
  cheap epsilon-vs-f32-representability pre-check) and re-routes the
  request through the double-word refinement
  (``cg_ir_df64`` / ``bicgstab_ir_df64``), delivering the reference's
  f64-default accuracy contract (test/include/test_common.h:30-38) with
  f32 storage.  Opt out with
  ``auto_escalate=False``.

    python examples/accuracy_autopilot.py [nx]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.utils.generate import poisson_2d


def main(nx: int = 64) -> None:
    a64 = poisson_2d(nx, dtype=np.float64)
    data = np.asarray(a64.data, np.float64)
    indptr = np.asarray(a64.indptr, np.int64)
    indices = np.asarray(a64.indices, np.int64)
    b64 = np.add.reduceat(data, indptr[:-1])  # row sums -> x = ones

    a32 = poisson_2d(nx, dtype=np.float32)
    b32 = np.asarray(b64, np.float32)

    # 1. an f32 solve asked for more than f32 can deliver, escalation off:
    #    it stops honestly at its floor and SAYS it was a floor
    res = smm.solve(a32, b32, method="cg", epsilon=1e-8,
                    auto_escalate=False)
    print(f"f32 pass: {res.status_enum().name}, "
          f"||b-Ax|| = {float(res.residual_norm):.2e}, "
          f"floor_hit = {res.hit_precision_floor}")

    # 2. the same request through the front door: routed to the
    #    double-word refinement, genuine 1e-8 true residual
    res = smm.solve(a32, b32, method="cg", epsilon=1e-8)
    x = res.x_f64()
    data32 = np.asarray(a32.data, np.float64)  # the operator as handed in
    ax = np.add.reduceat(data32 * x[indices], indptr[:-1])
    true = float(np.linalg.norm(np.asarray(b32, np.float64) - ax))
    print(f"escalated: {type(res).__name__} {res.status_enum().name}, "
          f"true ||b-Ax|| = {true:.2e}, "
          f"max|x-1| = {float(np.abs(x - 1).max()):.2e}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
