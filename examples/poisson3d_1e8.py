"""Example: the reference's f64/1e-8 contract at scale, in one call.

The headline composition: a matrix-free 3-D Poisson stencil
(zero matrix traffic), the geometric multigrid V-cycle, and the
double-word refinement — all wired through the ``solve()`` front door:

    solve(stencil, b, method="cg", epsilon=1e-8,
          preconditioner="multigrid")

On f32 data the 1e-8 request sits below f32's precision floor, so the
front door pre-routes to ``cg_ir_df64`` (f32 inner solves, MG
preconditioned, double-word true residuals) and returns a
``DfSolveResult`` whose ``x_f64()`` genuinely satisfies
``||b - A x|| <= 1e-8`` in float64.

    python examples/poisson3d_1e8.py [m]    # grid side, default 31
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.utils.generate import poisson_3d


def main(m: int = 31) -> None:
    # host f64 oracle (for the independent residual check + exact b)
    a64 = poisson_3d(m, dtype=np.float64)
    data = np.asarray(a64.data, np.float64)
    indptr = np.asarray(a64.indptr, np.int64)
    indices = np.asarray(a64.indices, np.int64)
    b64 = np.add.reduceat(data, indptr[:-1])  # row sums -> x_true = ones

    # the matrix-free operator: 7 coefficients + the grid shape
    st = smm.GridStencilMatrix(
        coeffs=jnp.asarray([6.0, -1, -1, -1, -1, -1, -1], jnp.float32),
        doffs=((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0),
               (0, 1, 0), (0, 0, -1), (0, 0, 1)),
        dims=(m, m, m), shape=a64.shape, nnz=int(a64.nnz),
    )

    res = smm.solve(
        st, b64, method="cg", epsilon=1e-8, preconditioner="multigrid",
    )
    # On an f64-less accelerator the front door escalates and returns a
    # DfSolveResult; on an x64-enabled CPU backend the plain f64 solve
    # already meets the bar and returns a SolveResult.  Both satisfy
    # the same contract.
    escalated = hasattr(res, "x_f64")
    x64 = res.x_f64() if escalated else np.asarray(res.x, np.float64)
    true = float(np.linalg.norm(
        b64 - np.add.reduceat(data * x64[indices], indptr[:-1])
    ))
    rounds = (
        f", refinement rounds {int(res.outer_rounds)}" if escalated else ""
    )
    print(
        f"{m}^3 Poisson ({a64.nnz} nnz): {res.status_enum().name}, "
        f"iterations {int(res.iterations)}{rounds}, "
        f"f64 true residual {true:.2e} (target 1e-8), "
        f"max|x - 1| = {np.abs(x64 - 1.0).max():.2e}"
    )


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 31)
