"""Geometric-multigrid-preconditioned CG — the fastest way to solve the
Poisson-class benchmark systems (solvers/multigrid.py).

    python examples/multigrid_solve.py [nx]

It converges in O(10) iterations at any grid size, where plain CG needs
O(nx) (~2000 at nx = 1414).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.solvers.multigrid import PoissonMultigrid
from sparse_matrix_math_tpu.utils.generate import poisson_2d


def main():
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    a = poisson_2d(nx, dtype=np.float32)
    b = a @ jnp.ones(a.shape[0], jnp.float32)  # all-ones oracle

    mg = PoissonMultigrid.for_grid(nx)
    res = smm.cg(a, b, epsilon=1e-4, preconditioner=mg)
    print(
        f"n={a.shape[0]}: PCG+V-cycle {int(res.iterations)} iterations, "
        f"status={int(res.status)}, max|x-1|={float(jnp.abs(res.x - 1).max()):.2e}"
    )

    plain = smm.cg(a, b, epsilon=1e-4)
    print(f"plain CG for comparison: {int(plain.iterations)} iterations")


if __name__ == "__main__":
    main()
