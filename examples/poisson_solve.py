"""Example: solve a 2-D Poisson system end-to-end on one device.

    python examples/poisson_solve.py [nx]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.dia import dia_from_csr
from sparse_matrix_math_tpu.utils.generate import poisson_2d
from sparse_matrix_math_tpu.utils.profiling import solve_with_stats


def main(nx: int = 256) -> None:
    a_csr = poisson_2d(nx, dtype=np.float32)
    a = dia_from_csr(a_csr)  # stencil layout: gather-free shifted slices
    x_true = jnp.ones(a.shape[0], jnp.float32)
    b = a @ x_true

    stats = solve_with_stats(
        smm.cg, a, b, solver_name="cg", epsilon=1e-5, record_residuals=True
    )
    print(stats)
    print("max |x - 1| =", float(jnp.abs(
        smm.cg(a, b, epsilon=1e-5).x - 1.0).max()))

    # preconditioned variant through the unified front-end (CSR input)
    res = smm.solve(a_csr, b, method="cg", preconditioner="ic0", epsilon=1e-5)
    print("PCG+IC0:", res)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
