"""Example: unstructured and multi-RHS solves through the front-end.

Shows the three things a user migrating from the reference library gets
for free:

* ``auto_format=True`` — best_format picks the layout (matrix-free
  stencil, DIA for other diagonal patterns, CSR otherwise) with zero
  knowledge;
* multi-RHS panels — ``solve(a, B)`` with B of shape (n, m) runs one
  batched (optionally preconditioned) CG: one SpMM per iteration feeds
  every column;
* nonsymmetric systems — BiCGStab/CGS run over any layout.

    python examples/unstructured_solve.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.utils.generate import (
    convection_diffusion_2d,
    laplace_3d_jittered,
)


def main(n: int = 40) -> None:
    # -- general (banded-broken) SPD pattern, auto-selected layout -----
    a = laplace_3d_jittered(n, symmetric=True, shift=0.25, dtype=np.float32)
    b = a @ jnp.ones(a.shape[0], jnp.float32)
    res = smm.solve(a, b, method="cg", epsilon=1e-4, auto_format=True)
    print(f"auto-format CG: status={int(res.status)} "
          f"iters={int(res.iterations)} "
          f"max|x-1|={float(jnp.abs(res.x - 1.0).max()):.2e}")

    # -- multi-RHS panel: one preconditioned batched CG ----------------
    rng = np.random.default_rng(0)
    a2 = convection_diffusion_2d(n, cx=0.0, cy=0.0, dtype=np.float64)
    B = jnp.asarray(rng.standard_normal((a2.shape[0], 4)))
    multi = smm.solve(a2, B, method="cg", preconditioner="sgs",
                      epsilon=1e-10)
    print(f"multi-RHS PCG+SGS: statuses={[int(s) for s in multi.status]} "
          f"iters={[int(i) for i in multi.iterations]}")

    # -- nonsymmetric system (upwind convection-diffusion) -------------
    a3 = convection_diffusion_2d(n, cx=0.8, cy=0.3, dtype=np.float64)
    b3 = a3 @ jnp.ones(a3.shape[0], jnp.float64)
    res3 = smm.solve(a3, b3, method="bicgstab", preconditioner="sgs",
                     epsilon=1e-10, auto_format=True)
    print(f"nonsymmetric BiCGStab+SGS: status={int(res3.status)} "
          f"iters={int(res3.iterations)} "
          f"max|x-1|={float(jnp.abs(res3.x - 1.0).max()):.2e}")

    # -- the minimal-residual alternative: restarted GMRES + ILU(0) ----
    res4 = smm.solve(a3, b3, method="gmres", preconditioner="ilu0",
                     epsilon=1e-10)
    print(f"nonsymmetric GMRES+ILU0: status={int(res4.status)} "
          f"iters={int(res4.iterations)}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40)
