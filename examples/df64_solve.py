"""Example: f64-grade solves with f32 storage.

The reference library is templated over ``double`` with a 1e-8 residual
contract (test/include/test_common.h:30-38).  This example shows the
double-word f32 chain that meets it with f32 storage (docs/DESIGN.md
§16):

* ``load_matrix_df`` / ``df_operator_from_host_csr`` — the operator's
  float64 values split exactly into (hi, lo) f32 planes, so the problem
  reaching the device carries the full f64 data (a DfDiaMatrix for
  stencils — gather-free shifted reads — or a DfEllMatrix otherwise);
* ``cg_df64`` — the whole CG recurrence (SpMV, dots, scalar updates)
  runs in double-word f32 arithmetic (~2^-47 per op) inside one jitted
  while_loop;
* the result recombines to host float64 via ``DfSolveResult.x_f64()``.

    python examples/df64_solve.py [nx]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.utils.generate import poisson_2d


def main(nx: int = None) -> None:
    if nx is None:
        nx = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    a = poisson_2d(nx, dtype=np.float64)
    n = a.shape[0]

    # host-side f64 CSR arrays: what load_matrix_df produces from .mtx
    data = np.asarray(a.data, np.float64)
    indices = np.asarray(a.indices, np.int64)
    indptr = np.asarray(a.indptr, np.int64)

    # exact double-word operator (DIA auto-selected for the stencil)
    dfa = smm.df_operator_from_host_csr(data, indices, indptr, a.shape)
    print(f"operator: {type(dfa).__name__}  n={n}  nnz={dfa.nnz}")

    # manufactured solution in full f64
    x_true = np.random.default_rng(0).standard_normal(n)
    b = np.add.reduceat(data * x_true[indices], indptr[:-1])

    # eps=1e-10 — far past plain f32's representable resolution
    res = smm.cg_df64(dfa, b, epsilon=1e-10)
    x = res.x_f64()
    true_res = np.linalg.norm(b - np.add.reduceat(data * x[indices], indptr[:-1]))
    print(
        f"cg_df64: status={res.status_enum().name} "
        f"iterations={int(res.iterations)}"
    )
    print(f"true residual (host f64): {true_res:.3e}")
    print(f"x error vs manufactured:  "
          f"{np.linalg.norm(x - x_true) / np.linalg.norm(x_true):.3e}")

    # the fast path to the same bar: f32 inner CG + double-word
    # true-residual refinement (docs/DESIGN.md §16b) — f32 iteration
    # cost, optionally multigrid-preconditioned inner solves
    from sparse_matrix_math_tpu.solvers.multigrid import PoissonMultigrid

    mg = PoissonMultigrid.for_grid(nx)
    ir = smm.cg_ir_df64(dfa, b, epsilon=1e-10, preconditioner=mg)
    xi = ir.x_f64()
    ir_res = np.linalg.norm(
        b - np.add.reduceat(data * xi[indices], indptr[:-1])
    )
    print(
        f"cg_ir_df64 (+mg inner): status={ir.status_enum().name} "
        f"inner={int(ir.iterations)} outer={int(ir.outer_rounds)} "
        f"true residual {ir_res:.3e}"
    )

    # the same solve in plain f32 floors orders of magnitude higher
    a32 = poisson_2d(nx, dtype=np.float32)
    r32 = smm.cg(a32, b.astype(np.float32), epsilon=1e-10)
    x32 = np.asarray(r32.x, np.float64)
    f32_res = np.linalg.norm(
        b - np.add.reduceat(data * x32[indices], indptr[:-1])
    )
    print(
        f"plain f32 cg for comparison: status={r32.status_enum().name} "
        f"true residual {f32_res:.3e}"
    )


if __name__ == "__main__":
    main()
