"""sparse_matrix_math_tpu — a sparse iterative-solver library in JAX.

A JAX/XLA re-design with the capabilities of the C++ reference library
vasil-pashov/sparse_matrix_math (see SURVEY.md):

* sparse formats: Triplet/COO assembly, CSR, ELL (padded), DIA
  (diagonal storage), HYB, matrix-free grid stencils, and RCM
  reordering (``ReorderedMatrix``)
* SpMV/SpMM family: rmult / rmult_add / rmult_sub (1-D and multi-RHS);
  ``best_format`` auto-selection (also via ``solve(auto_format=True)``)
* Krylov solvers as jitted while_loops: ConjugateGradient (plain +
  preconditioned + pipelined + mixed-precision + deflated + multi-RHS),
  BiCGSymmetric, ConjugateGradientSquared, BiCGStab, restarted GMRES,
  Chebyshev semi-iteration; ``cg_df64``/``bicgstab_df64`` run the whole
  recurrence in double-word f32 (ops/df32.py) for 1e-8-grade solves
  with f32 storage (pair with ``load_matrix_df``), and ``cg_ir_df64``
  reaches the same bar at plain-f32 iteration cost via true-residual
  iterative refinement (solvers/ir_df64.py)
* preconditioners: Identity, Jacobi, Symmetric Gauss-Seidel (CSR and
  DIA factors), ILU(0), IC(0) with parallel triangular-solve strategies,
  Chebyshev polynomial; geometric multigrid (PoissonMultigrid) as
  solver or PCG preconditioner
* I/O: Matrix Market (.mtx) + SMMDT dense-text, extension dispatch
* distribution: 1-D mesh row partitioning via shard_map with psum
  reductions and neighbor-halo ppermute (all_gather where the pattern
  demands) for CSR / DIA / stencil / multigrid (parallel/)
"""

from .formats import best_format
from .formats.stencil import GridStencilMatrix, try_grid_stencil_from_csr
from .formats.reorder import (
    ReorderedMatrix,
    permute_csr,
    rcm_permutation,
    reorder_rcm,
)
from .formats.csr import CSRMatrix, csr_from_coo, csr_from_dense, csr_from_triplet
from .formats.dia import DIAMatrix, dia_from_csr, try_dia_from_csr
from .formats.ell import ELLMatrix, ell_from_csr
from .formats.hyb import HYBMatrix, hyb_from_csr
from .formats.triplet import COOArrays, TripletMatrix, coo_from_arrays
from .io.dispatch import load_matrix, load_matrix_csr, load_matrix_df
from .io.matrix_market import MatrixLoadStatus, MatrixMarketError, load_matrix_market
from .io.smmdt import load_smmdt, save_dense_text
from .ops.spmv import rmult, rmult_add, rmult_sub
from .ops.vector import axpy, dot, norm2, norm2_squared
from .precond.preconditioners import (
    FactorizationError,
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
    SolverPreconditioner,
    get_preconditioner,
)
from .solvers.api import SolverConfig, solve
from .solvers.bicg_symmetric import bicg_symmetric
from .solvers.block import MultiSolveResult, cg_multi
from .solvers.bicgstab import bicgstab
from .solvers.cg import cg, conjugate_gradient
from .solvers.cgs import cgs, conjugate_gradient_squared
from .solvers.chebyshev import chebyshev, lanczos_extremal
from .solvers.deflated import deflated_cg, lanczos_deflation_basis
from .solvers.df64 import DfSolveResult, bicgstab_df64, cg_df64
from .solvers.ir_df64 import bicgstab_ir_df64, cg_ir_df64
from .ops.df32 import (
    DfDiaMatrix,
    DfEllMatrix,
    df_from_host,
    df_operator_from_host_csr,
    df_to_host,
)
from .solvers.gmres import gmres
from .solvers.implicit import cg_solve
from .solvers.mixed import mixed_cg
from .solvers.multigrid import PoissonMultigrid
from .solvers.pipelined import cg_pipelined
from .solvers.types import SolveResult, SolverStatus
from .utils.checkpoint import (
    checkpointed_solve,
    load_checkpoint,
    load_csr_npz,
    save_checkpoint,
    save_csr_npz,
)
from .utils.profiling import SolveStats, solve_with_stats, spmv_throughput

__version__ = "0.1.0"

__all__ = [
    "CSRMatrix", "csr_from_coo", "csr_from_dense", "csr_from_triplet",
    "DIAMatrix", "dia_from_csr", "try_dia_from_csr",
    "ELLMatrix", "ell_from_csr",
    "HYBMatrix", "hyb_from_csr",
    "COOArrays", "TripletMatrix", "coo_from_arrays",
    "load_matrix", "load_matrix_csr", "load_matrix_df", "load_matrix_market",
    "load_smmdt",
    "save_dense_text", "MatrixLoadStatus", "MatrixMarketError",
    "rmult", "rmult_add", "rmult_sub",
    "axpy", "dot", "norm2", "norm2_squared",
    "FactorizationError", "IC0Preconditioner", "IdentityPreconditioner",
    "ILU0Preconditioner", "JacobiPreconditioner", "SGSPreconditioner",
    "SolverPreconditioner", "get_preconditioner",
    "bicg_symmetric", "bicgstab", "cg", "conjugate_gradient",
    "cgs", "conjugate_gradient_squared", "cg_solve",
    "chebyshev", "lanczos_extremal", "cg_pipelined", "mixed_cg",
    "deflated_cg", "lanczos_deflation_basis", "gmres",
    "DfDiaMatrix", "DfEllMatrix", "DfSolveResult", "bicgstab_df64", "cg_df64",
    "bicgstab_ir_df64", "cg_ir_df64",
    "df_from_host", "df_to_host", "df_operator_from_host_csr",
    "cg_multi", "MultiSolveResult", "PoissonMultigrid", "best_format",
    "GridStencilMatrix", "try_grid_stencil_from_csr",
    "ReorderedMatrix", "rcm_permutation", "permute_csr", "reorder_rcm",
    "SolveResult", "SolverStatus", "SolverConfig", "solve",
    "checkpointed_solve", "load_checkpoint", "save_checkpoint",
    "load_csr_npz", "save_csr_npz",
    "SolveStats", "solve_with_stats", "spmv_throughput",
    "__version__",
]
