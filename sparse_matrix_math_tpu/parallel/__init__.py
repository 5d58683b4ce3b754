"""Multi-chip distribution: 1-D row-partitioned mesh (SURVEY §2.3, §7)."""

from .dist_dia import DistDIA, dist_dia_solve, dist_dia_spmv, distribute_dia
from .dist_stencil import (
    DistStencil,
    dist_stencil_solve,
    dist_stencil_spmv,
    distribute_stencil,
)
from .dist_df64 import (
    DistDfDia,
    dist_bicgstab_ir_df64,
    dist_cg_ir_df64,
    dist_df_dia_spmv,
    distribute_df_dia,
)
from .dist_multigrid import (
    DistPoissonMG,
    dist_mg_solve,
    dist_mg_vcycle,
    distribute_multigrid,
)
from .dist import (
    DistCSR,
    DistPreconditioner,
    collect,
    dist_solve,
    dist_spmv,
    distribute_csr,
    distribute_preconditioner,
    distribute_vector,
)
from .mesh import (
    ROW_AXIS,
    gather_to_host,
    init_distributed,
    make_mesh,
    put_sharded,
    replicated_sharding,
    row_sharding,
)

__all__ = [
    "DistCSR",
    "DistDIA",
    "DistPoissonMG",
    "dist_mg_solve",
    "dist_mg_vcycle",
    "distribute_multigrid",
    "dist_dia_solve",
    "dist_dia_spmv",
    "DistStencil",
    "distribute_stencil",
    "dist_stencil_solve",
    "dist_stencil_spmv",
    "distribute_dia",
    "DistDfDia",
    "dist_bicgstab_ir_df64",
    "dist_cg_ir_df64",
    "dist_df_dia_spmv",
    "distribute_df_dia",
    "DistPreconditioner",
    "collect",
    "dist_solve",
    "dist_spmv",
    "distribute_csr",
    "distribute_preconditioner",
    "distribute_vector",
    "ROW_AXIS",
    "make_mesh",
    "replicated_sharding",
    "row_sharding",
    "init_distributed",
    "put_sharded",
    "gather_to_host",
]
