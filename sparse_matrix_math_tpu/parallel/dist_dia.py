"""Distributed DIA (stencil) matrices — the multi-device fast path.

parallel/dist.py distributes CSR with a gather+segment-sum local kernel;
a banded system should keep the gather-free shifted-slice SpMV on a mesh
too.  This module row-partitions a DIAMatrix so the stencil SpMV runs
INSIDE ``shard_map``:

* each shard owns a contiguous row block of every diagonal
  (``diags`` sharded on the row axis);
* the multiplicand halo is the O(B) neighbor-window ppermute exchange
  (requires every |offset| <= block size — i.e. the band must not span
  more than one neighbor block; true for any stencil at practical
  block sizes);
* the local SpMV is split into an INTERIOR part (reads only the shard's
  own x block — no collective dependency) and a BOUNDARY part (reads
  the ppermuted neighbor blocks).  The interior compute is issued
  independently of the ppermutes, so XLA's latency-hiding scheduler
  overlaps communication with the bulk of the FLOPs (SURVEY §2.3's
  "overlapped with local SpMV" plan; the same split rationale as
  overlap-aware stencil codes on MPI).

Collective volume per SpMV: 2 ppermutes x B elements (send left + send
right) per shard — independent of device count — vs. the allgather
mode's (P-1) x B.  Per CG iteration add 2 psum latencies (dots).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..formats.dia import DIAMatrix
from ..solvers.types import SolveResult, resolve_max_iterations
from .dist import _CORES, _psum_dot, distribute_vector
from .mesh import ROW_AXIS, make_mesh, resolve_mesh, put_sharded

__all__ = ["DistDIA", "distribute_dia", "dist_dia_spmv", "dist_dia_solve"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistDIA:
    """Row-block-partitioned DIA matrix.

    ``diags`` is (P, ndiags, B): shard-major row blocks of each diagonal
    (rows beyond n zero-padded).  The leading axis is sharded over the
    1-D row mesh; vectors use the same padded row blocks (see
    parallel/dist.py's conventions — DistDIA deliberately reuses
    ``distribute_vector``/``collect`` via duck-typed fields).
    """

    diags: jnp.ndarray  # (P, ndiags, B)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    block_rows: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))

    @property
    def n_shards(self) -> int:
        return int(self.diags.shape[0])

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.block_rows

    @property
    def dtype(self):
        return self.diags.dtype


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def distribute_dia(
    dia: DIAMatrix,
    mesh: Optional[jax.sharding.Mesh] = None,
    *,
    axis: str = ROW_AXIS,
) -> DistDIA:
    """Partition a DIA matrix into equal row blocks over ``mesh``.

    Requires ``max |offset| <= block`` so the neighbor-window halo
    (one block left + one block right) covers every read — the banded
    precondition of the O(B) exchange.
    """
    mesh = mesh if mesh is not None else make_mesh()
    n_dev = mesh.shape[axis]
    n_rows, n_cols = dia.shape
    if n_rows != n_cols:
        raise ValueError(
            f"distribute_dia supports square systems only, got {dia.shape}"
        )
    block = max(_round_up(int(math.ceil(n_rows / n_dev)), 8), 8)
    span = max(max(abs(o) for o in dia.offsets), 0) if dia.offsets else 0
    if span > block:
        raise ValueError(
            f"diagonal offset {span} exceeds the row block {block}; "
            "the neighbor-window halo cannot cover it (fall back to "
            "distribute_csr in allgather mode)"
        )

    d = np.asarray(dia.diags)
    d = np.pad(d, ((0, 0), (0, n_dev * block - n_rows)))
    d = d.reshape(d.shape[0], n_dev, block).transpose(1, 0, 2)

    return DistDIA(
        diags=put_sharded(d, mesh, P(axis, None, None)),
        offsets=tuple(int(o) for o in dia.offsets),
        shape=(int(n_rows), int(n_cols)),
        block_rows=int(block),
        nnz=dia.nnz,
        axis=axis,
    )


def _local_dia_spmv(diags, x_local, *, offsets, axis: str, block_rows: int):
    """Per-shard stencil SpMV with interior/boundary overlap.

    ``diags`` is the shard's (ndiags, B) block; global row r = d*B + i
    reads x[r + off] = window[B + i + off] where window = [left | own |
    right].  The interior term only touches ``own`` (boundary rows
    masked), so it carries NO data dependency on the ppermutes — XLA
    schedules it while the halo is in flight; the boundary term (the
    first/last |off| rows per diagonal) completes y afterwards.
    """
    n_dev = jax.lax.axis_size(axis)
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    # issue halo exchange first; interior compute below does not await it
    left = jax.lax.ppermute(x_local, axis, fwd)   # block d-1 arrives
    right = jax.lax.ppermute(x_local, axis, bwd)  # block d+1 arrives

    B = block_rows
    dtype = jnp.result_type(diags.dtype, x_local.dtype)
    y_int = jnp.zeros((B,), dtype)
    y_bnd = jnp.zeros((B,), dtype)
    i = jnp.arange(B)
    zeros = jnp.zeros((B,), x_local.dtype)
    for d, off in enumerate(offsets):
        coeff = diags[d]
        # interior: rows whose read i+off stays inside [0, B)
        xin = (
            jnp.roll(x_local, -off)  # static roll: row i reads x[i+off]
            if off
            else x_local
        )
        inside = (i + off >= 0) & (i + off < B)
        y_int = y_int + coeff * jnp.where(inside, xin, zeros)
        # boundary: rows reading the left (i+off < 0) or right block
        if off < 0:
            xb = jnp.roll(left, -off)
            y_bnd = y_bnd + coeff * jnp.where(i + off < 0, xb, zeros)
        elif off > 0:
            xb = jnp.roll(right, -off)
            y_bnd = y_bnd + coeff * jnp.where(i + off >= B, xb, zeros)
    return y_int + y_bnd


def dist_dia_spmv(a: DistDIA, x: jnp.ndarray, mesh: jax.sharding.Mesh):
    """y = A @ x with row-sharded DIA A and padded sharded x."""
    fn = _dist_dia_spmv_jit(mesh, a.axis, a.block_rows, a.offsets)
    return fn(a.diags, x)


@lru_cache(maxsize=None)
def _dist_dia_spmv_jit(mesh, axis: str, block_rows: int, offsets):
    def inner(diags, x_local):
        return _local_dia_spmv(
            diags[0], x_local, offsets=offsets, axis=axis, block_rows=block_rows
        )

    mapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis)),
        out_specs=P(axis),
    )
    return jax.jit(mapped)


def dist_dia_solve(
    a: DistDIA,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "cg",
    mesh: Optional[jax.sharding.Mesh] = None,
    record_residuals: bool = False,
) -> SolveResult:
    """Distributed Krylov solve on the DIA fast path.

    Same algorithm cores as dist_solve (parallel/dist.py) — only the
    local matvec differs: the overlapped stencil SpMV above instead of
    gather+segment-sum.  ``b``/``x0`` may be host arrays of logical
    length n or already-sharded padded arrays.
    """
    # cores with the standard (matvec, dotfn, b, x0, eps, maxiter, record)
    # signature; bicgstab/chebyshev/pipelined need extra operands — use
    # dist_solve's CSR path for those until wired here
    if solver not in ("cg", "bicg_symmetric", "cgs", "bicgstab"):
        raise ValueError(
            "dist_dia_solve supports cg/bicg_symmetric/cgs/bicgstab, "
            f"got {solver!r}"
        )
    mesh = resolve_mesh(
        mesh, a.diags, n_shards=a.n_shards, axis=a.axis
    )

    b_arr = np.asarray(b) if not isinstance(b, jnp.ndarray) else b
    if b_arr.shape[0] != a.padded_rows:
        b_arr = distribute_vector(b_arr, a, mesh)
    if x0 is None:
        x0_arr = jnp.zeros_like(b_arr)
    else:
        x0_arr = np.asarray(x0) if not isinstance(x0, jnp.ndarray) else x0
        if x0_arr.shape[0] != a.padded_rows:
            x0_arr = distribute_vector(x0_arr, a, mesh)

    maxiter = resolve_max_iterations(max_iterations, a.shape[0])
    eps = jnp.asarray(epsilon, dtype=b_arr.dtype)
    fn = _dist_dia_solve_jit(
        mesh, a.axis, a.block_rows, a.offsets, solver, maxiter,
        bool(record_residuals),
    )
    return fn(a.diags, b_arr, x0_arr, eps)


@lru_cache(maxsize=None)
def _dist_dia_solve_jit(
    mesh, axis: str, block_rows: int, offsets, solver: str, maxiter: int,
    record: bool,
):
    core = _CORES[solver]

    def inner(diags, b_local, x0_local, eps):
        d = diags[0]

        def matvec(v):
            return _local_dia_spmv(
                d, v, offsets=offsets, axis=axis, block_rows=block_rows
            )

        dotfn = _psum_dot(axis)
        if solver == "bicgstab":  # its core carries a preconditioner slot
            return core(
                matvec, lambda v: v, dotfn, b_local, x0_local, eps, maxiter,
                record,
            )
        return core(matvec, dotfn, b_local, x0_local, eps, maxiter, record)

    out_specs = SolveResult(
        x=P(axis),
        status=P(),
        iterations=P(),
        residual_norm=P(),
        residual_trace=P() if record else None,
        # cg/pcg/bicgstab/bicg_symmetric/cgs cores report the
        # precision-floor latch (solvers/types.py:floor_hit); the other
        # cores leave it None
        floor_hit=P() if solver in (
            "cg", "bicgstab", "bicg_symmetric", "cgs"
        ) else None,
    )
    mapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis), P(axis), P()),
        out_specs=out_specs,
    )
    return jax.jit(mapped)
