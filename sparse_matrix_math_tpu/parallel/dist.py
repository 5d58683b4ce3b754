"""Row-partitioned distributed CSR + SpMV + Krylov solves via shard_map.

The reference's entire parallelism story is TBB ``parallel_for`` over row
ranges of the CSR matrix (reference include/sparse_matrix_math.h:1493-1497)
and a deterministic parallel reduction for dot products (h:305-328).  The
Scaling design (SURVEY §2.3, §7):

* the matrix row dimension is laid out across a 1-D device mesh — each
  device owns a contiguous block of rows as padded ``(P, L)`` CSR-like
  arrays (values / global column ids / local row ids);
* vectors are sharded by the same row blocks;
* SpMV inside ``shard_map``: all_gather the multiplicand ``x`` along the
  mesh axis (the halo exchange — full-width for generality; banded
  matrices can use the neighbor-window variant), gather by column,
  segment-sum into the local row block;
* every dot product is a local partial dot + ``psum`` — the collective
  equivalent of the reference's deterministic TBB reduce;
* the *same* solver algorithm cores (solvers/*.py) run inside shard_map,
  so single-chip and multi-chip solves share one implementation.

Padding rules keep everything exact: padded rows have no nnz, padded
vector entries are 0, padded nnz slots have value 0 — so every dot, norm
and SpMV result is bit-identical in the padded system.
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

from ..formats.csr import CSRMatrix
from ..ops.vector import dot as _plain_dot
from ..precond.preconditioners import (
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
)
from ..precond.trisolve import TriangularMatrix
from ..solvers.bicg_symmetric import bicg_symmetric_core
from ..solvers.bicgstab import bicgstab_core
from ..solvers.cg import cg_core, pcg_core
from ..solvers.cgs import cgs_core
from ..solvers.chebyshev import chebyshev_core
from ..solvers.gmres import gmres_core
from ..solvers.pipelined import cg_pipelined_core
from ..solvers.types import SolveResult, resolve_max_iterations
from .mesh import ROW_AXIS, gather_to_host, make_mesh, resolve_mesh, put_sharded

__all__ = [
    "DistCSR",
    "distribute_csr",
    "distribute_vector",
    "collect",
    "dist_spmv",
    "dist_solve",
    "distribute_preconditioner",
]

_LANE = 128  # pad per-shard nnz to a multiple of 128 (aligned tiles)


# -- distributed containers ---------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistCSR:
    """Row-block-partitioned CSR.

    ``data``/``cols``/``lrows`` are ``(P, L)``: shard-major padded nnz
    arrays (value, column id, local row id).  Padding slots hold value 0
    at column 0 of the shard's last row, so they contribute exactly
    nothing.  The leading axis is sharded over the mesh.

    In halo mode the nnz are SPLIT at pack time: the main arrays hold the
    INTERIOR entries (columns inside the shard's own block, ids local to
    it) and ``bdata``/``bcols``/``blrows`` hold the BOUNDARY entries
    (columns in the neighbor blocks, ids window-local in [0, 3B)).  The
    interior SpMV term reads only the shard's own x block, so it has no
    data dependency on the ppermute halo — XLA overlaps the collective
    with the bulk of the compute.  In allgather mode everything is in the
    main arrays (global column ids) and the boundary arrays are empty.
    """

    data: jnp.ndarray    # (P, L)
    cols: jnp.ndarray    # (P, L) int32: global ids (allgather) or
                         #               own-block-local ids (halo interior)
    lrows: jnp.ndarray   # (P, L) int32, local row ids in [0, block_rows)
    bdata: jnp.ndarray   # (P, Lb) boundary values (halo mode; empty otherwise)
    bcols: jnp.ndarray   # (P, Lb) int32 window-local ids in [0, 3B)
    blrows: jnp.ndarray  # (P, Lb) int32 local row ids
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    block_rows: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    # "allgather": halo exchange gathers the full x (exact for any pattern).
    # "halo": every shard's columns fall inside its neighbor window
    #   [(d-1)B, (d+2)B) — only the two neighbor blocks are exchanged via
    #   ppermute (O(B) per shard instead of O(n); the banded/stencil case).
    mode: str = dataclasses.field(metadata=dict(static=True), default="allgather")

    @property
    def n_shards(self) -> int:
        return int(self.data.shape[0])

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.block_rows

    @property
    def dtype(self):
        return self.data.dtype


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pack_group(rows, local_cols, data, shard_of, *, n_dev, block, pad_col):
    """Lay one group of COO entries (columns already rewritten to the
    target index space) into padded per-shard (P, L) arrays."""
    seg_nnz = np.bincount(shard_of, minlength=n_dev) if rows.size else np.zeros(
        n_dev, np.int64
    )
    order = np.argsort(shard_of, kind="stable")
    rows, local_cols, data = rows[order], local_cols[order], data[order]
    starts = np.zeros(n_dev + 1, dtype=np.int64)
    np.cumsum(seg_nnz, out=starts[1:])
    slots = max(_round_up(int(seg_nnz.max()) if rows.size else 0, _LANE), _LANE)
    v = np.zeros((n_dev, slots), dtype=data.dtype)
    c = np.full((n_dev, slots), pad_col, dtype=np.int32)
    lr = np.full((n_dev, slots), block - 1, dtype=np.int32)
    for d in range(n_dev):
        lo, hi = int(starts[d]), int(starts[d + 1])
        k = hi - lo
        v[d, :k] = data[lo:hi]
        c[d, :k] = local_cols[lo:hi]
        lr[d, :k] = rows[lo:hi] - d * block
    return v, c, lr


def _pack_row_blocks(
    rows: np.ndarray,
    cols: np.ndarray,
    data: np.ndarray,
    *,
    n_dev: int,
    block: int,
    mode: str,
):
    """Lay row-sorted COO entries into padded per-shard (P, L) arrays.

    ``mode="auto"`` picks "halo" when every shard's columns fall within its
    neighbor window [(d-1)·B, (d+2)·B), else "allgather".  In halo mode the
    entries are split into interior (cols in the shard's own block, ids
    local to it) and boundary (cols in the neighbor blocks, ids
    window-local in [0, 3B)) groups, so the SpMV's interior term carries
    no dependency on the halo exchange.  Pad slots hold value 0.
    """
    shard_of = rows // block if rows.size else rows.astype(np.int64)

    if mode == "auto":
        lo_ok = cols >= (shard_of - 1) * block
        hi_ok = cols < (shard_of + 2) * block
        mode = "halo" if (rows.size == 0 or bool(np.all(lo_ok & hi_ok))) else "allgather"
    elif mode == "halo":
        if rows.size and not bool(
            np.all((cols >= (shard_of - 1) * block) & (cols < (shard_of + 2) * block))
        ):
            raise ValueError(
                "matrix columns escape the neighbor window; halo mode invalid"
            )

    if mode == "halo":
        interior = (cols >= shard_of * block) & (cols < (shard_of + 1) * block)
        v, c, lr = _pack_group(
            rows[interior], (cols - shard_of * block)[interior],
            data[interior], shard_of[interior],
            n_dev=n_dev, block=block, pad_col=0,
        )
        bmask = ~interior
        bv, bc, blr = _pack_group(
            rows[bmask], (cols - (shard_of - 1) * block)[bmask],
            data[bmask], shard_of[bmask],
            n_dev=n_dev, block=block, pad_col=block,
        )
        return v, c, lr, bv, bc, blr, mode

    v, c, lr = _pack_group(
        rows, cols, data, shard_of, n_dev=n_dev, block=block, pad_col=0
    )
    empty_v = np.zeros((n_dev, 0), dtype=data.dtype)
    empty_i = np.zeros((n_dev, 0), dtype=np.int32)
    return v, c, lr, empty_v, empty_i.copy(), empty_i.copy(), mode


def distribute_csr(
    csr: CSRMatrix,
    mesh: Optional[jax.sharding.Mesh] = None,
    *,
    axis: str = ROW_AXIS,
    mode: str = "auto",
) -> DistCSR:
    """Partition a CSR matrix into equal row blocks over ``mesh``.

    Host-side layout transform + device_put with a row NamedSharding, the
    distributed analogue of the reference's single-heap ``CSRMatrix::init``
    (h:1327-1349).  ``mode``: "auto" (default) uses the O(B) neighbor-halo
    exchange when the sparsity pattern allows, "allgather"/"halo" force.
    """
    mesh = mesh if mesh is not None else make_mesh()
    n_dev = mesh.shape[axis]
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        # All partitioning/halo/window math and vector padding below are
        # row-block based; a rectangular matrix would silently produce
        # wrong distributed SpMV results.
        raise ValueError(
            f"distribute_csr supports square systems only, got {csr.shape}"
        )
    block = max(_round_up(int(math.ceil(n_rows / n_dev)), 8), 8)

    vals, cols, lrows, bvals, bcols, blrows, mode = _pack_row_blocks(
        np.asarray(csr.row_ids, dtype=np.int64),
        np.asarray(csr.indices, dtype=np.int64),
        np.asarray(csr.data),
        n_dev=n_dev, block=block, mode=mode,
    )

    put = lambda a: put_sharded(a, mesh, P(axis, None))  # noqa: E731
    return DistCSR(
        data=put(vals), cols=put(cols), lrows=put(lrows),
        bdata=put(bvals), bcols=put(bcols), blrows=put(blrows),
        shape=(int(n_rows), int(n_cols)),
        block_rows=int(block),
        nnz=csr.nnz,
        axis=axis,
        mode=mode,
    )


def distribute_vector(
    x, dist: DistCSR, mesh: jax.sharding.Mesh
) -> jnp.ndarray:
    """Zero-pad a length-n vector to the padded row count and shard it."""
    x = np.asarray(x)
    n_pad = dist.padded_rows
    if x.shape[0] != n_pad:
        x = np.concatenate([x, np.zeros(n_pad - x.shape[0], dtype=x.dtype)])
    return put_sharded(x, mesh, P(dist.axis))


def collect(x: jnp.ndarray, dist: DistCSR) -> np.ndarray:
    """Gather a sharded padded vector back to an unpadded host array
    (works across processes — parallel/mesh.py:gather_to_host)."""
    return gather_to_host(x)[: dist.shape[0]]


# -- local (per-shard) kernels ------------------------------------------------


def _local_spmv(
    data, cols, lrows, bdata, bcols, blrows, x_local, *,
    axis: str, block_rows: int, mode: str = "allgather",
):
    """Per-shard SpMV body: halo exchange + gather + segment-sum.

    mode="allgather": gather the full x along the mesh axis — exact for
    any sparsity pattern (SURVEY §2.3).  mode="halo": ppermute only the
    two neighbor blocks (O(B) communication), with the nnz split at pack
    time into an INTERIOR term (own-block-local cols — reads x_local
    directly, no collective dependency, so XLA overlaps it with the
    in-flight ppermutes) and a BOUNDARY term gathered from the 3B-wide
    window once the halo lands.  ``indices_are_sorted`` holds because nnz
    stay row-major within the shard and pads map to the last local row.
    """
    if mode == "halo":
        n_dev = jax.lax.axis_size(axis)
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        # issue the halo first; the interior term below does not await it
        left = jax.lax.ppermute(x_local, axis, fwd)   # block d-1 arrives here
        right = jax.lax.ppermute(x_local, axis, bwd)  # block d+1 arrives here
        y = jax.ops.segment_sum(
            data * jnp.take(x_local, cols, axis=0),
            lrows, num_segments=block_rows, indices_are_sorted=True,
        )
        xg = jnp.concatenate([left, x_local, right])
        return y + jax.ops.segment_sum(
            bdata * jnp.take(xg, bcols, axis=0),
            blrows, num_segments=block_rows, indices_are_sorted=True,
        )
    xg = jax.lax.all_gather(x_local, axis, tiled=True)
    g = data * jnp.take(xg, cols, axis=0)
    return jax.ops.segment_sum(
        g, lrows, num_segments=block_rows, indices_are_sorted=True
    )


def _psum_dot(axis: str):
    def dotfn(u, v):
        return jax.lax.psum(_plain_dot(u, v), axis)

    return dotfn


# -- distributed preconditioners ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class _DistTriArrays:
    """Distributed strict-triangular factor + diagonal (host-side holder;
    flattened into plain arrays before crossing into shard_map)."""

    data: jnp.ndarray    # (P, L) interior
    cols: jnp.ndarray    # (P, L) int32
    lrows: jnp.ndarray   # (P, L) int32 local
    bdata: jnp.ndarray   # (P, Lb) boundary
    bcols: jnp.ndarray   # (P, Lb) int32
    blrows: jnp.ndarray  # (P, Lb) int32
    diag: jnp.ndarray    # (n_pad,) sharded; pad entries 1.0
    sweeps: int

    @property
    def flat(self):
        return (
            self.data, self.cols, self.lrows,
            self.bdata, self.bcols, self.blrows, self.diag,
        )


# Per-kind flat-array ranks: 2 = (P, L) factor arrays, 1 = (n_pad,) sharded
# vectors.  SINGLE source of truth shared by distribute_preconditioner's
# construction (validated below) and _dist_solve_jit's shard_map in_specs.
_TRI = (2, 2, 2, 2, 2, 2, 1)  # interior + boundary arrays + diag
_PRE_LAYOUT = {
    "none": (),
    "jacobi": (1,),
    # fwd factor + bwd factor + D scale
    "sgs": _TRI + _TRI + (1,),
    # lower factor + upper factor
    "ilu0": _TRI + _TRI,
    "ic0": _TRI + _TRI,
}


@dataclasses.dataclass(frozen=True)
class DistPreconditioner:
    """Distributed preconditioner: a static ``kind`` plus flat arrays.

    ``kind`` is one of none/jacobi/sgs/ilu0/ic0; triangular applies run as
    Jacobi sweeps (each sweep = one distributed strict-SpMV), the scalable
    strategy from precond/trisolve.py.  Array ranks must match
    ``_PRE_LAYOUT[kind]`` (checked at construction).
    """

    kind: str
    arrays: Tuple[jnp.ndarray, ...]
    statics: Tuple[int, ...]  # per-factor sweep counts etc.

    def __post_init__(self):
        expected = _PRE_LAYOUT[self.kind]
        got = tuple(a.ndim for a in self.arrays)
        if got != expected:
            raise ValueError(
                f"{self.kind} preconditioner arrays have ranks {got}, "
                f"expected {expected}"
            )


def _distribute_triangular(
    tri: TriangularMatrix, dist: DistCSR, mesh: jax.sharding.Mesh
) -> _DistTriArrays:
    """Lay a TriangularMatrix's strict part into the dist row-block format
    (same exchange mode as the matrix it preconditions — the factor's
    pattern is a subset of A's, so halo feasibility carries over)."""
    if not isinstance(tri.strict, CSRMatrix):
        raise TypeError(
            "distributed triangular sweeps need a factor built from CSR, "
            f"not one whose strict part is {type(tri.strict).__name__}"
        )
    csr = tri.strict
    n = tri.n
    block = dist.block_rows
    n_dev = mesh.shape[dist.axis]
    v, c, lr, bv, bc, blr, _ = _pack_row_blocks(
        np.asarray(csr.row_ids, dtype=np.int64),
        np.asarray(csr.indices, dtype=np.int64),
        np.asarray(csr.data),
        n_dev=n_dev, block=block, mode=dist.mode,
    )

    diag = np.ones(dist.padded_rows, dtype=np.asarray(csr.data).dtype)
    diag[:n] = np.asarray(tri.diag)

    put = lambda a: put_sharded(a, mesh, P(dist.axis, None))  # noqa: E731
    return _DistTriArrays(
        data=put(v), cols=put(c), lrows=put(lr),
        bdata=put(bv), bcols=put(bc), blrows=put(blr),
        diag=put_sharded(diag, mesh, P(dist.axis)),
        sweeps=tri.sweeps if tri.method != "dense" else tri.depth,
    )


def distribute_preconditioner(
    precond, dist: DistCSR, mesh: Optional[jax.sharding.Mesh] = None
) -> DistPreconditioner:
    """Re-lay a single-chip preconditioner's factors over the mesh.

    Identity/Jacobi shard trivially; SGS/ILU0/IC0 triangular applies
    become distributed Jacobi sweeps (exact when the factor's
    level-schedule depth is reached — precond/trisolve.py).
    """
    mesh = resolve_mesh(
        mesh, dist.data, n_shards=dist.n_shards, axis=dist.axis
    )
    if precond is None or isinstance(precond, IdentityPreconditioner):
        return DistPreconditioner(kind="none", arrays=(), statics=())
    if isinstance(precond, JacobiPreconditioner):
        inv = np.ones(dist.padded_rows, dtype=np.asarray(precond.inv_diag).dtype)
        inv[: dist.shape[0]] = np.asarray(precond.inv_diag)
        return DistPreconditioner(
            kind="jacobi",
            arrays=(put_sharded(inv, mesh, P(dist.axis)),),
            statics=(),
        )
    if isinstance(precond, SGSPreconditioner):
        fwd = _distribute_triangular(precond.fwd, dist, mesh)
        bwd = _distribute_triangular(precond.bwd, dist, mesh)
        dscale = np.zeros(dist.padded_rows, dtype=np.asarray(precond.diag).dtype)
        dscale[: dist.shape[0]] = np.asarray(precond.diag)
        return DistPreconditioner(
            kind="sgs",
            arrays=fwd.flat + bwd.flat + (
                put_sharded(dscale, mesh, P(dist.axis)),
            ),
            statics=(fwd.sweeps, bwd.sweeps),
        )
    if isinstance(precond, (ILU0Preconditioner, IC0Preconditioner)):
        lo = _distribute_triangular(precond.lower, dist, mesh)
        up = _distribute_triangular(precond.upper, dist, mesh)
        return DistPreconditioner(
            kind="ilu0" if isinstance(precond, ILU0Preconditioner) else "ic0",
            arrays=lo.flat + up.flat,
            statics=(lo.sweeps, up.sweeps),
        )
    raise TypeError(f"cannot distribute preconditioner {type(precond).__name__}")


def _local_tri_solve(
    tri7, b_local, *, axis, block_rows, sweeps, mode="allgather",
):
    """Distributed triangular solve via Jacobi sweeps:
    x_{k+1} = (b - N x_k) / d with N the strict part (exact once the
    sweep count reaches the factor's dependency depth).  ``tri7`` is the
    factor's 7-array flat group (interior + boundary + diag)."""
    data, cols, lrows, bdata, bcols, blrows, diag_local = tri7
    inv_d = 1.0 / diag_local

    def sweep(x, _):
        nx = _local_spmv(
            data, cols, lrows, bdata, bcols, blrows, x,
            axis=axis, block_rows=block_rows, mode=mode,
        )
        return (b_local - nx) * inv_d, None

    x0 = b_local * inv_d
    x, _ = jax.lax.scan(sweep, x0, None, length=max(sweeps - 1, 0))
    return x


def _build_local_precond_apply(
    kind, arrays, statics, *, axis, block_rows, mode="allgather"
):
    """Construct the per-shard ``apply`` closure inside shard_map."""
    if kind == "none":
        return lambda r: r
    if kind == "jacobi":
        (inv_diag,) = arrays
        return lambda r: r * inv_diag
    if kind == "sgs":
        fwd7, bwd7, dscale = arrays[:7], arrays[7:14], arrays[14]
        fs, bs = statics

        def apply_sgs(r):
            y = _local_tri_solve(
                fwd7, r, axis=axis, block_rows=block_rows, sweeps=fs, mode=mode
            )
            return _local_tri_solve(
                bwd7, dscale * y,
                axis=axis, block_rows=block_rows, sweeps=bs, mode=mode,
            )

        return apply_sgs
    if kind in ("ilu0", "ic0"):
        lo7, up7 = arrays[:7], arrays[7:14]
        ls, us = statics

        def apply_lu(r):
            y = _local_tri_solve(
                lo7, r, axis=axis, block_rows=block_rows, sweeps=ls, mode=mode
            )
            return _local_tri_solve(
                up7, y, axis=axis, block_rows=block_rows, sweeps=us, mode=mode
            )

        return apply_lu
    raise ValueError(f"unknown distributed preconditioner kind {kind!r}")


# -- public distributed ops ---------------------------------------------------


def dist_spmv(a: DistCSR, x: jnp.ndarray, mesh: jax.sharding.Mesh) -> jnp.ndarray:
    """y = A @ x with row-sharded A and x (padded length)."""
    fn = _dist_spmv_jit(mesh, a.axis, a.block_rows, a.mode)
    return fn(a.data, a.cols, a.lrows, a.bdata, a.bcols, a.blrows, x)


@lru_cache(maxsize=None)
def _dist_spmv_jit(mesh, axis: str, block_rows: int, mode: str):
    def inner(data, cols, lrows, bdata, bcols, blrows, x_local):
        return _local_spmv(
            data[0], cols[0], lrows[0], bdata[0], bcols[0], blrows[0], x_local,
            axis=axis, block_rows=block_rows, mode=mode,
        )

    mapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(axis, None),) * 6 + (P(axis),),
        out_specs=P(axis),
    )
    return jax.jit(mapped)


_CORES = {
    "cg": cg_core,
    "bicg_symmetric": bicg_symmetric_core,
    "cgs": cgs_core,
    "bicgstab": bicgstab_core,
    "chebyshev": chebyshev_core,  # dot-free between checks: the
    # collective-minimal option for pods (solvers/chebyshev.py)
    "cg_pipelined": cg_pipelined_core,  # one fused psum per iteration
    # (Ghysels-Vanroose; solvers/pipelined.py)
    "gmres": gmres_core,  # panel contractions psum over the row axis
    # (see gmres_core's paneldot injection; solvers/gmres.py)
}


@lru_cache(maxsize=None)
def _dist_lanczos_jit(mesh, axis: str, block_rows: int, mode: str, k: int):
    def inner(data, cols, lrows, bdata, bcols, blrows, v0_local):
        arrs = (data[0], cols[0], lrows[0], bdata[0], bcols[0], blrows[0])
        dotfn = _psum_dot(axis)
        dtype = v0_local.dtype

        def step(carry, _):
            v_prev, v_cur, beta = carry
            w = (
                _local_spmv(
                    *arrs, v_cur,
                    axis=axis, block_rows=block_rows, mode=mode,
                )
                - beta * v_prev
            )
            alpha = dotfn(w, v_cur)
            w = w - alpha * v_cur
            new_beta = jnp.sqrt(dotfn(w, w))
            v_next = w / jnp.maximum(new_beta, jnp.asarray(1e-30, dtype))
            return (v_cur, v_next, new_beta), (alpha, new_beta)

        init = (jnp.zeros_like(v0_local), v0_local, jnp.asarray(0.0, dtype))
        _, (alphas, betas) = jax.lax.scan(step, init, None, length=k)
        return alphas, betas

    mapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(axis, None),) * 6 + (P(axis),),
        out_specs=(P(), P()),
    )
    return jax.jit(mapped)


def dist_lanczos_extremal(
    a: "DistCSR", mesh: jax.sharding.Mesh, k: int = 32, seed: int = 0
):
    """Extremal-eigenvalue estimate via k distributed Lanczos steps.

    The whole k-step recurrence is ONE jitted shard_map scan (all dots are
    psum collectives inside it) — no per-step host sync, so the cost is a
    single dispatch instead of ~3k launches on a high-latency link.  Only
    the tiny (k,) tridiagonal coefficients come back to the host for the
    dense eigensolve.  Used to bound distributed Chebyshev.
    """
    import numpy as np

    n_pad = a.padded_rows
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n_pad).astype(a.dtype)
    v[a.shape[0]:] = 0.0
    v = distribute_vector(v / np.linalg.norm(v), a, mesh)
    fn = _dist_lanczos_jit(mesh, a.axis, a.block_rows, a.mode, int(k))
    alphas, betas = fn(a.data, a.cols, a.lrows, a.bdata, a.bcols, a.blrows, v)
    al = np.asarray(alphas, dtype=np.float64)
    be = np.asarray(betas, dtype=np.float64)
    t = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    eig = np.linalg.eigvalsh(t)
    return float(eig[0]), float(eig[-1])


def dist_solve(
    a: DistCSR,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "cg",
    preconditioner: Optional[DistPreconditioner] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
    record_residuals: bool = False,
    eig_bounds=None,
    check_every: int = 10,
    restart: int = 32,
) -> SolveResult:
    """Distributed Krylov solve over the row mesh.

    Runs the identical algorithm core as the single-chip solver of the
    same name (solvers/*.py) inside ``shard_map``: SpMVs halo-exchange
    ``x`` via all_gather, every dot is a local partial + psum.  ``b``/
    ``x0`` may be host arrays of logical length n (they are padded and
    sharded here) or already-sharded padded arrays.

    The solution vector in the result is the *sharded padded* x — use
    :func:`collect` to bring it back to a host array of logical length.

    A :class:`~.dist_stencil.DistStencil` operator runs the matrix-free
    stencil path (:func:`~.dist_stencil.dist_stencil_solve`).
    """
    from .dist_stencil import DistStencil, dist_stencil_solve

    if isinstance(a, DistStencil):
        if preconditioner is not None:
            raise ValueError("the distributed stencil path is unpreconditioned")
        return dist_stencil_solve(
            a, b, x0, max_iterations, epsilon, solver=solver, mesh=mesh,
            record_residuals=record_residuals,
        )
    if solver not in _CORES:
        raise ValueError(f"unknown solver {solver!r}; options: {sorted(_CORES)}")
    mesh = resolve_mesh(
        mesh, a.data, n_shards=a.n_shards, axis=a.axis
    )
    if preconditioner is not None and solver not in (
        "cg", "bicgstab", "gmres"
    ):
        raise ValueError(
            "preconditioning is supported for cg, bicgstab, and gmres"
        )
    pre = preconditioner or DistPreconditioner(kind="none", arrays=(), statics=())

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

    if solver == "chebyshev" and eig_bounds is None:
        from ..solvers.chebyshev import widen_eig_bounds

        lo, hi = dist_lanczos_extremal(a, mesh, k=min(32, a.shape[0]))
        eig_bounds = widen_eig_bounds(lo, hi)
    cheb = (
        (float(eig_bounds[0]), float(eig_bounds[1]), int(check_every))
        if solver == "chebyshev"
        else None
    )
    gmres_m = (
        min(max(int(restart), 1), a.shape[0]) if solver == "gmres" else None
    )

    fn = _dist_solve_jit(
        mesh, a.axis, a.block_rows, a.mode, solver, maxiter,
        bool(record_residuals), pre.kind, pre.statics, len(pre.arrays), cheb,
        gmres_m,
    )
    return fn(
        a.data, a.cols, a.lrows, a.bdata, a.bcols, a.blrows,
        b_arr, x0_arr, eps, *pre.arrays,
    )


@lru_cache(maxsize=None)
def _dist_solve_jit(
    mesh,
    axis: str,
    block_rows: int,
    mode: str,
    solver: str,
    maxiter: int,
    record: bool,
    pre_kind: str,
    pre_statics: tuple,
    n_pre_arrays: int,
    cheb=None,
    gmres_m=None,
):
    core = _CORES[solver]

    def inner(data, cols, lrows, bdata, bcols, blrows, b_local, x0_local,
              eps, *pre_arrays):
        # shard_map delivers (1, L) slices for the (P, L) arrays
        arrs = (data[0], cols[0], lrows[0], bdata[0], bcols[0], blrows[0])
        pre_local = tuple(a[0] if a.ndim == 2 else a for a in pre_arrays)

        def matvec(v):
            return _local_spmv(
                *arrs, v, axis=axis, block_rows=block_rows, mode=mode
            )

        dotfn = _psum_dot(axis)
        apply_ = _build_local_precond_apply(
            pre_kind, pre_local, pre_statics,
            axis=axis, block_rows=block_rows, mode=mode,
        )
        if solver == "cg":
            if pre_kind == "none":
                return cg_core(matvec, dotfn, b_local, x0_local, eps, maxiter, record)
            return pcg_core(
                matvec, apply_, dotfn, b_local, x0_local, eps, maxiter, record
            )
        if solver == "bicgstab":
            return bicgstab_core(
                matvec, apply_, dotfn, b_local, x0_local, eps, maxiter, record
            )
        if solver == "cg_pipelined":

            def dot2(u1, v1, u2, v2):
                parts = jnp.stack([_plain_dot(u1, v1), _plain_dot(u2, v2)])
                both = jax.lax.psum(parts, axis)  # ONE collective
                return both[0], both[1]

            return cg_pipelined_core(
                matvec, dot2, b_local, x0_local, eps, maxiter, record
            )
        if solver == "chebyshev":
            lmin, lmax, check_every = cheb
            return chebyshev_core(
                matvec, dotfn, b_local, x0_local, eps,
                lmin, lmax, maxiter, check_every, record,
            )
        if solver == "gmres":

            def paneldot(V, w):
                # (m+1, n_local) @ (n_local,) is a shard-local partial
                # of the global panel contraction — ONE psum completes
                # all m+1 Arnoldi dots of a step together
                return jax.lax.psum(
                    jnp.matmul(V, w, precision=jax.lax.Precision.HIGHEST),
                    axis,
                )

            return gmres_core(
                matvec, apply_, dotfn, paneldot, b_local, x0_local, eps,
                gmres_m, maxiter, record,
            )
        return core(matvec, dotfn, b_local, x0_local, eps, maxiter, record)

    layout = _PRE_LAYOUT[pre_kind]
    assert len(layout) == n_pre_arrays
    pre_specs = [P(axis, None) if nd == 2 else P(axis) for nd in layout]

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
        in_specs=(
            *((P(axis, None),) * 6),
            P(axis), P(axis), P(),
            *pre_specs,
        ),
        out_specs=out_specs,
    )
    return jax.jit(mapped)
