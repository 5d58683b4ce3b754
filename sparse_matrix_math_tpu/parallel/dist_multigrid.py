"""Distributed geometric multigrid — the operator-aware solver on a mesh.

Single-device multigrid (solvers/multigrid.py) solves the Poisson
class in O(10) iterations; this module runs the SAME Galerkin
tensor-product hierarchy inside ``shard_map`` so that solver scales
over a mesh like the SpMV fast paths do (parallel/dist_dia.py).  The reference has no multigrid and no
distribution at all (its scaling mechanism is TBB row-parallel SpMV,
include/sparse_matrix_math.h:1493-1497); this is the native
composition of both.

Layout: grid vectors are sharded along axis 0 (the outermost grid axis —
contiguous row blocks of the row-major flat vector, matching
parallel/dist.py's convention).  Every multigrid component is a
radius-1 stencil along axis 0, so each distributed operation needs ONE
neighbor plane from each side, fetched with a non-wrapping ``ppermute``
(unmatched edge devices receive zeros = the homogeneous Dirichlet
boundary).  Collective volume per V-cycle and device: O(levels) single
planes — independent of device count.

Axis-0 divisibility: level l's axis-0 extent is padded to
``m0[l] = m0[0] / 2**l`` with ``m0[0]`` a multiple of ``P * 2**K`` (P
devices, K distributed levels), so every distributed level splits into
equal blocks AND the 2:1 restriction alignment holds across shard
boundaries (coarse plane j of device d reads fine planes 2j..2j+2 from
device d plus at most the first plane of d+1).  Padding planes carry
zeros, maintained by per-level plane masks and zeroed Galerkin/Jacobi
coefficients; the padded system restricted to real planes is EXACTLY the
true operator, so results match the single-chip hierarchy to roundoff.

Below the distributed levels the remaining grids are tiny (< a few
thousand points); the level-K residual is ``all_gather``-ed and the
single-chip hierarchy's tail (``PoissonMultigrid._vcycle`` from level K,
including the dense coarsest inverse) runs REPLICATED on every device —
cheaper than distributing work that no longer fills even one core.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..solvers.cg import cg_core, pcg_core
from ..solvers.multigrid import (
    PoissonMultigrid,
    _prolong_1d,
    _restrict_1d,
    _tridiag_apply,
)
from ..solvers.types import RUNNING, SolveResult, SolverStatus
from .mesh import ROW_AXIS, make_mesh, resolve_mesh, put_sharded

__all__ = [
    "DistPoissonMG",
    "distribute_multigrid",
    "dist_mg_solve",
    "dist_mg_vcycle",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistPoissonMG:
    """Axis-0-sharded multigrid hierarchy.

    ``ax0[l-1]`` (distributed levels l >= 1): the level's axis-0 Galerkin
    tridiagonal coefficients as (P, b0_l) shard blocks —
    (dL, uL, loL, dM, uM, loM) with ``lo[i] = u[i-1]`` precomputed
    host-side so shard-boundary couplings need no extra exchange.
    ``winv[l-1]``: (P, b0_l, *rest) Jacobi weights, zero on pad planes.
    ``masks[l]`` (levels 0..K): (P, b0_l) plane masks (1 = real plane).
    ``inner``: the full single-chip hierarchy — replicated; its levels
    K.. run as the coarse tail, and its statics define the true dims.
    """

    ax0: Tuple[Tuple[jnp.ndarray, ...], ...]
    winv: Tuple[jnp.ndarray, ...]
    masks: Tuple[jnp.ndarray, ...]
    inner: PoissonMultigrid
    m0s: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_levels_dist: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))

    @property
    def dims(self):
        return self.inner.dims

    @property
    def shape(self):
        n = int(np.prod(self.dims[0]))
        return (n, n)

    @property
    def n_shards(self) -> int:
        return int(self.masks[0].shape[0])

    @property
    def dtype(self):
        return self.masks[0].dtype


class _LocalMG(NamedTuple):
    """Per-shard view inside shard_map: every sharded leaf stripped to
    its local block ((b0_l, ...)), plus the replicated inner hierarchy
    and static plan."""

    ax0: tuple
    winv: tuple
    masks: tuple
    inner: PoissonMultigrid
    m0s: tuple
    k: int


def _shift_lo(u: np.ndarray) -> np.ndarray:
    """lo[i] = u[i-1] (the symmetric lower coefficient row-indexed)."""
    return np.pad(u[:-1], (1, 0))


def distribute_multigrid(
    mg: PoissonMultigrid,
    mesh: Optional[jax.sharding.Mesh] = None,
    *,
    axis: str = ROW_AXIS,
) -> DistPoissonMG:
    """Shard a :class:`PoissonMultigrid` hierarchy over a 1-D row mesh."""
    mesh = mesh if mesh is not None else make_mesh()
    n_dev = int(mesh.shape[axis])
    dims = mg.dims
    if len(dims) < 2:
        raise ValueError(
            "grid too small to distribute (single-level hierarchy); use "
            "the single-chip PoissonMultigrid"
        )

    # distributed levels 0..K-1; level K starts the replicated tail.
    # A level stays distributed while it still has >= 2 real planes per
    # device; K >= 1 always (the finest level is the one that matters).
    k = 1
    while k < len(dims) - 1 and dims[k][0] >= 2 * n_dev:
        k += 1

    unit = n_dev * (1 << k)
    m00 = -(-dims[0][0] // unit) * unit
    m0s = tuple(m00 >> l for l in range(k + 1))

    dtype = mg.winv[0].dtype if mg.winv else mg.coarse_inv.dtype

    def blocks(vec: np.ndarray, lvl: int):
        """Pad a per-plane array to m0s[lvl] planes and split into
        sharded (P, b0, ...) blocks."""
        m0 = m0s[lvl]
        v = np.asarray(vec)
        pad = [(0, m0 - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
        v = np.pad(v, pad).reshape((n_dev, m0 // n_dev) + v.shape[1:])
        spec = P(axis, *([None] * np.asarray(vec).ndim))
        return put_sharded(np.asarray(v, dtype), mesh, spec)

    masks = tuple(blocks(np.ones(dims[l][0]), l) for l in range(k + 1))
    ax0 = []
    winv = []
    for l in range(1, k):
        dl, ul, dm, um = (
            np.asarray(v, np.float64) for v in mg.factors[l - 1][0]
        )
        ax0.append(
            tuple(
                blocks(v, l)
                for v in (dl, ul, _shift_lo(ul), dm, um, _shift_lo(um))
            )
        )
        winv.append(blocks(np.asarray(mg.winv[l - 1]), l))

    return DistPoissonMG(
        ax0=tuple(ax0),
        winv=tuple(winv),
        masks=masks,
        inner=mg,
        m0s=m0s,
        n_levels_dist=k,
        axis=axis,
    )


# -- per-shard distributed grid operations -----------------------------------
# All operate on local blocks shaped (b0, *rest); halo = one plane each
# way via non-wrapping ppermute (edge devices read Dirichlet zeros).


def _halo(x: jnp.ndarray, axis: str):
    """(prev_last, next_first): one neighbor plane from each side."""
    n_dev = jax.lax.axis_size(axis)
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i + 1, i) for i in range(n_dev - 1)]
    prev_last = jax.lax.ppermute(x[-1:], axis, fwd)
    next_first = jax.lax.ppermute(x[:1], axis, bwd)
    return prev_last, next_first


def _mask_mul(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    return x * mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))


def _stencil_apply_dist(x, mask, axis: str):
    """Level-0 uniform 2d+1-point Laplacian, axis-0 sharded."""
    up, dn = _halo(x, axis)
    d = x.ndim
    y = (2.0 * d) * x
    y = y - jnp.concatenate([up, x[:-1]], 0)  # x[i-1]
    y = y - jnp.concatenate([x[1:], dn], 0)   # x[i+1]
    for ax in range(1, d):
        pads_lo = [(0, 0)] * d
        pads_lo[ax] = (1, 0)
        pads_hi = [(0, 0)] * d
        pads_hi[ax] = (0, 1)
        lo_sl = tuple(
            slice(0, -1) if a == ax else slice(None) for a in range(d)
        )
        hi_sl = tuple(
            slice(1, None) if a == ax else slice(None) for a in range(d)
        )
        y = y - jnp.pad(x[lo_sl], pads_lo) - jnp.pad(x[hi_sl], pads_hi)
    return _mask_mul(y, mask)


def _tridiag0_pair(x, c_l, c_m, axis: str):
    """Both axis-0 tridiagonal applies (L and M factors) off ONE halo
    exchange.  c_l/c_m = (d, u, lo) coefficient blocks shaped (b0,)."""
    up, dn = _halo(x, axis)
    x_m1 = jnp.concatenate([up, x[:-1]], 0)
    x_p1 = jnp.concatenate([x[1:], dn], 0)

    def tri(c):
        d, u, lo = (v.reshape((-1,) + (1,) * (x.ndim - 1)) for v in c)
        return d * x + u * x_p1 + lo * x_m1

    return tri(c_l), tri(c_m)


def _apply_coarse_dist(lm: _LocalMG, lvl: int, x, axis: str):
    """y = A_lvl x for a distributed Galerkin level (lvl >= 1): the
    axis-0 factor applies share one halo exchange; the other axes run
    the local tridiagonal passes (solvers/multigrid.py:_tridiag_apply).
    Pad planes carry zero coefficients, so no output mask is needed."""
    dl0, ul0, lo0, dm0, um0, mo0 = lm.ax0[lvl - 1]
    t_l, t_m = _tridiag0_pair(x, (dl0, ul0, lo0), (dm0, um0, mo0), axis)
    per_axis = lm.inner.factors[lvl - 1]
    d = x.ndim
    # term ax=0: L along axis 0, M along the rest
    y = t_l
    for a in range(1, d):
        _, _, dm, um = per_axis[a]
        y = _tridiag_apply(y, dm, um, a)
    # terms ax>=1: M along axis 0 (t_m), L along ax, M along the rest
    for ax in range(1, d):
        t = t_m
        for a in range(1, d):
            dl, ul, dm, um = per_axis[a]
            if a == ax:
                t = _tridiag_apply(t, dl, ul, a)
            else:
                t = _tridiag_apply(t, dm, um, a)
        y = y + t
    return y


def _smooth_dist(lm: _LocalMG, lvl: int, x, b, steps: int, axis: str):
    if lvl == 0:
        w = lm.inner.omega / (2.0 * len(lm.inner.dims[0]))
        for _ in range(steps):
            x = x + w * (b - _stencil_apply_dist(x, lm.masks[0], axis))
        return x
    w = lm.winv[lvl - 1]
    for _ in range(steps):
        x = x + w * (b - _apply_coarse_dist(lm, lvl, x, axis))
    return x


def _restrict_dist(lm: _LocalMG, r, lvl: int, axis: str):
    """Full-weighting restriction level lvl -> lvl+1, axis 0 sharded:
    rc[j] = f[2j+1] + 0.5 (f[2j] + f[2j+2]); the 2:1 block alignment
    means only fine plane 2*bc (= next shard's first) crosses the
    boundary.  Axes >= 1 restrict locally (true dims, unpadded)."""
    _, next_first = _halo(r, axis)
    center = r[1::2]
    left = r[0::2]
    right = jnp.concatenate([r[2::2], next_first], 0)
    rc = center + 0.5 * (left + right)
    rc = _mask_mul(rc, lm.masks[lvl + 1])
    for ax in range(1, r.ndim):
        rc = _restrict_1d(rc, lm.inner.dims[lvl + 1][ax], ax)
    return rc


def _prolong_dist(lm: _LocalMG, c, lvl: int, axis: str):
    """Bilinear prolongation level lvl+1 -> lvl (adjoint of
    :func:`_restrict_dist`), axis 0 sharded: fine 2j+1 <- c[j], fine
    2j <- 0.5 (c[j-1] + c[j]); only c[-1] of the previous shard crosses
    the boundary.  Axes >= 1 prolong locally."""
    prev_last, _ = _halo(c, axis)
    cpad = jnp.concatenate([prev_last, c], 0)  # (bc + 1, *rest)
    even = 0.5 * (cpad[:-1] + cpad[1:])
    fine = jnp.stack([even, c], axis=1).reshape((-1,) + c.shape[1:])
    fine = _mask_mul(fine, lm.masks[lvl])
    for ax in range(1, c.ndim):
        fine = _prolong_1d(fine, lm.inner.dims[lvl][ax], ax)
    return fine


def _vcycle_dist(lm: _LocalMG, b, lvl: int, axis: str):
    """One distributed V-cycle for A_lvl e = b from a zero guess."""
    if lvl == lm.k:
        # replicated tail: gather the level-k residual, run the
        # single-chip hierarchy's remaining levels on every device,
        # slice the local correction block back out
        full = jax.lax.all_gather(b, axis, axis=0, tiled=True)
        n0 = lm.inner.dims[lm.k][0]
        ec = lm.inner._vcycle(full[:n0], lm.k)
        pad = [(0, lm.m0s[lm.k] - n0)] + [(0, 0)] * (ec.ndim - 1)
        ec = jnp.pad(ec, pad)
        bc = lm.m0s[lm.k] // jax.lax.axis_size(axis)
        return jax.lax.dynamic_slice_in_dim(
            ec, jax.lax.axis_index(axis) * bc, bc, 0
        )
    x = _smooth_dist(lm, lvl, jnp.zeros_like(b), b, lm.inner.nu1, axis)
    if lvl == 0:
        r = b - _stencil_apply_dist(x, lm.masks[0], axis)
    else:
        r = b - _apply_coarse_dist(lm, lvl, x, axis)
    rc = _restrict_dist(lm, r, lvl, axis)
    ec = _vcycle_dist(lm, rc, lvl + 1, axis)
    x = x + _prolong_dist(lm, ec, lvl, axis)
    return _smooth_dist(lm, lvl, x, b, lm.inner.nu2, axis)


def _psum_vdot(axis: str):
    def dotfn(u, v):
        return jax.lax.psum(
            jnp.vdot(u, v, precision=jax.lax.Precision.HIGHEST), axis
        )

    return dotfn


# -- host-facing API ---------------------------------------------------------


def _to_blocks(dmg: DistPoissonMG, v, mesh) -> jnp.ndarray:
    """Flat length-n vector -> sharded (P, b0, *rest) grid blocks."""
    dims0 = dmg.dims[0]
    arr = np.asarray(v).reshape(dims0)
    m0 = dmg.m0s[0]
    pad = [(0, m0 - dims0[0])] + [(0, 0)] * (len(dims0) - 1)
    arr = np.pad(arr, pad).reshape(
        (dmg.n_shards, m0 // dmg.n_shards) + tuple(dims0[1:])
    )
    spec = P(dmg.axis, *([None] * len(dims0)))
    return put_sharded(np.asarray(arr, dmg.dtype), mesh, spec)


def _from_grid(dmg: DistPoissonMG, x: jnp.ndarray) -> jnp.ndarray:
    """Gathered padded grid (m0, *rest) -> flat true-length vector."""
    return x[: dmg.dims[0][0]].reshape(-1)


def dist_mg_vcycle(
    a: DistPoissonMG, r, mesh: Optional[jax.sharding.Mesh] = None
) -> jnp.ndarray:
    """One distributed V-cycle z ~= A^{-1} r (flat in/out) — the
    distributed twin of ``PoissonMultigrid.apply``, exposed for parity
    tests and custom outer loops."""
    mesh = resolve_mesh(
        mesh, a.masks[0], n_shards=a.n_shards, axis=a.axis
    )
    fn = _dist_mg_vcycle_jit(mesh, a.axis, a.m0s, a.n_levels_dist)
    return _from_grid(
        a, fn((a.ax0, a.winv, a.masks), a.inner, _to_blocks(a, r, mesh))
    )


@lru_cache(maxsize=None)
def _dist_mg_vcycle_jit(mesh, axis: str, m0s, k: int):
    def inner(hier, inner_mg, r_pk):
        lm = _local_view(hier, inner_mg, m0s, k)
        return _vcycle_dist(lm, r_pk[0], 0, axis)

    # prefix specs: P(axis) shards every hierarchy leaf on its leading
    # (shard) dimension; the inner hierarchy is fully replicated
    mapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis)),
        out_specs=P(axis),
    )
    return jax.jit(mapped)


def _local_view(hier, inner_mg: PoissonMultigrid, m0s, k: int) -> _LocalMG:
    """Strip the leading shard axis from every sharded hierarchy leaf."""
    ax0, winv, masks = jax.tree.map(lambda v: v[0], hier)
    return _LocalMG(
        ax0=ax0, winv=winv, masks=masks, inner=inner_mg, m0s=m0s, k=k
    )


def dist_mg_solve(
    a: DistPoissonMG,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "pcg",
    mesh: Optional[jax.sharding.Mesh] = None,
    record_residuals: bool = False,
) -> SolveResult:
    """Distributed solve of the hierarchy's fine-level Poisson system.

    ``solver="pcg"`` (production): CG preconditioned by one distributed
    V-cycle per iteration — the same pairing the single-chip bench
    headline uses (``cg(a, b, preconditioner=mg)``), with psum dots and
    plane-halo stencils.  ``solver="cg"`` runs plain distributed CG on
    the stencil (for baselines); ``solver="mg"`` is the stationary
    V-cycle iteration (PoissonMultigrid.solve's distributed twin).
    """
    if solver not in ("pcg", "cg", "mg"):
        raise ValueError(f"dist_mg_solve supports pcg/cg/mg, got {solver!r}")
    mesh = resolve_mesh(
        mesh, a.masks[0], n_shards=a.n_shards, axis=a.axis
    )

    n = a.shape[0]
    b_blocks = _to_blocks(a, b, mesh)
    x0_blocks = (
        jnp.zeros_like(b_blocks) if x0 is None else _to_blocks(a, x0, mesh)
    )
    maxiter = int(max_iterations)
    if maxiter < 0:
        maxiter = 100 if solver == "mg" else n
    eps = jnp.asarray(epsilon, dtype=b_blocks.dtype)
    fn = _dist_mg_solve_jit(
        mesh, a.axis, a.m0s, a.n_levels_dist, solver, maxiter,
        bool(record_residuals),
    )
    res = fn((a.ax0, a.winv, a.masks), a.inner, b_blocks, x0_blocks, eps)
    return dataclasses.replace(res, x=_from_grid(a, res.x))


@lru_cache(maxsize=None)
def _dist_mg_solve_jit(
    mesh, axis: str, m0s, k: int, solver: str, maxiter: int, record: bool
):
    def inner(hier, inner_mg, b_pk, x0_pk, eps):
        lm = _local_view(hier, inner_mg, m0s, k)
        b_local, x0_local = b_pk[0], x0_pk[0]
        dotfn = _psum_vdot(axis)
        matvec = lambda v: _stencil_apply_dist(v, lm.masks[0], axis)  # noqa: E731
        if solver == "mg":
            return _mg_stationary(lm, b_local, x0_local, eps, maxiter, axis)
        if solver == "cg":
            return cg_core(
                matvec, dotfn, b_local, x0_local, eps, maxiter, record
            )
        precond = lambda r: _vcycle_dist(lm, r, 0, axis)  # noqa: E731
        return pcg_core(
            matvec, precond, dotfn, b_local, x0_local, eps, maxiter, record
        )

    out_specs = SolveResult(
        x=P(axis),
        status=P(),
        iterations=P(),
        residual_norm=P(),
        residual_trace=P() if (record and solver != "mg") else None,
        # cg_core/pcg_core report the precision-floor latch; the mg
        # stationary loop does not
        floor_hit=P() if solver != "mg" else None,
    )
    mapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P(axis), P()),
        out_specs=out_specs,
    )
    return jax.jit(mapped)


def _mg_stationary(lm: _LocalMG, b, x0, eps, maxiter: int, axis: str):
    """Distributed stationary V-cycle iteration (the shard_map twin of
    solvers/multigrid.py:_mg_solve_jit, including its runaway guard)."""
    dotfn = _psum_vdot(axis)
    eps2 = eps * eps
    mask0 = lm.masks[0]

    r0 = b - _stencil_apply_dist(x0, mask0, axis)
    rr0 = dotfn(r0, r0)
    rr_cap = 1e4 * rr0 + jnp.asarray(1.0, rr0.dtype)

    def cond(carry):
        _, _, _, kk, status = carry
        return (status == RUNNING) & (kk < maxiter)

    def body(carry):
        x, r, _, kk, status = carry
        x = x + _vcycle_dist(lm, r, 0, axis)
        r = b - _stencil_apply_dist(x, mask0, axis)
        rr = dotfn(r, r)
        status = jnp.where(
            ~jnp.isfinite(rr) | (rr > rr_cap),
            SolverStatus.DIVERGED,
            jnp.where(rr <= eps2, SolverStatus.SUCCESS, RUNNING),
        ).astype(jnp.int32)
        return x, r, rr, kk + 1, status

    init_status = jnp.where(rr0 <= eps2, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )
    x, _, rr, kk, status = jax.lax.while_loop(
        cond, body, (x0, r0, rr0, jnp.int32(0), init_status)
    )
    status = jnp.where(
        status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status
    )
    return SolveResult(
        x=x,
        status=status.astype(jnp.int32),
        iterations=kk,
        residual_norm=jnp.sqrt(rr),
        residual_trace=None,
    )
