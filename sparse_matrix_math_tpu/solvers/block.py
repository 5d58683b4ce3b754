"""Multi-RHS (blocked) solves — one SpMM feeds every right-hand side.

The reference solves one RHS per call (``SolverStatus f(A, b, x, ...)``,
include/sparse_matrix_math.h:2316-2320); solving k systems costs k full
Krylov runs.  Here the SpMV generalises to SpMM, so the multi-RHS design
runs ALL right-hand sides through one iteration loop:

* one SpMM ``A @ P`` per iteration instead of m SpMVs,
* per-column dots / axpys as per-column reductions on leading-batch
  panels,
* per-column convergence masking: columns that converged (or broke down)
  freeze exactly — their x/r/p stop updating — while the rest continue;
  the loop exits when every column has left the RUNNING state.

A bandwidth-bound SpMM's traffic scales with m, so extra columns are
never free; what batching buys is shared launch and loop overhead.

This is the "batched CG" formulation (independent recurrences, shared
kernels), chosen over classical block-CG (O'Leary) deliberately: block-CG
shares one Krylov space but needs rank-revealing re-orthogonalisation
when columns become linearly dependent — a poor fit for a fixed-shape
``lax.while_loop``.  Batched CG has no breakdown coupling: each column
behaves exactly like its own :func:`solvers.cg.cg` run.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.spmv import as_operator, matvec_fn
from .types import RUNNING, SolveResult, SolverStatus, resolve_max_iterations
from ..formats.reorder import reorder_hoisted

__all__ = ["cg_multi", "MultiSolveResult"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultiSolveResult:
    """Per-column solve outcome for a multi-RHS run.

    ``x`` is (n, m); ``status``/``iterations``/``residual_norm`` are (m,)
    — one entry per right-hand side, same semantics as SolveResult.
    """

    x: jnp.ndarray
    status: jnp.ndarray          # (m,) int32 SolverStatus values
    iterations: jnp.ndarray      # (m,) int32: iteration count at freeze
    residual_norm: jnp.ndarray   # (m,)
    # (maxiter+1, m) per-column ||r|| history (nan beyond a column's
    # freeze point), or None when record_residuals was off
    residual_trace: Optional[jnp.ndarray] = None

    def __getitem__(self, j: int) -> SolveResult:
        """The j-th column's outcome as a plain SolveResult."""
        return SolveResult(
            x=self.x[:, j],
            status=self.status[j],
            iterations=self.iterations[j],
            residual_norm=self.residual_norm[j],
            residual_trace=(
                None if self.residual_trace is None
                else self.residual_trace[:, j]
            ),
        )


@reorder_hoisted
def cg_multi(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    preconditioner=None,
    record_residuals: bool = False,
) -> MultiSolveResult:
    """Solve ``a @ X = B`` for SPD ``a`` and B of shape (n, m).

    Equivalent to m independent :func:`cg` runs (same iterates per
    column), at roughly the cost of the SLOWEST column — every iteration
    is one SpMM + per-column reductions instead of m separate loops.

    ``preconditioner`` is any object with a panel-capable ``apply``
    (all of :mod:`precond.preconditioners` qualify: Jacobi/SGS/ILU0/IC0
    applies broadcast over trailing RHS columns — the triangular solves
    run take/segment_sum over axis 0, so one apply serves all m columns
    just like the SpMM serves all m matvecs).  With it, each column runs
    the :func:`solvers.cg.pcg_core` recurrence (z = M r, rz inner
    products) under the same freeze-on-convergence masking.
    """
    a = as_operator(a)
    if b.ndim != 2:
        raise ValueError(f"cg_multi expects B of shape (n, m), got {b.shape}")
    n, m = b.shape
    if x0 is None:
        x0 = jnp.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    eps = jnp.asarray(epsilon, dtype=b.dtype)
    return _cg_multi_loop(
        a, preconditioner, b, x0, eps, maxiter, bool(record_residuals),
    )


@partial(jax.jit, static_argnums=(5, 6))
def _cg_multi_loop(
    a, precond, b, x0, eps, maxiter: int, record: bool,
) -> MultiSolveResult:
    """Nested structure (see solvers/cg.py:cg_core): the inner
    while_loop is the pure batched recurrence with per-column freeze
    masks and only SCALAR exit flags; the outer loop verifies claims /
    handles divergence / restarts refuted columns once per inner exit,
    so no per-iteration ``lax.cond`` copies the full panels.

    PANEL-MAJOR internals: every panel is carried with the column index
    LEADING — ``(m, *grid_dims)`` for stencil operators, ``(m, n)``
    otherwise — so each column is a contiguous run of memory.  For
    stencils the batched apply is ONE explicit pad+slice over the grid
    axes (GridStencilMatrix.apply_batched).  Other operators batch via
    ``jax.vmap`` of the single-vector apply.  B and X convert once at
    entry/exit."""
    eps2 = eps * eps
    m = b.shape[1]

    from ..formats.dia import DIAMatrix
    from ..formats.stencil import GridStencilMatrix

    if isinstance(a, GridStencilMatrix):
        dims = a.dims
        extra = len(dims)
        matvec = a.apply_batched

        def lift(B2):  # (n, m) -> (m, *dims)
            return B2.T.reshape((m,) + dims)

        def drop(X):
            return X.reshape(m, -1).T
    elif isinstance(a, DIAMatrix) and a.offsets:
        # explicit leading-batch DIA apply (shifts move to the LAST
        # axis), the same shape as the stencil branch
        extra = 1
        n_rows, n_cols = a.shape
        lpad = max(-min(a.offsets), 0)
        rpad = max(max(a.offsets) + n_rows - n_cols, 0)
        dia_offsets, dia_diags = a.offsets, a.diags

        def matvec(xT):  # (m, n_cols) -> (m, n_rows)
            xp = jnp.pad(xT, ((0, 0), (lpad, rpad)))
            y = jnp.zeros(
                (xT.shape[0], n_rows),
                jnp.result_type(dia_diags.dtype, xT.dtype),
            )
            for d, off in enumerate(dia_offsets):
                window = jax.lax.slice_in_dim(
                    xp, lpad + off, lpad + off + n_rows, axis=1
                )
                y = y + dia_diags[d][None, :] * window
            return y

        def lift(B2):
            return B2.T

        def drop(X):
            return X.T
    else:
        extra = 1
        matvec = jax.vmap(matvec_fn(a))

        def lift(B2):
            return B2.T

        def drop(X):
            return X.T

    def cb(v):  # broadcast a per-column (m,) vector over a panel
        return v.reshape((m,) + (1,) * extra)

    if precond is None:
        mapply = None
    elif extra == 1:
        mapply = jax.vmap(precond.apply)
    else:
        # stencil-layout panels: the preconditioner sees the
        # user-facing (n, m) panel
        def mapply(rT):
            return lift(precond.apply(drop(rT)))

    def coldot(u, v):
        return jnp.sum(u * v, axis=tuple(range(1, extra + 1)))  # (m,)

    bT = lift(b)
    x0T = lift(x0)
    has_z = mapply is not None

    r0 = bT - matvec(x0T)
    rr0 = coldot(r0, r0)
    status0 = jnp.where(rr0 <= eps2, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )
    trace0 = (
        jnp.full((maxiter + 1, m), jnp.nan, b.dtype).at[0].set(jnp.sqrt(rr0))
        if record else None
    )

    # carries hold z only when preconditioned: an unpreconditioned z
    # duplicates r exactly, and a duplicated while-loop carry costs a
    # full panel copy every iteration
    def pack(x, r, z, p, rz, rr, *rest):
        core = (x, r, z, p) if has_z else (x, r, p)
        return core + (rz, rr) + rest

    def unpack(c):
        if has_z:
            x, r, z, p = c[:4]
            rest = c[4:]
        else:
            (x, r, p), rest = c[:3], c[3:]
            z = r
        return (x, r, z, p) + tuple(rest)

    def inner(x, r, z, p, rz, rr, broken, k, status, iters, trace):
        """Pure batched recurrence: frozen columns stop updating via
        masks; exits when any active column claims convergence (by the
        recurrence), breaks down, or the cap is reached.  Broken
        columns (exact breakdown / non-finite reduction) carry a FLAG
        and freeze with their last finite iterate — poisoning the
        recurrence scalars instead would flow inf/NaN into that
        column's x through the next iteration's updates."""

        def cond(c):
            x, r, z, p, rz, rr, broken, k, status, iters, trace = unpack(c)
            active = status == RUNNING
            claim_or_break = active & (
                (rr <= eps2) | broken | ~jnp.isfinite(rr)
            )
            return (
                jnp.any(active)
                & ~jnp.any(claim_or_break)
                & (k < maxiter)
            )

        def body(c):
            x, r, z, p, rz, rr, broken, k, status, iters, trace = unpack(c)
            active = (status == RUNNING) & ~broken
            ap = matvec(p)
            denom = coldot(ap, p)
            raw_alpha = rz / denom
            now_broken = active & (
                ~jnp.isfinite(denom)
                | ~jnp.isfinite(raw_alpha)
                | ((denom == 0) & (rr > eps2))
            )
            upd = active & ~now_broken
            alpha = jnp.where(upd, raw_alpha, 0.0)
            x = x + cb(alpha) * p
            r_new = jnp.where(cb(upd), r - cb(alpha) * ap, r)
            new_rr = jnp.where(upd, coldot(r_new, r_new), rr)
            if has_z:
                z_new = jnp.where(cb(upd), mapply(r_new), z)
                new_rz = jnp.where(upd, coldot(r_new, z_new), rz)
            else:
                z_new, new_rz = r_new, new_rr
            beta = jnp.where(
                upd, new_rz / jnp.where(rz == 0, 1.0, rz), 0.0
            )
            p = jnp.where(
                cb(upd), z_new + cb(beta) * p, p
            )
            iters = jnp.where(upd, k + 1, iters)
            if trace is not None:
                trace = trace.at[k + 1].set(
                    jnp.where(upd, jnp.sqrt(new_rr), jnp.nan)
                )
            return pack(
                x, r_new, z_new, p,
                jnp.where(upd, new_rz, rz),
                new_rr, broken | now_broken, k + 1, status, iters, trace,
            )

        out = jax.lax.while_loop(
            cond, body,
            pack(x, r, z, p, rz, rr, broken, k, status, iters, trace),
        )
        return unpack(out)

    def outer_cond(c):
        x, r, z, p, rz, rr, k, status, iters, floor_rr, trace = unpack(c)
        return jnp.any(status == RUNNING) & (k < maxiter)

    def outer_body(c):
        x, r, z, p, rz, rr, k, status, iters, floor_rr, trace = unpack(c)
        broken0 = jnp.zeros((m,), bool)
        x, r, z, p, rz, rr, broken, k, status, iters, trace = inner(
            x, r, z, p, rz, rr, broken0, k, status, iters, trace
        )
        active = status == RUNNING
        broken = active & (broken | ~jnp.isfinite(rr))
        claimed = active & (rr <= eps2) & ~broken

        # ONE panel true-residual serves every verdict of this round
        r_t = bT - matvec(x)
        t_rr = coldot(r_t, r_t)
        verified = claimed & (t_rr <= eps2)
        refuted = claimed & ~verified
        stalled = refuted & (t_rr > floor_rr * 0.25)
        floor_rr = jnp.where(refuted, t_rr, floor_rr)

        status = jnp.where(
            broken,
            SolverStatus.DIVERGED,
            jnp.where(
                verified,
                SolverStatus.SUCCESS,
                jnp.where(
                    stalled | (active & (k >= maxiter)),
                    SolverStatus.MAX_ITERATIONS_REACHED,
                    status,
                ),
            ),
        ).astype(jnp.int32)
        # restart refuted columns from the TRUE residual; finished
        # columns freeze their r at it so residual_norm is honest
        reset_m = refuted | verified | stalled | broken
        reset = cb(reset_m)
        r = jnp.where(reset, r_t, r)
        z_t = mapply(r_t) if has_z else r_t
        z = jnp.where(reset, z_t, z)
        p = jnp.where(cb(refuted), z_t, p)
        rz_t = coldot(r_t, z_t) if has_z else t_rr
        rz = jnp.where(refuted, rz_t, rz)
        rr = jnp.where(reset_m, t_rr, rr)
        return pack(x, r, z, p, rz, rr, k, status, iters, floor_rr, trace)

    z0 = mapply(r0) if has_z else r0
    rz0 = coldot(r0, z0) if has_z else rr0
    inf0 = jnp.full((m,), jnp.inf, rr0.dtype)
    carry = pack(
        x0T, r0, z0, z0, rz0, rr0, jnp.int32(0), status0,
        jnp.zeros((m,), jnp.int32), inf0, trace0,
    )
    out = jax.lax.while_loop(outer_cond, outer_body, carry)
    x, r, _, _, _, rr, _, status, iters, _, trace = unpack(out)
    status = jnp.where(
        status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status
    ).astype(jnp.int32)
    # every column that exited through an outer verify round (SUCCESS /
    # floored / broken) froze its r at the TRUE residual; only cap-exit
    # columns (k >= maxiter mid-recurrence) carry a recurrence value —
    # recompute the panel once only in that case
    rr = coldot(r, r)

    def _fix(rr):
        r_t = bT - matvec(x)
        return coldot(r_t, r_t)

    rr = jax.lax.cond(
        jnp.any(status == SolverStatus.MAX_ITERATIONS_REACHED),
        _fix, lambda rr: rr, rr,
    )
    x = drop(x)  # back to the user-facing (n, m) layout
    return MultiSolveResult(
        x=x,
        status=status,
        iterations=iters,
        residual_norm=jnp.sqrt(rr),
        residual_trace=trace,
    )
