"""Conjugate Gradient Squared — transpose-free BiCG with squared residual
polynomial.

Implementation of the algorithm the reference *intends* in
``ConjugateGradientSquared`` (include/sparse_matrix_math.h:2109-2178).
The reference version does not compile when instantiated — its
``residualSquared`` is declared inside the do-block but referenced in the
while condition (h:2171-2172) — and is never exercised by any test
(test/cpp/cgsquared.cpp:21 calls ConjugateGradient instead).  Per SURVEY
§7 we reproduce the intent, not the bug: a working CGS with the
convergence check on ``||r||^2``.

Recursion (Saad, "Iterative Methods for Sparse Linear Systems" §7.4.1,
matching the reference's u/p/q/r recursion, h:2120-2126, 2131-2168):

    alpha = (r . r0) / (A p . r0)
    q     = u - alpha A p
    x    += alpha (u + q)
    r    -= alpha A (u + q)
    beta  = (r' . r0) / (r . r0)
    u     = r + beta q
    p     = u + beta (q + beta p)

Like the reference, a do-while: at least one iteration runs.  Improvements:
breakdown on vanishing (A p . r0) or (r . r0) and non-finite residuals →
DIVERGED (the reference leaves these as TODO comments, h:2134, 2153);
iteration-cap exit reports MAX_ITERATIONS_REACHED (reference bug h:2174).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.spmv import as_operator, matvec_fn
from ..ops.vector import dot
from .types import harmonize_dtypes, RUNNING, SolveResult, SolverStatus, resolve_max_iterations
from ..formats.reorder import reorder_hoisted

__all__ = ["conjugate_gradient_squared", "cgs", "cgs_core"]


@reorder_hoisted
def conjugate_gradient_squared(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve ``a @ x = b`` (a need not be symmetric)."""
    a = as_operator(a)
    n = b.shape[0]
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    eps = jnp.asarray(epsilon, dtype=b.dtype)
    from . import _stencil

    if _stencil.eligible(a):
        return _stencil.stencil_solve(
            "cgs", a, b, x0, eps, maxiter, record_residuals
        )
    return _cgs_loop(a, b, x0, eps, maxiter, record_residuals)


cgs = conjugate_gradient_squared


@partial(jax.jit, static_argnums=(4, 5))
def _cgs_loop(a, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    return cgs_core(matvec_fn(a), dot, b, x0, eps, maxiter, record)


def cgs_core(matvec, dotfn, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    """Algorithm core, parameterised over ``matvec``/``dotfn`` for reuse by
    the distributed layer (see solvers/cg.py:cg_core).

    Verified convergence: SUCCESS means the TRUE residual ``b - A x``
    passed eps (see cg_core); a refuted recurrence claim restarts the CGS
    recursion from the current x, a stalled restart stops honestly with
    MAX_ITERATIONS_REACHED."""
    dot = dotfn
    eps2 = eps * eps
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)

    r_init = b - matvec(x0)
    rr_init = dot(r_init, r_init)
    del r_init  # outer carry stays vector-free (see cg_core docstring)
    trace0 = (
        jnp.full((maxiter + 1,), jnp.nan, b.dtype)
        .at[0].set(jnp.sqrt(rr_init))
        if record
        else None
    )

    # Nested structure (see cg_core): inner pure CGS recursion
    # with scalar breakdown exit flags, outer verify/restart/floor — the
    # per-iteration verify lax.cond cost ~60 us/iter at n=2M even when
    # the branch never ran (benchmarks/profile_cg_iter2.py).
    def inner(x, r, r0, p, u, q, rr0, k_start, trace):
        def cond(c):
            rr, k, bd = c[7], c[8], c[9]
            return (
                ((rr >= eps2) | (k == k_start))
                & (k < maxiter)
                & ~bd
                & jnp.isfinite(rr)
            )

        def body(c):
            x, r, r0, p, u, q, rr0, _, k, _, trace = c
            ap = matvec(p)
            denom = dot(ap, r0)
            bd1 = jnp.abs(denom) < tiny
            alpha = jnp.where(bd1, 0, rr0 / denom)
            q = u - alpha * ap
            uq = u + q
            x = x + alpha * uq
            r = r - alpha * matvec(uq)
            new_rr0 = dot(r, r0)
            rr = dot(r, r)
            bd2 = jnp.abs(rr0) < tiny
            beta = jnp.where(bd2, 0, new_rr0 / rr0)
            u = r + beta * q
            p = u + beta * (q + beta * p)
            if trace is not None:
                trace = trace.at[k + 1].set(jnp.sqrt(rr))
            return (
                x, r, r0, p, u, q, new_rr0, rr, k + 1, bd1 | bd2, trace
            )

        return jax.lax.while_loop(
            cond, body,
            (x, r, r0, p, u, q, rr0, dot(r, r), k_start,
             jnp.bool_(False), trace),
        )

    def outer_cond(c):
        return c[3] == RUNNING

    def outer_body(c):
        x, _, k, _, floor_rr, hit, trace = c
        # every round (re)starts the CGS recursion from the true
        # residual (refuted restarts reset every vector to it anyway) —
        # the outer carry stays vector-free (see cg_core docstring)
        r_e = b - matvec(x)
        rr_e = dot(r_e, r_e)
        x, r, r0, p, u, q, rr0, rr, k, bd, trace = inner(
            x, r_e, r_e, r_e, r_e, jnp.zeros_like(r_e), rr_e, k, trace
        )
        # a convergence claim is verified even when the same iteration
        # tripped a breakdown flag (e.g. an already-converged entry:
        # r = 0 forces denom = 0 on the do-while first step) — the
        # status expression below already exempts verified exits from
        # DIVERGED, matching bicgstab_core
        claimed = rr < eps2

        r_t = b - matvec(x)
        t_rr = dot(r_t, r_t)
        verified = claimed & (t_rr <= eps2)
        refuted = claimed & ~verified
        stalled = refuted & (t_rr > floor_rr * 0.25)
        hit = hit | stalled
        floor_rr = jnp.where(refuted, t_rr, floor_rr)

        status = jnp.where(
            (bd | ~jnp.isfinite(rr)) & ~verified,
            SolverStatus.DIVERGED,
            jnp.where(
                verified,
                SolverStatus.SUCCESS,
                jnp.where(
                    stalled | (k >= maxiter),
                    SolverStatus.MAX_ITERATIONS_REACHED,
                    RUNNING,
                ),
            ),
        ).astype(jnp.int32)
        return x, t_rr, k, status, floor_rr, hit, trace

    inf = jnp.asarray(jnp.inf, rr_init.dtype)
    # do-while parity: no initial-convergence short-circuit (h:2131)
    carry = (
        x0, rr_init, jnp.int32(0), jnp.int32(RUNNING), inf,
        jnp.bool_(False), trace0,
    )
    out = jax.lax.while_loop(outer_cond, outer_body, carry)
    # the carried scalar is the true ||b - A x||^2 from the final round
    x, rr, k, status, _, hit, trace = out
    return SolveResult(
        x=x,
        status=status.astype(jnp.int32),
        iterations=k,
        residual_norm=jnp.sqrt(rr),
        residual_trace=trace,
        floor_hit=hit & (status == SolverStatus.MAX_ITERATIONS_REACHED),
    )
