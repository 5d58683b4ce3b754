"""BiCG specialisation for symmetric matrices.

Re-design of the reference ``BiCGSymmetric``
(include/sparse_matrix_math.h:2021-2102).  For SPD systems it produces
the same iterates as CG (reference README.md:27-28); it exists because —
unlike CG — it carries the reference's explicit breakdown heuristics for
indefinite matrices:

* serious breakdown: ``|Ap . p| < eps`` while ``||r||^2 > 1`` → DIVERGED
  (h:2047-2058; near a *lucky* breakdown the residual must be small, so
  a large residual with a vanishing denominator means indefiniteness).
* critical BiCG breakdown: ``||r'||^2 > 1`` after ``||r||^2 < eps`` →
  DIVERGED (h:2073-2081).

Like the reference, this is a do-while: at least one iteration always
runs (no initial-convergence short-circuit, h:2047).  Deviation (SURVEY
§7 known defects): the reference returns SUCCESS when stopped by the
iteration cap because its ``iterations > maxIterations`` check can never
fire (h:2098); we report MAX_ITERATIONS_REACHED correctly.
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

__all__ = ["bicg_symmetric", "bicg_symmetric_core"]


@reorder_hoisted
def bicg_symmetric(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve ``a @ x = b`` for symmetric ``a`` (x0 is the in/out initial
    guess in the reference; here it's a separate input)."""
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
            "bicg_symmetric", a, b, x0, eps, maxiter, record_residuals
        )
    return _bicg_sym_loop(a, b, x0, eps, maxiter, record_residuals)


@partial(jax.jit, static_argnums=(4, 5))
def _bicg_sym_loop(a, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    return bicg_symmetric_core(matvec_fn(a), dot, b, x0, eps, maxiter, record)


def bicg_symmetric_core(
    matvec, dotfn, b, x0, eps, maxiter: int, record: bool
) -> SolveResult:
    """Algorithm core, parameterised over ``matvec``/``dotfn`` for reuse by
    the distributed layer (see solvers/cg.py:cg_core).

    Verified convergence: SUCCESS means the TRUE residual ``b - A x``
    passed eps (see cg_core for the full contract); a refuted recurrence
    claim restarts from the true residual, stalling twice in a row stops
    with MAX_ITERATIONS_REACHED at the precision floor.

    Nested structure (see cg_core): the inner while_loop is the
    pure recurrence with the reference's scalar breakdown heuristics
    (h:2047-2081) as exit flags; the outer loop verifies claims — the
    per-iteration verify ``lax.cond`` cost ~60 us/iter at n=2M even when
    the branch never ran (benchmarks/profile_cg_iter2.py)."""
    dot = dotfn
    eps2 = eps * eps
    one = jnp.asarray(1.0, b.dtype)

    r0_vec = b - matvec(x0)
    rr0 = dot(r0_vec, r0_vec)
    del r0_vec  # outer carry stays vector-free (see cg_core docstring)
    trace0 = (
        jnp.full((maxiter + 1,), jnp.nan, b.dtype).at[0].set(jnp.sqrt(rr0))
        if record
        else None
    )

    def inner(x, r, p, rr, k_start, trace):
        """Pure recurrence; exits on claim / breakdown / cap.  The first
        iteration of the whole solve is FORCED (k == 0 term) to keep the
        reference's do-while semantics (h:2047)."""

        def cond(c):
            x, r, p, rr, k, serious, critical = c
            return (
                ((rr >= eps2) | (k == 0))
                & (k < maxiter)
                & ~serious
                & ~critical
                & jnp.isfinite(rr)
            )

        def body(c):
            x, r, p, rr, k, _, _ = c
            ap = matvec(p)
            denom = dot(ap, p)
            # serious breakdown heuristic (h:2056-2058); the reference
            # exits BEFORE applying the bogus alpha update, so mask the
            # updates out.
            serious = (eps > jnp.abs(denom)) & (rr > one)
            alpha = jnp.where(serious, 0, rr / denom)
            x = x + alpha * p
            r = r - alpha * ap
            new_rr = jnp.where(serious, rr, dot(r, r))
            # critical BiCG breakdown heuristic (h:2079-2081); the
            # reference exits AFTER the x/r update here, so those stand.
            critical = (new_rr > one) & (rr < eps)
            beta = new_rr / rr
            p = r + beta * p
            return x, r, p, new_rr, k + 1, serious, critical

        if trace is None:
            out = jax.lax.while_loop(
                cond,
                body,
                (x, r, p, rr, k_start, jnp.bool_(False), jnp.bool_(False)),
            )
            return out + (trace,)

        # traced variant carries the trace array through the same loop
        def cond_t(c):
            return cond(c[:-1])

        def body_t(c):
            x, r, p, rr, k, serious, critical = body(c[:-1])
            tr = c[-1].at[k].set(jnp.sqrt(rr))
            return x, r, p, rr, k, serious, critical, tr

        out = jax.lax.while_loop(
            cond_t,
            body_t,
            (x, r, p, rr, k_start, jnp.bool_(False), jnp.bool_(False),
             trace),
        )
        return out

    def outer_cond(c):
        return c[4] == RUNNING

    def outer_body(c):
        x, _, k, floor_rr, _, hit, trace = c
        r_e = b - matvec(x)
        rr_e = dot(r_e, r_e)
        x, r, p, rr, k, serious, critical, trace = inner(
            x, r_e, r_e, rr_e, k, trace
        )
        claimed = (rr < eps2) & ~serious & ~critical

        r_t = b - matvec(x)
        t_rr = dot(r_t, r_t)
        verified = claimed & (t_rr <= eps2)
        refuted = claimed & ~verified
        stalled = refuted & (t_rr > floor_rr * 0.25)
        hit = hit | stalled
        floor_rr = jnp.where(refuted, t_rr, floor_rr)

        diverged = serious | critical | ~jnp.isfinite(rr)
        status = jnp.where(
            diverged,
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
        return x, t_rr, k, floor_rr, status, hit, trace

    inf = jnp.asarray(jnp.inf, rr0.dtype)
    # no initial-convergence short-circuit: do-while parity (h:2047)
    carry = (
        x0, rr0, jnp.int32(0), inf, jnp.int32(RUNNING),
        jnp.bool_(False), trace0,
    )
    x, rr, k, _, status, hit, trace = jax.lax.while_loop(
        outer_cond, outer_body, carry
    )
    return SolveResult(
        x=x,
        status=status.astype(jnp.int32),
        iterations=k,
        residual_norm=jnp.sqrt(rr),
        residual_trace=trace,
        floor_hit=hit & (status == SolverStatus.MAX_ITERATIONS_REACHED),
    )
