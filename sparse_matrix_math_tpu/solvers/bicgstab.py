"""BiCGStab — transpose-free stabilised BiCG, optionally preconditioned.

Re-design of the reference ``BiCGStab``
(include/sparse_matrix_math.h:2191-2283 + unpreconditioned overload
h:2294-2303).  Behavioral parity:

* unpreconditioned iteration: 2 SpMVs, ``alpha = (r.r0)/(Ap.r0)``,
  ``s = r - alpha Ap``, ``omega = (As.s)/(As.As)``, fused x/r updates
  with ||r|| accumulation (h:2262-2268),
  ``beta = (r'.r0) alpha / ((r.r0) omega)``,
  ``p = r + beta (p - omega Ap)`` (h:2271-2274).
* convergence on ``||r|| <= eps`` — the L2 norm itself, NOT squared
  (h:2277), unlike CG.  Do-while: at least one iteration runs.
* preconditioning (reference style, h:2217-2257): the *residuals* are
  preconditioned — ``r <- M^{-1}(b - A x)`` at start, and each SpMV
  result is preconditioned (``ap = M^{-1} A p``, ``as = M^{-1} A s``).
  Convergence is measured on the preconditioned residual, matching the
  reference exactly.  The reference selects this at compile time via
  ``if constexpr`` against the identity-preconditioner type (h:2209);
  here the Python-level None check plays that role (still zero cost
  inside the compiled loop).

Improvements (SURVEY §7): division-by-zero breakdowns the reference
leaves as TODOs (h:2260, 2270) are detected → DIVERGED; the
iteration-cap exit reports MAX_ITERATIONS_REACHED (reference bug h:2279).
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

__all__ = ["bicgstab", "bicgstab_core"]


@reorder_hoisted
def bicgstab(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    preconditioner=None,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve ``a @ x = b`` (a may be non-symmetric / indefinite)."""
    a = as_operator(a)
    n = b.shape[0]
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    eps = jnp.asarray(epsilon, dtype=b.dtype)
    from . import _stencil

    if _stencil.eligible(a, preconditioner):
        return _stencil.stencil_solve(
            "bicgstab", a, b, x0, eps, maxiter, record_residuals,
            preconditioner=preconditioner,
        )
    if preconditioner is None:
        return _bicgstab_loop(a, b, x0, eps, maxiter, record_residuals)
    return _bicgstab_precond_loop(
        a, preconditioner, b, x0, eps, maxiter, record_residuals
    )


@partial(jax.jit, static_argnums=(4, 5))
def _bicgstab_loop(a, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    matvec = matvec_fn(a)
    return bicgstab_core(matvec, lambda v: v, dot, b, x0, eps, maxiter, record)


@partial(jax.jit, static_argnums=(5, 6))
def _bicgstab_precond_loop(a, m, b, x0, eps, maxiter: int, record: bool):
    matvec = matvec_fn(a)
    return bicgstab_core(matvec, m.apply, dot, b, x0, eps, maxiter, record)


# Divergence cutoff: residual above this multiple of the best seen is an
# explosion, not a BiCGStab transient.  On the n=2M/SGS(4) f32 system
# legitimate mid-run spikes reach 2.3e4x the running best and recover
# (the global minimum comes 450 iterations after one); the terminal
# blow-up passes 1e6x ~80 iterations past the minimum and never
# recovers.
_EXPLOSION_FACTOR = 1e6


def bicgstab_core(matvec, precond, dotfn, b, x0, eps, maxiter: int, record: bool):
    """Algorithm core, parameterised over ``matvec``/``precond``/``dotfn``
    for reuse by the distributed layer (see solvers/cg.py:cg_core).

    Verified convergence (same contract as cg_core): SUCCESS means the
    TRUE residual ``M^{-1}(b - A x)`` — the quantity the reference's
    convergence test measures (h:2277) — passed eps, not merely the
    recurrence value.  When the recurrence claims convergence the loop
    recomputes the true residual (one extra SpMV+apply, only at claimed
    convergence); a refuted claim performs a full BiCGStab restart from
    the current x (r = r0 = p = true residual).  If a restart fails to
    shrink the true residual 2x the solve stops honestly with
    MAX_ITERATIONS_REACHED, reporting the floor.

    Best-iterate return: f32 BiCGStab can pass its precision floor and
    then EXPLODE (at n=2M/SGS(4): minimum 3.9e-4 at iteration 832,
    +inf by 1653 — the reference's unguarded recursion does the
    same, its breakdown checks are TODOs h:2260/2270).  The loop tracks
    the best recurrence iterate, cuts off when the residual exceeds
    ``_EXPLOSION_FACTOR`` x the best (DIVERGED), and on any non-SUCCESS
    exit returns the BEST x with its verified true residual — a usable
    floor instead of the exploded tail."""
    dot = dotfn
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)
    inf = jnp.asarray(jnp.inf, b.dtype)

    # r <- M^{-1}(b - A x0) (h:2215-2227); identity precond when plain.
    r_init = precond(b - matvec(x0))
    res_norm0 = jnp.sqrt(dot(r_init, r_init))
    trace0 = (
        jnp.full((maxiter + 1,), jnp.nan, b.dtype).at[0].set(res_norm0)
        if record
        else None
    )

    # Nested structure (see cg_core): the INNER while_loop is the pure
    # BiCGStab recurrence — the shape of reference h:2232-2277 with only
    # scalar breakdown guards — and exits at a claimed convergence, a
    # breakdown, an explosion, or a 64-iteration chunk boundary.  The
    # OUTER loop does the per-exit work (true-residual verify
    # h:2277-parity, best-iterate sampling, restart/floor logic) with no
    # per-iteration `lax.cond`; the every-64 true-residual sampling
    # cadence is simply the outer round boundary.
    def inner(x, r, r0, p, rr0, k_start, explode_at, trace):
        chunk_end = jnp.minimum(k_start + 64, maxiter)

        def cond(c):
            _, _, _, _, res_norm, k, bd, _ = c
            return (
                (res_norm > eps)
                & (k < chunk_end)
                & ~bd
                & (res_norm < explode_at)
            )

        def body(c):
            x, r, p, rr0, _, k, _, trace = c
            ap = precond(matvec(p))
            denom = dot(ap, r0)
            bd1 = jnp.abs(denom) < tiny
            alpha = jnp.where(bd1, 0, rr0 / denom)
            s = r - alpha * ap
            as_ = precond(matvec(s))
            asas = dot(as_, as_)
            bd2 = jnp.abs(asas) < tiny
            omega = jnp.where(bd2, 0, dot(as_, s) / asas)
            x = x + alpha * p + omega * s
            r = s - omega * as_
            new_res_norm = jnp.sqrt(dot(r, r))
            new_rr0 = dot(r, r0)
            bd3 = (jnp.abs(rr0) < tiny) | (jnp.abs(omega) < tiny)
            beta = jnp.where(bd3, 0, (new_rr0 * alpha) / (rr0 * omega))
            p = r + beta * (p - omega * ap)
            bd = bd1 | bd2 | bd3 | ~jnp.isfinite(new_res_norm)
            if trace is not None:
                trace = trace.at[k + 1].set(new_res_norm)
            return x, r, p, new_rr0, new_res_norm, k + 1, bd, trace

        # the do-while shape of the reference (at least one iteration
        # runs, h:2232) is preserved by the caller checking res_norm>eps
        # before entering
        return jax.lax.while_loop(
            cond, body,
            (x, r, p, rr0, jnp.sqrt(dot(r, r)), k_start, jnp.bool_(False),
             trace),
        )

    def outer_cond(c):
        return c[10] == RUNNING

    def outer_body(c):
        (x, r, r0, p, rr0, k, floor, hit, best_x, best_norm, _,
         trace) = c
        explode_at = best_norm * jnp.asarray(_EXPLOSION_FACTOR, b.dtype)
        x, r, p, rr0, res_norm, k, bd, trace = inner(
            x, r, r0, p, rr0, k, explode_at, trace
        )
        claimed = res_norm <= eps

        # ONE true-residual evaluation per round serves the verify, the
        # best-iterate sample, and the honest residual_norm
        r_t = precond(b - matvec(x))
        t_norm = jnp.sqrt(dot(r_t, r_t))
        verified = claimed & (t_norm <= eps)
        refuted = claimed & ~verified
        stalled = refuted & (t_norm > floor * 0.5)
        hit = hit | stalled  # latch: this exit is a precision floor
        floor = jnp.where(refuted, t_norm, floor)

        better = t_norm < best_norm
        best_x = jnp.where(better, x, best_x)
        best_norm = jnp.where(better, t_norm, best_norm)
        exploded = res_norm >= explode_at

        # a verified exit is SUCCESS even when the final recurrence step
        # also tripped a breakdown guard (e.g. an exact solve makes
        # s = 0 -> omega breakdown in the same iteration that converged)
        status = jnp.where(
            ((bd & ~refuted) | ~jnp.isfinite(res_norm) | exploded)
            & ~verified,
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
        # full restart on refutation: shadow vector and direction reset
        # to the true residual (h:2221-2227 shape); otherwise continue
        # the recursion state across the chunk boundary
        t_rr = dot(r_t, r_t)
        r = jnp.where(refuted, r_t, r)
        r0 = jnp.where(refuted, r_t, r0)
        p = jnp.where(refuted, r_t, p)
        rr0 = jnp.where(refuted, t_rr, rr0)
        return (
            x, r, r0, p, rr0, k, floor, hit, best_x, best_norm, status,
            trace,
        )

    init_status = jnp.where(
        res_norm0 <= eps, SolverStatus.SUCCESS, RUNNING
    ).astype(jnp.int32)
    rr0_init = dot(r_init, r_init)
    carry = (
        x0, r_init, r_init, r_init, rr0_init, jnp.int32(0), inf,
        jnp.bool_(False), x0, res_norm0, init_status, trace0,
    )
    (x, _, _, _, _, k, _, hit, best_x, best_norm, status, trace) = (
        jax.lax.while_loop(outer_cond, outer_body, carry)
    )

    # ALWAYS return the best iterate with its verified true residual:
    # on SUCCESS the final x was folded into best_x by the same round
    # that verified it (t_norm <= eps < previous best), and on failure
    # exits (explosion/breakdown/floor) the exploded tail's x is
    # useless — the best is the honest answer.  No extra SpMV needed.
    return SolveResult(
        x=best_x,
        status=status.astype(jnp.int32),
        iterations=k,
        residual_norm=best_norm,
        residual_trace=trace,
        floor_hit=hit & (status == SolverStatus.MAX_ITERATIONS_REACHED),
    )
