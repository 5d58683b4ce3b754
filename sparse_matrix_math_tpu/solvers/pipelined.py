"""Pipelined Conjugate Gradient — one fused reduction per iteration.

Communication-avoiding CG variant (Ghysels & Vanroose, "Hiding global
synchronization latency in the preconditioned Conjugate Gradient
algorithm", 2014 — see PAPERS.md).  Standard CG needs two dependent dot
products per iteration (two psums on a mesh); the pipelined recurrence
rearranges so both reductions — gamma = (r, r) and delta = (w, r) — are
available simultaneously and merge into ONE collective, with the SpMV
(q = A w) overlappable with the reduction.  No reference equivalent.

Trade-offs: one extra SpMV-sized vector triple (w, z, s) in the carry and
weaker rounding behavior than textbook CG (residual drift) — the
standard pipelined-CG caveat, bounded here with PERIODIC RESIDUAL
REPLACEMENT (Ghysels & Vanroose §4: every ``replace_every`` iterations
the true residual r = b - A x and the auxiliary recurrences are
recomputed from scratch inside a lax.cond — ~4 extra SpMVs per period).
On a 2M-row f32 Poisson system (kappa ~ 4e6) the recurrence without
replacement drifts to max-error ~7e+2; with
replacement the error is bounded at ~6e-2 (period 50 and period 5
alike) — replacement bounds the drift but the ATTAINABLE ACCURACY of
the pipelined recurrence in f32 remains above tight tolerances at high
condition number (the known attainable-accuracy gap of pipelined CG).
Use plain ``cg`` single-chip or for tight f32 tolerances; pipelined CG
pays on latency-bound meshes at f64 or moderate tolerances.

    r0 = b - A x0;  w0 = A r0
    loop i:
      gamma = (r, r);  delta = (w, r)        # ONE fused reduction
      q = A w                                 # overlaps the reduction
      beta  = 0 (i=0) else gamma/gamma_prev
      alpha = gamma/delta (i=0) else gamma / (delta - beta * gamma / alpha_prev)
      z = q + beta z;  s = w + beta s;  p = r + beta p
      x += alpha p;  r -= alpha s;  w -= alpha z
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

__all__ = ["cg_pipelined", "cg_pipelined_core"]


def _dot2_local(u1, v1, u2, v2):
    """Two dots, single-device: XLA fuses the reductions."""
    return dot(u1, v1), dot(u2, v2)


@reorder_hoisted
def cg_pipelined(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    record_residuals: bool = False,
    replace_every: int = 50,
) -> SolveResult:
    """Solve SPD ``a @ x = b`` with pipelined CG.  ``replace_every``:
    true-residual replacement period (0 disables)."""
    a = as_operator(a)
    n = b.shape[0]
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    eps = jnp.asarray(epsilon, dtype=b.dtype)
    return _pipelined_loop(
        a, b, x0, eps, maxiter, record_residuals, int(replace_every)
    )


@partial(jax.jit, static_argnums=(4, 5, 6))
def _pipelined_loop(
    a, b, x0, eps, maxiter: int, record: bool, replace_every: int
) -> SolveResult:
    return cg_pipelined_core(
        matvec_fn(a), _dot2_local, b, x0, eps, maxiter, record,
        replace_every=replace_every,
    )


def cg_pipelined_core(
    matvec, dot2fn, b, x0, eps, maxiter: int, record: bool,
    replace_every: int = 50,
) -> SolveResult:
    """Algorithm core; ``dot2fn(u1, v1, u2, v2) -> (d1, d2)`` computes both
    inner products — the distributed layer supplies a single-psum fused
    implementation."""
    eps2 = eps * eps
    dtype = b.dtype

    r = b - matvec(x0)
    w = matvec(r)
    gamma0, _ = dot2fn(r, r, w, r)
    trace = (
        jnp.full((maxiter + 1,), jnp.nan, dtype).at[0].set(jnp.sqrt(gamma0))
        if record
        else None
    )

    zero = jnp.zeros_like(b)
    one = jnp.asarray(1.0, dtype)

    def cond(carry):
        (_, _, _, _, _, _, _, _, k, status, _) = carry
        return (status == RUNNING) & (k < maxiter)

    def body(carry):
        x, r, w, p, s, z, gamma_prev, alpha_prev, k, status, trace = carry
        gamma, delta = dot2fn(r, r, w, r)  # ONE fused reduction
        q = matvec(w)                       # overlappable SpMV
        first = k == 0
        beta = jnp.where(first, 0.0, gamma / gamma_prev).astype(dtype)
        denom = jnp.where(
            first, delta, delta - beta * gamma / alpha_prev
        )
        alpha = (gamma / denom).astype(dtype)
        z = q + beta * z
        s = w + beta * s
        p = r + beta * p
        x = x + alpha * p
        r = r - alpha * s
        w = w - alpha * z
        if replace_every > 0:
            # periodic true-residual replacement: recompute r and the
            # auxiliary recurrences from scratch (lax.cond executes the
            # 4 extra SpMVs only on replacement steps)
            do_replace = (k + 1) % replace_every == 0

            def _replace(args):
                xx, pp, *_ = args
                r2 = b - matvec(xx)
                w2 = matvec(r2)
                s2 = matvec(pp)
                z2 = matvec(s2)
                return r2, w2, s2, z2

            def _keep(args):
                _, _, rr_, ww_, ss_, zz_ = args
                return rr_, ww_, ss_, zz_

            r, w, s, z = jax.lax.cond(
                do_replace, _replace, _keep, (x, p, r, w, s, z)
            )
        diverged = ~jnp.isfinite(gamma)
        converged = gamma < eps2  # gamma is LAST iteration's ||r||^2
        status = jnp.where(
            diverged,
            SolverStatus.DIVERGED,
            jnp.where(converged, SolverStatus.SUCCESS, RUNNING),
        ).astype(jnp.int32)
        if trace is not None:
            trace = trace.at[k + 1].set(jnp.sqrt(gamma))
        return x, r, w, p, s, z, gamma, alpha, k + 1, status, trace

    init_status = jnp.where(gamma0 < eps2, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )
    carry = (
        x0, r, w, zero, zero, zero,
        jnp.asarray(1.0, dtype), one, jnp.int32(0), init_status, trace,
    )
    x, r, _, _, _, _, _, _, k, status, trace = jax.lax.while_loop(
        cond, body, carry
    )
    status = jnp.where(status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status)
    rr, _ = dot2fn(r, r, r, r)
    return SolveResult(
        x=x,
        status=status.astype(jnp.int32),
        iterations=k,
        residual_norm=jnp.sqrt(rr),
        residual_trace=trace,
    )
