"""Mixed-precision CG: low-precision matrix stream, f32 vectors, true-residual IR.

A capability with no reference analogue (the reference is float/double
templated CPU code, include/sparse_matrix_math.h:2316-2398).  The DIA
SpMV is bound by memory bandwidth and the diagonal planes are most of
its traffic, so storing the MATRIX in bfloat16 while every solver
vector, dot, and axpy stays float32 cuts the dominant stream in half.

Accuracy contract (what makes this honest for general values):

* The inner CG runs on the bf16-rounded operator ``Ã``.  When the
  matrix values are exactly representable in bfloat16 (all small-integer
  stencils: Poisson, graph Laplacians, ...), ``Ã == A`` bit-for-bit —
  the multiplies widen bf16 to f32 — and the inner solve IS the f32
  solve.
* For general values, plain CG on ``Ã`` would stall at the ~2^-8
  relative perturbation floor.  So the outer loop is classical iterative
  refinement: after each inner solve the residual is recomputed with the
  FULL-PRECISION operator, convergence is judged ONLY on that true f32
  residual, and the next inner solve targets the remaining error.  The
  reported ``residual_norm``/``status`` therefore mean exactly what they
  mean everywhere else in this package.
* If an outer round fails to shrink the true residual (refinement
  stalled at the precision floor before reaching ``epsilon``), the solve
  stops and reports MAX_ITERATIONS_REACHED rather than looping.

The whole outer+inner recursion is one jitted ``while_loop`` nest: zero
host syncs.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..formats.dia import DIAMatrix
from .types import RUNNING, SolveResult, SolverStatus, resolve_max_iterations

__all__ = ["mixed_cg", "ir_core"]


def ir_core(
    matvec_hi,
    matvec_lo,
    dotfn,
    b,
    x0,
    eps,
    maxiter,
    *,
    inner_rho: float = 1.0 / 256.0,
    max_outer: int = 40,
) -> SolveResult:
    """Iterative-refinement core: outer loop in ``matvec_hi`` precision,
    inner lean-CG correction solves on ``matvec_lo``.

    ``iterations`` in the result counts INNER iterations (the SpMV-rate
    work); each outer round additionally costs TWO hi-precision SpMVs —
    the entry recompute (which keeps the outer carry vector-free, see
    cg_core) and the post-round true residual.
    """
    dot = dotfn
    eps2 = eps * eps
    rho = jnp.asarray(inner_rho, b.dtype)

    r0 = b - matvec_hi(x0)
    rr0 = dot(r0, r0)
    del r0  # outer carry stays vector-free (see cg_core docstring)
    init_status = jnp.where(rr0 < eps2, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )

    # Inner: the LEAN unverified CG from the df64 refinement
    # (ir_df64._inner_cg) — the outer loop judges convergence on the
    # full-precision residual, so the inner needs no verify machinery
    # (the round-3 structure ran the fully-verified cg_core per round,
    # whose claim/restart logic just burned iterations against the bf16
    # operator's own floor).
    from .ir_df64 import _inner_cg

    def cond(carry):
        _, _, total, outer, status = carry
        return (status == RUNNING) & (total < maxiter) & (outer < max_outer)

    def body(carry):
        x, rr, total, outer, status = carry
        # entry recompute keeps the outer carry vector-free; the rhs is
        # rescaled to unit norm so the inner needs only a RELATIVE
        # reduction (same contract as ir_df64)
        r = b - matvec_hi(x)
        rr_e = dot(r, r)
        rn = jnp.sqrt(rr_e)
        bu = r / jnp.maximum(rn, jnp.asarray(1e-30, b.dtype))
        # reduce past eps on the final round; fixed relative cut earlier
        rho_eff = jnp.maximum(rho, eps * 0.5 / jnp.maximum(rn, eps))
        d, k_in = _inner_cg(
            matvec_lo, None, dot, bu, rho_eff * rho_eff, maxiter - total
        )
        x = x + rn * d
        r2 = b - matvec_hi(x)  # TRUE residual: full-precision operator
        new_rr = dot(r2, r2)
        diverged = ~jnp.isfinite(new_rr)
        converged = new_rr < eps2
        # refinement stalled: the inner solve no longer shrinks the true
        # residual (low-precision floor above eps) — stop honestly
        stalled = ~converged & (new_rr > rr_e * 0.25)
        status = jnp.where(
            diverged,
            SolverStatus.DIVERGED,
            jnp.where(
                converged,
                SolverStatus.SUCCESS,
                jnp.where(stalled, SolverStatus.MAX_ITERATIONS_REACHED, RUNNING),
            ),
        ).astype(jnp.int32)
        return x, new_rr, total + k_in, outer + 1, status

    carry = (x0, rr0, jnp.int32(0), jnp.int32(0), init_status)
    x, rr, total, outer, status = jax.lax.while_loop(cond, body, carry)
    status = jnp.where(
        status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status
    )
    return SolveResult(
        x=x,
        status=status.astype(jnp.int32),
        iterations=total,
        residual_norm=jnp.sqrt(rr),
        residual_trace=None,
    )


def mixed_cg(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    matrix_dtype=jnp.bfloat16,
    inner_rho: float = 1.0 / 256.0,
    max_outer: int = 40,
) -> SolveResult:
    """CG with the matrix streamed in ``matrix_dtype`` (default bf16).

    ``inner_rho`` is the relative reduction per refinement round.

    ``a`` must be a DIA-format matrix (the diagonal-plane stream is
    what the lower precision halves; convert with ``try_dia_from_csr``
    first).  Vectors, reductions, and the reported residual stay in
    ``b``'s precision — see the module docstring for the accuracy
    contract.
    """
    if not isinstance(a, DIAMatrix):
        raise ValueError(
            "mixed_cg needs a DIA-format matrix (the bf16 win is the "
            "diagonal-plane stream); build one with try_dia_from_csr"
        )
    n = b.shape[0]
    if x0 is None:
        x0 = jnp.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    eps = jnp.asarray(epsilon, b.dtype)
    return _mixed_cg_jit(
        a, b, x0, eps, maxiter, jnp.dtype(matrix_dtype).name,
        float(inner_rho), int(max_outer),
    )


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _mixed_cg_jit(
    a, b, x0, eps, maxiter: int, matrix_dtype: str, inner_rho: float,
    max_outer: int,
) -> SolveResult:
    from ..ops.spmv import dia_rmult_xla

    a_lo = dataclasses.replace(a, diags=a.diags.astype(matrix_dtype))

    def dotfn(u, v):
        return jnp.sum(u * v)

    return ir_core(
        lambda v: dia_rmult_xla(a, v),
        lambda v: dia_rmult_xla(a_lo, v),
        dotfn, b, x0, eps, maxiter,
        inner_rho=inner_rho, max_outer=max_outer,
    )
