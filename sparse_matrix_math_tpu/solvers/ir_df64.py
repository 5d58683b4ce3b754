"""Iterative refinement to the f64 contract at f32 iteration cost.

``cg_df64`` (solvers/df64.py) reaches the reference's 1e-8/f64 accuracy
bar (include/sparse_matrix_math.h:2316 templated over ``double``;
test/include/test_common.h:30-38) by running the ENTIRE CG recurrence in
double-word f32, at several times the per-iteration cost of plain f32
CG.  This module gets to the same bar much cheaper
with classical mixed-precision iterative refinement (Wilkinson; the
modern analysis is Carson & Higham, SIAM J. Sci. Comput. 2018):

* the OUTER loop keeps ``x`` as a double-word (hi, lo) pair and computes
  the TRUE residual ``r = b - A x`` with the double-word operator
  (~2^-47 unit roundoff — f64-quality residuals with f32 storage);
* each round solves the correction system ``A d = r / ||r||`` with a
  lean **f32** CG on the hi-rounded operator — the fast path the rest of
  the package already optimises (DIA, stencil, any preconditioner) — to
  a fixed RELATIVE reduction ``inner_rho``;
* ``x <- x (+df) ||r|| d``; convergence is judged ONLY on the
  double-word true residual.

Why this sidesteps the f32 floor: a single f32 solve stalls when its
residual reaches ~u_f32 * ||A|| * ||x|| ABSOLUTE.  The refinement rounds each solve a
freshly-scaled unit-norm system, so the inner solve only ever needs a
modest relative reduction, which f32 delivers at any outer residual
level; accumulation happens in the double-word ``x``.  Per-round
contraction is ``max(inner_rho, O(u_f32 * kappa(A)))`` and the attainable
residual is O(2^-47 * kappa) — comfortably past 1e-8 for the reference's
problem class.  The stall guard below reports the floor honestly when
``kappa`` is large enough to bite.

The whole recursion — outer refinement AND inner CG — is one jitted
nest of ``lax.while_loop``s: zero host syncs.  With a grid-stencil
operator the inner solve keeps its carries in the grid layout, lifted
and dropped once per round.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..formats.dia import DIAMatrix
from ..formats.ell import ELLMatrix
from ..ops.df32 import (
    DfDiaMatrix,
    DfEllMatrix,
    df_norm2,
    df_scale_add,
    df_sub,
)
from .df64 import DfSolveResult, _as_df_operator, _as_df_vector
from .types import RUNNING, SolverStatus, resolve_max_iterations

__all__ = ["bicgstab_ir_df64", "cg_ir_df64", "hi_operator"]


def hi_operator(a_df):
    """The f32 (hi-plane) operator of a double-word matrix — the inner
    correction solves run on this; its 2^-24 rounding is corrected by
    the outer double-word residual."""
    from ..formats.stencil import GridStencilMatrix
    from ..ops.df32 import DfGridStencil

    if isinstance(a_df, DfGridStencil):
        return GridStencilMatrix(
            coeffs=a_df.coeffs_hi, doffs=a_df.doffs, dims=a_df.dims,
            shape=a_df.shape, nnz=a_df.nnz,
        )
    if isinstance(a_df, DfDiaMatrix):
        return DIAMatrix(
            diags=a_df.diags_hi, offsets=a_df.offsets, shape=a_df.shape,
            nnz=a_df.nnz,
        )
    if isinstance(a_df, DfEllMatrix):
        return ELLMatrix(
            vals=a_df.vals_hi, cols=a_df.cols, shape=a_df.shape,
            nnz=a_df.nnz,
        )
    raise TypeError(
        f"no hi-plane operator for {type(a_df).__name__}; pass "
        "inner_matrix= explicitly"
    )


def _inner_cg(matvec, apply_, dotfn, bu, rho2, cap):
    """Lean (P)CG: reduce ``||bu - A d||`` below ``sqrt(rho2)`` (``bu``
    is unit-norm, so this is a relative reduction) or stop at ``cap``
    iterations / breakdown.  Deliberately UNVERIFIED — the outer loop
    judges convergence on the double-word true residual, so recurrence
    drift here only costs an extra refinement round, never correctness.
    ``dotfn`` is psum-reducing in the distributed layer.
    Returns (d, iterations)."""
    zero = jnp.zeros_like(bu)
    r = bu
    z = apply_(r) if apply_ is not None else r
    rz = dotfn(r, z)
    rr = dotfn(r, r)
    alive0 = (rr > rho2) & (cap > 0)

    def cond(s):
        return s[6]

    def body(s):
        d, r, p, rz, rr, k, _ = s
        ap = matvec(p)
        pap = dotfn(p, ap)
        # breakdown guard BEFORE the division: pap <= 0 (non-SPD drift or
        # f32 rounding on the last step) would fold inf/NaN into d before
        # the alive check below could fire — a zero step leaves d at the
        # last good iterate and the `pap > 0` term exits the loop
        alpha = jnp.where(pap > 0.0, rz / pap, 0.0)
        d = d + alpha * p
        r = r - alpha * ap
        z = apply_(r) if apply_ is not None else r
        rz_new = dotfn(r, z)
        rr = dotfn(r, r)
        p = z + (rz_new / rz) * p
        k = k + 1
        ok = jnp.isfinite(rr) & (pap > 0.0) & (rz_new != 0.0)
        alive = ok & (rr > rho2) & (k < cap)
        return d, r, p, rz_new, rr, k, alive

    state = (zero, r, z, rz, rr, jnp.int32(0), alive0)
    d, _, _, _, rr, k, _ = jax.lax.while_loop(cond, body, state)
    return d, k


def _inner_bicgstab(matvec, apply_, dotfn, bu, rho2, cap):
    """Lean BiCGStab for the nonsymmetric correction solves: reduce
    ``||bu - A d||`` below ``sqrt(rho2)`` or stop at ``cap`` /
    breakdown.  Preconditioning follows the reference's residual form
    (h:2233-2257): every matvec result passes through M^{-1}, and the
    reduction target is measured in the M^{-1} norm.  Unverified and
    unpolished on purpose — the outer double-word residual judges the
    result; a best-iterate (by recurrence) is kept so a late f32
    explosion inside a round cannot hand the outer loop garbage.
    Returns (d, iterations)."""
    pre = apply_ if apply_ is not None else (lambda v: v)
    tiny = jnp.asarray(jnp.finfo(bu.dtype).tiny, bu.dtype)
    zero = jnp.zeros_like(bu)
    r = pre(bu)
    r0 = r
    rr0 = dotfn(r, r0)
    rr = dotfn(r, r)
    rho2s = rho2 * rr  # relative to the M^{-1}-normed rhs
    alive0 = (rr > rho2s) & (cap > 0)

    def cond(s):
        return s[9]

    def body(s):
        d, r, p, rr0, rr, best_d, best_rr, k, _rho2s, _ = s
        ap = pre(matvec(p))
        denom = dotfn(ap, r0)
        bd1 = jnp.abs(denom) < tiny
        alpha = jnp.where(bd1, 0.0, rr0 / denom)
        sv = r - alpha * ap
        asv = pre(matvec(sv))
        asas = dotfn(asv, asv)
        bd2 = jnp.abs(asas) < tiny
        omega = jnp.where(bd2, 0.0, dotfn(asv, sv) / asas)
        d = d + alpha * p + omega * sv
        r = sv - omega * asv
        rr_new = dotfn(r, r)
        new_rr0 = dotfn(r, r0)
        bd3 = (jnp.abs(rr0) < tiny) | (jnp.abs(omega) < tiny)
        beta = jnp.where(
            bd3, 0.0, (new_rr0 * alpha) / (rr0 * omega)
        )
        p = r + beta * (p - omega * ap)
        k = k + 1
        better = rr_new < best_rr
        best_d = jnp.where(better, d, best_d)
        best_rr = jnp.where(better, rr_new, best_rr)
        ok = jnp.isfinite(rr_new) & ~(bd1 | bd2 | bd3)
        alive = ok & (rr_new > _rho2s) & (k < cap)
        return d, r, p, new_rr0, rr_new, best_d, best_rr, k, _rho2s, alive

    state = (
        zero, r, r, rr0, rr, zero, rr, jnp.int32(0), rho2s, alive0
    )
    out = jax.lax.while_loop(cond, body, state)
    _, _, _, _, _, best_d, _, k, _, _ = out
    return best_d, k


_INNER = {"cg": _inner_cg, "bicgstab": _inner_bicgstab}


@partial(
    jax.jit,
    static_argnames=("maxiter", "max_outer", "pre_kind", "inner_kind",
                     "round_cap"),
)
def _ir_jit(
    a_df, a_in, pre, b, x0, eps2, rho2,
    maxiter: int, max_outer: int, pre_kind: str,
    inner_kind: str = "cg",
    round_cap: int = 0,
):
    from ..formats.stencil import GridStencilMatrix

    df_mv = a_df.rmult_df
    if isinstance(a_in, GridStencilMatrix) and pre_kind in ("none", "jacobi"):
        # grid-resident inner: matrix-free stencil apply with the inner
        # carries kept in the grid layout (solvers/_stencil.py twin).
        # Object preconditioners apply to FLAT vectors, so they stay on
        # the generic path below.
        matvec = a_in.apply_grid
        lift, drop = a_in.to_grid, a_in.from_grid
    else:
        from ..ops.spmv import matvec_fn

        matvec = matvec_fn(a_in)
        lift = drop = lambda v: v  # noqa: E731

    if pre_kind == "jacobi":
        invp = lift(pre)
        apply_ = lambda r: r * invp  # noqa: E731
    elif pre_kind == "obj":
        # pin the apply output to the inner f32 domain: preconditioner
        # objects built from f64 host data promote under x64, which
        # would widen the inner while_loop carry
        apply_ = lambda r: pre.apply(r).astype(r.dtype)  # noqa: E731
    else:
        apply_ = None

    def true_residual(x):
        r = df_sub(b, df_mv(x))
        return r, df_norm2(r)[0]

    return ir_df_core(
        true_residual, matvec, apply_, lambda u, v: jnp.sum(u * v),
        lift, drop, b, x0, eps2, rho2, maxiter, max_outer, inner_kind,
        round_cap,
    )


def ir_df_core(
    true_residual, matvec, apply_, dotfn, lift, drop,
    b, x0, eps2, rho2, maxiter: int, max_outer: int, inner_kind: str,
    round_cap: int = 0,
):
    """Refinement outer loop, parameterised over the closures so the
    distributed layer (parallel/dist_df64.py) runs the identical loop
    inside ``shard_map``: ``true_residual(x_df) -> (r_df, ||r||^2 hi)``
    with a double-word (halo-exchanged, tree-combined) SpMV/norm,
    ``matvec``/``apply_``/``dotfn`` the f32 inner machinery (psum dots
    when sharded), ``lift``/``drop`` the inner-domain layout hops
    (grid layout for stencils, identity otherwise).

    ``round_cap`` (0 = no cap) bounds the inner iterations per
    refinement round: frequent true-residual corrections bound how far
    an f32 inner recurrence can drift before it is checked — at n=2M an
    UNCAPPED inner BiCGStab explodes to a 1e15 recurrence inside one
    round on the convection-diffusion bench system; capped at
    256 the same solve converges.  Costs one double-word SpMV per cap
    hit (~3 f32 SpMVs, ~1% at cap 256).

    Returns (x_hi, x_lo, rn2, total_inner, outer_rounds, status)."""
    cap = jnp.int32(round_cap if round_cap and round_cap > 0 else maxiter)
    r0, rn2_0 = true_residual(x0)
    status0 = jnp.where(
        rn2_0 <= eps2,
        SolverStatus.SUCCESS,
        jnp.where(
            maxiter == 0, SolverStatus.MAX_ITERATIONS_REACHED, RUNNING
        ),
    ).astype(jnp.int32)

    def cond(s):
        return s[7] == RUNNING

    def body(s):
        x_hi, x_lo, r_hi, _r_lo, rn2, total, outer, _ = s
        rn = jnp.sqrt(rn2)
        bu = lift(r_hi / rn)
        d_l, k_in = _INNER[inner_kind](
            matvec, apply_, dotfn, bu, rho2,
            jnp.minimum(maxiter - total, cap),
        )
        d = drop(d_l)
        nx_hi, nx_lo = df_scale_add(
            (x_hi, x_lo), (rn, jnp.zeros_like(rn)),
            (d, jnp.zeros_like(d)),
        )
        r, rn2_new = true_residual((nx_hi, nx_lo))
        total = total + k_in
        outer = outer + 1
        # a round that made the TRUE residual worse (an f32 inner
        # breakdown slipping past its own recurrence guards) is
        # REVERTED: the returned iterate is always the best seen, never
        # a corrupted tail (an exploded inner round used to
        # hand back x with ||b-Ax|| ~ 1e15)
        worse = ~(rn2_new <= rn2) | ~jnp.isfinite(rn2_new)
        x_hi = jnp.where(worse, x_hi, nx_hi)
        x_lo = jnp.where(worse, x_lo, nx_lo)
        r_hi = jnp.where(worse, r_hi, r[0])
        r_lo = jnp.where(worse, _r_lo, r[1])
        rn2_new = jnp.where(worse, rn2, rn2_new)
        # stall: a round that fails to shrink ||r||^2 by 4x (||r|| by 2x)
        # means the refinement hit its precision floor — report the floor
        # rather than looping (the same contract as cg_core's restart
        # guard, solvers/cg.py).  Rounds cut short by the round cap are
        # exempt: they did not get their full budget.
        capped_round = k_in >= cap
        status = jnp.where(
            rn2_new <= eps2,
            SolverStatus.SUCCESS,
            jnp.where(
                ~jnp.isfinite(rn2_new),
                SolverStatus.DIVERGED,
                jnp.where(
                    worse
                    | ((rn2_new > 0.25 * rn2) & ~capped_round)
                    | (total >= maxiter)
                    | (outer >= max_outer),
                    SolverStatus.MAX_ITERATIONS_REACHED,
                    RUNNING,
                ),
            ),
        ).astype(jnp.int32)
        return x_hi, x_lo, r_hi, r_lo, rn2_new, total, outer, status

    state = (
        x0[0], x0[1], r0[0], r0[1], rn2_0, jnp.int32(0), jnp.int32(0),
        status0,
    )
    x_hi, x_lo, _, _, rn2, total, outer, status = jax.lax.while_loop(
        cond, body, state
    )
    return x_hi, x_lo, rn2, total, outer, status


def _ir_front(
    inner_kind, a, b, x0, max_iterations, epsilon,
    preconditioner, inner_rho, max_outer, inner_matrix,
    round_cap=None,
) -> DfSolveResult:
    """Shared refinement front door (see cg_ir_df64 for the parameter
    contract); ``inner_kind`` picks the correction solver."""
    a_df = _as_df_operator(a)
    b = _as_df_vector(b)
    n = b[0].shape[0]
    x0 = (
        (jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32))
        if x0 is None
        else _as_df_vector(x0)
    )
    maxiter = resolve_max_iterations(max_iterations, n)
    eps2 = jnp.float32(float(epsilon) ** 2)
    if not float(epsilon) ** 2 > 0.0 or float(epsilon) < 2e-19:
        raise ValueError(
            "epsilon must satisfy eps^2 > f32 tiny (eps >= ~2e-19); "
            f"got {epsilon!r}"
        )
    rho2 = jnp.float32(float(inner_rho) ** 2)

    a_in = inner_matrix if inner_matrix is not None else hi_operator(a_df)

    pre, pre_kind = None, "none"
    if preconditioner is not None:
        from ..precond.preconditioners import JacobiPreconditioner

        if isinstance(preconditioner, JacobiPreconditioner):
            pre, pre_kind = preconditioner.inv_diag, "jacobi"
        elif hasattr(preconditioner, "apply"):
            pre, pre_kind = preconditioner, "obj"
        else:
            raise TypeError(
                "preconditioner must expose apply(r) -> z; got "
                f"{type(preconditioner).__name__}"
            )

    # per-round inner budget: uncapped for CG (its recurrence is stable
    # at scale); 256 for BiCGStab, whose f32 recurrence can explode
    # inside a long round (see ir_df_core)
    if round_cap is None:
        round_cap = 0 if inner_kind == "cg" else 256

    out = _ir_jit(
        a_df, a_in, pre, b, x0, eps2, rho2,
        maxiter, int(max_outer), pre_kind, inner_kind, int(round_cap),
    )
    x_hi, x_lo, rn2, total, outer, status = out
    return DfSolveResult(
        x_hi=x_hi, x_lo=x_lo, status=status,
        iterations=total, residual_norm2=rn2, outer_rounds=outer,
    )


def cg_ir_df64(
    a,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    preconditioner=None,
    inner_rho: float = 1e-2,
    max_outer: int = 60,
    inner_matrix=None,
    round_cap: int = None,
) -> DfSolveResult:
    """Solve ``a @ x = b`` (SPD ``a``) to f64 accuracy at ~f32 cost.

    Same operator/vector conventions and accuracy bar as
    :func:`~sparse_matrix_math_tpu.cg_df64` (the reference's templated-
    double contract, include/sparse_matrix_math.h:2316 + 1e-8 tolerances
    test/include/test_common.h:30-38), but the per-iteration work is a
    plain f32 CG step: only the once-per-round true residual runs in
    double-word arithmetic.

    Args:
      a: ``DfDiaMatrix`` / ``DfEllMatrix`` (keeps the operator's f64
        values — build via ``io.load_matrix_df`` or
        ``df_operator_from_host_csr``) or a ``CSRMatrix`` (operator
        rounded to f32; the refinement still runs double-word).
      b: host float64 array (split exactly), an (hi, lo) pair, or any
        array-like (zero lo word).
      x0: optional initial guess, same conventions as ``b``.
      max_iterations: cap on the TOTAL inner CG iterations; -1 means n
        (reference convention, h:2345-2347).  The outer rounds add one
        double-word SpMV each on top.
      epsilon: L2 threshold on the double-word TRUE residual
        ``||b - A x||``.
      preconditioner: inner-solve preconditioner — a
        ``JacobiPreconditioner`` (applied in the grid layout for
        stencils) or any object with ``apply(r) -> z`` (e.g.
        ``PoissonMultigrid``, a DIA-built ``SGSPreconditioner``).
      inner_rho: relative residual reduction each inner solve targets
        (default 1e-2).  Smaller = fewer outer rounds (fewer double-word
        SpMVs), larger = fresher rescaling; anything in [1e-4, 0.5]
        converges, the default is measured-good on the bench systems.
      max_outer: cap on refinement rounds (a safety net; the stall guard
        normally fires first).
      inner_matrix: override the inner-solve operator (default: the hi
        planes of ``a`` as a DIA/ELL matrix).  Pass a bf16-valued
        operator to trade inner accuracy for speed — the outer
        loop corrects any inner operator within O(1/kappa).
    """
    return _ir_front(
        "cg", a, b, x0, max_iterations, epsilon,
        preconditioner, inner_rho, max_outer, inner_matrix, round_cap,
    )


def bicgstab_ir_df64(
    a,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    preconditioner=None,
    inner_rho: float = 1e-2,
    max_outer: int = 60,
    inner_matrix=None,
    round_cap: int = None,
) -> DfSolveResult:
    """Solve ``a @ x = b`` (general square ``a``) to f64 accuracy at
    ~f32 cost: the nonsymmetric counterpart of :func:`cg_ir_df64`,
    refining f32 BiCGStab correction solves with the double-word true
    residual.  Same parameters and contract as :func:`cg_ir_df64`;
    matches the reference's double-templated BiCGStab at 1e-8
    (include/sparse_matrix_math.h:2191-2303 + test tolerances
    test_common.h:30-38) much cheaper than :func:`bicgstab_df64`.

    The inner BiCGStab applies ``preconditioner`` in the reference's
    residual form (M^{-1} after every matvec, h:2233-2257) and keeps a
    best-iterate so a late f32 breakdown inside a round degrades to a
    shorter round, not a corrupted update.  Unpreconditioned f32
    BiCGStab is unstable on hard systems (the reference records the
    same on sherman1, test/cpp/bicgstab.cpp:68) — pair with SGS there,
    as the reference does.
    """
    return _ir_front(
        "bicgstab", a, b, x0, max_iterations, epsilon,
        preconditioner, inner_rho, max_outer, inner_matrix, round_cap,
    )
