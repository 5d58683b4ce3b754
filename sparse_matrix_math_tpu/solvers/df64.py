"""Conjugate Gradient in emulated double precision (double-word f32).

The reference solves in ``double`` end-to-end
(include/sparse_matrix_math.h:2316-2398) with a 1e-8 accuracy contract
(test/include/test_common.h:30-38).  This module runs the ENTIRE CG
recurrence — operator, vectors, dots, scalar recurrences — in
double-word f32 arithmetic (ops/df32.py, ~2^-47 unit roundoff),
reaching the reference's f64 iteration counts and residual levels with
f32 storage.

Cost model: ~40 flops per nnz for the SpMV and ~60 per vector element
for the recurrences, all fused by XLA into a handful of bandwidth-bound
kernels.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.df32 import (
    DfDiaMatrix,
    DfEllMatrix,
    df_div,
    df_from_host,
    df_mul,
    df_norm2,
    df_operator_from_host_csr,
    df_scale_add,
    df_sub,
    df_to_host,
)
from .types import RUNNING, SolverStatus, resolve_max_iterations

__all__ = ["DfSolveResult", "bicgstab_df64", "cg_df64"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DfSolveResult:
    """Result of a double-word solve; ``x_hi + x_lo`` is the f64-quality
    solution (:meth:`x_f64` recombines on the host)."""

    x_hi: jnp.ndarray
    x_lo: jnp.ndarray
    status: jnp.ndarray          # int32 scalar: SolverStatus value
    iterations: jnp.ndarray      # int32 scalar
    residual_norm2: jnp.ndarray  # final ||r||^2 hi word (f32)
    # refinement rounds when produced by cg_ir_df64 (each costs one
    # double-word SpMV on top of ``iterations`` inner f32 steps)
    outer_rounds: Optional[jnp.ndarray] = None

    @property
    def x(self) -> jnp.ndarray:
        return self.x_hi

    def x_f64(self) -> np.ndarray:
        return df_to_host((self.x_hi, self.x_lo))

    def status_enum(self) -> SolverStatus:
        return SolverStatus(int(self.status))

    @property
    def success(self) -> bool:
        return int(self.status) == SolverStatus.SUCCESS

    def __repr__(self) -> str:
        try:
            return (
                f"DfSolveResult(status={self.status_enum().name}, "
                f"iterations={int(self.iterations)}, "
                f"residual_norm={float(self.residual_norm2) ** 0.5:.3e})"
            )
        except Exception:
            return (
                f"DfSolveResult(status={self.status!r}, "
                f"iterations={self.iterations!r})"
            )


def _as_df_operator(a):
    from ..ops.df32 import DfGridStencil

    if isinstance(a, (DfEllMatrix, DfDiaMatrix, DfGridStencil)):
        return a
    from ..formats.stencil import GridStencilMatrix

    if isinstance(a, GridStencilMatrix):
        # f32 coefficients -> zero lo planes (same convention as the
        # CSR path below); build from host f64 coeffs via
        # DfGridStencil.from_stencil for full f64 parity
        return DfGridStencil.from_stencil(a)
    from ..formats.csr import CSRMatrix

    if isinstance(a, CSRMatrix):
        # NOTE: device CSR values are usually f32, so the lo planes are
        # zero — operator accuracy is f32; the recurrence still runs
        # double-word.  Load via io.load_matrix_df (or
        # df_operator_from_host_csr with host f64 data) for full parity.
        return df_operator_from_host_csr(
            np.asarray(a.data, dtype=np.float64),
            np.asarray(a.indices, dtype=np.int64),
            np.asarray(a.indptr, dtype=np.int64),
            a.shape,
        )
    raise TypeError(
        "cg_df64 needs a DfDiaMatrix/DfEllMatrix (io.load_matrix_df / "
        "df_operator_from_host_csr for full f64 data) or a CSRMatrix "
        f"(f32-accurate operator); got {type(a).__name__}"
    )


def _as_df_vector(b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    if isinstance(b, tuple) and len(b) == 2:
        return jnp.asarray(b[0]), jnp.asarray(b[1])
    if isinstance(b, np.ndarray) and b.dtype == np.float64:
        return df_from_host(b)
    b = jnp.asarray(b, jnp.float32)
    return b, jnp.zeros_like(b)


@partial(jax.jit, static_argnames=("maxiter",))
def _cg_df_core(a: DfEllMatrix, b, x0, maxiter: int, eps2):
    """Double-word CG while_loop (same recurrence structure as
    solvers/cg.py:cg_core, every quantity an (hi, lo) pair)."""
    from ..ops.df32 import df_dot

    mv = a.rmult_df
    r = df_sub(b, mv(x0))
    rr = df_norm2(r)
    p = r

    def cond(s):
        return s[6] == RUNNING

    def body(s):
        x, r, p, rr, _, k, _ = s
        ap = mv(p)
        pap = df_dot(p, ap)
        alpha = df_div(rr, pap)
        x = df_scale_add(x, alpha, p)
        r = df_scale_add(r, (-alpha[0], -alpha[1]), ap)
        rr_new = df_norm2(r)
        beta = df_div(rr_new, rr)
        p = df_scale_add(r, beta, p)  # p = r + beta p
        k = k + 1
        finite = jnp.isfinite(rr_new[0]) & jnp.isfinite(pap[0]) & (
            pap[0] != 0.0
        )
        status = jnp.where(
            rr_new[0] <= eps2,
            SolverStatus.SUCCESS,
            jnp.where(
                ~finite,
                SolverStatus.DIVERGED,
                jnp.where(
                    k >= maxiter,
                    SolverStatus.MAX_ITERATIONS_REACHED,
                    RUNNING,
                ),
            ),
        ).astype(jnp.int32)
        return x, r, p, rr_new, pap, k, status

    status0 = jnp.where(
        rr[0] <= eps2, SolverStatus.SUCCESS,
        jnp.where(maxiter == 0, SolverStatus.MAX_ITERATIONS_REACHED, RUNNING),
    ).astype(jnp.int32)
    state = (x0, r, p, rr, rr, jnp.int32(0), status0)
    x, r, p, rr, _, k, status = jax.lax.while_loop(cond, body, state)
    return x, rr, k, status


@partial(jax.jit, static_argnames=("maxiter",))
def _bicgstab_df_core(a, b, x0, maxiter: int, eps2):
    """Double-word BiCGStab while_loop (same recurrence structure as
    solvers/bicgstab.py:bicgstab_core, unpreconditioned, every quantity
    an (hi, lo) pair).

    At ~2^-47 unit roundoff the recurrence residual does not drift
    measurably from b - A x over any practical iteration count, so no
    mid-loop verification/restart machinery is needed; the exit still
    recomputes the true residual once (one extra SpMV) and the reported
    norm/status are based on it — the same contract as the f32 cores.
    """
    from ..ops.df32 import df_dot

    mv = a.rmult_df
    tiny = jnp.float32(np.finfo(np.float32).tiny)

    r = df_sub(b, mv(x0))
    r0 = r
    rr0 = df_dot(r, r0)
    rr = df_norm2(r)

    def cond(s):
        return s[5] == RUNNING

    def body(s):
        x, r, p, rr0, _, _, k = s
        ap = mv(p)
        denom = df_dot(ap, r0)
        bd1 = jnp.abs(denom[0]) < tiny
        alpha = df_div(rr0, denom)
        sv = df_scale_add(r, (-alpha[0], -alpha[1]), ap)
        asv = mv(sv)
        asas = df_norm2(asv)
        bd2 = jnp.abs(asas[0]) < tiny
        omega = df_div(df_dot(asv, sv), asas)
        x = df_scale_add(x, alpha, p)
        x = df_scale_add(x, omega, sv)
        r = df_scale_add(sv, (-omega[0], -omega[1]), asv)
        rr_new = df_norm2(r)
        new_rr0 = df_dot(r, r0)
        bd3 = (jnp.abs(rr0[0]) < tiny) | (jnp.abs(omega[0]) < tiny)
        beta = df_div(df_mul(new_rr0, alpha), df_mul(rr0, omega))
        t = df_scale_add(p, (-omega[0], -omega[1]), ap)
        p = df_scale_add(r, beta, t)
        k = k + 1
        finite = jnp.isfinite(rr_new[0])
        status = jnp.where(
            rr_new[0] <= eps2,
            SolverStatus.SUCCESS,
            jnp.where(
                (bd1 | bd2 | bd3) | ~finite,
                SolverStatus.DIVERGED,
                jnp.where(
                    k >= maxiter,
                    SolverStatus.MAX_ITERATIONS_REACHED,
                    RUNNING,
                ),
            ),
        ).astype(jnp.int32)
        return x, r, p, new_rr0, rr_new, status, k

    status0 = jnp.where(
        rr[0] <= eps2, SolverStatus.SUCCESS,
        jnp.where(maxiter == 0, SolverStatus.MAX_ITERATIONS_REACHED, RUNNING),
    ).astype(jnp.int32)
    state = (x0, r, r, rr0, rr, status0, jnp.int32(0))
    x, r, p, _, rr, status, k = jax.lax.while_loop(cond, body, state)
    # exit-time true residual (one SpMV): reported norm and SUCCESS are
    # based on b - A x, not the recurrence
    r_true = df_sub(b, mv(x))
    rr_true = df_norm2(r_true)
    status = jnp.where(
        (status == SolverStatus.SUCCESS) & (rr_true[0] > eps2),
        SolverStatus.MAX_ITERATIONS_REACHED,
        status,
    ).astype(jnp.int32)
    return x, rr_true, k, status


def bicgstab_df64(
    a,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
) -> DfSolveResult:
    """Solve ``a @ x = b`` (general square ``a``) in emulated f64.

    The nonsymmetric counterpart of :func:`cg_df64`: the reference runs
    BiCGStab in double at 1e-8 (h:2191-2303 + test tolerances
    test_common.h:30-38); this reaches that bar through double-word f32
    arithmetic.  Same operator conventions as
    :func:`cg_df64`; breakdown divisions are guarded → DIVERGED
    (completing the reference's TODOs h:2260/2270 at f64 precision).
    """
    a = _as_df_operator(a)
    b = _as_df_vector(b)
    n = b[0].shape[0]
    x0 = (
        (jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32))
        if x0 is None
        else _as_df_vector(x0)
    )
    maxiter = resolve_max_iterations(max_iterations, n)
    eps2 = jnp.float32(float(epsilon) ** 2)
    x, rr, k, status = _bicgstab_df_core(a, b, x0, maxiter, eps2)
    return DfSolveResult(
        x_hi=x[0], x_lo=x[1], status=status, iterations=k,
        residual_norm2=rr[0],
    )


def cg_df64(
    a,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
) -> DfSolveResult:
    """Solve ``a @ x = b`` for SPD ``a`` in emulated f64 on the device.

    Args:
      a: :class:`~sparse_matrix_math_tpu.ops.df32.DfEllMatrix` (build
        via ``io.load_matrix_df`` or ``DfEllMatrix.from_host_csr`` to
        keep the operator's f64 values), or a CSRMatrix (operator
        rounded to f32; the RECURRENCE still runs double-word).
      b: host float64 array (split exactly), an (hi, lo) pair, or any
        array-like (promoted with a zero lo word).
      x0: optional initial guess, same conventions as ``b``.
      max_iterations: -1 means n (reference convention, h:2345-2347).
      epsilon: L2 residual threshold — the reference's f64 1e-8 bar is
        reachable with f32 storage through this path.
    """
    a = _as_df_operator(a)
    b = _as_df_vector(b)
    n = b[0].shape[0]
    x0 = (
        (jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32))
        if x0 is None
        else _as_df_vector(x0)
    )
    maxiter = resolve_max_iterations(max_iterations, n)
    eps2 = jnp.float32(float(epsilon) ** 2)
    x, rr, k, status = _cg_df_core(a, b, x0, maxiter, eps2)
    return DfSolveResult(
        x_hi=x[0], x_lo=x[1], status=status, iterations=k,
        residual_norm2=rr[0],
    )
