"""Preconditioners: Identity, Jacobi, Symmetric Gauss-Seidel, ILU(0), IC(0).

Re-design of the reference's nested preconditioner classes
(include/sparse_matrix_math.h:1165-1235 + impls :1653-1928).  Each is an
immutable pytree with ``apply(rhs) -> x`` solving ``M x = rhs``; they
cross ``jax.jit`` boundaries as arguments, so solver compilations cache
per preconditioner *structure*.

Parity + deliberate improvements (SURVEY §7):

* Identity   — no-op tag type (reference IDPreconditioner, h:1165-1170).
* Jacobi     — diagonal scaling; absent in the reference but the standard
  cheap parallel option (BASELINE.json allows "diagonal/SSOR-style").
* SGS        — M = (D+L) D^{-1} (D+U); apply = forward substitution on
  (D+L) then the (I + D^{-1}U) backward sweep (h:1660-1711).  Stateless
  w.r.t. values (reads the matrix), zero factorisation cost.  Built from
  CSR (``from_matrix``) or from DIA (``from_dia``: the strict triangles
  stay DIA matrices, so every Jacobi sweep is a shifted-slice SpMV).
* ILU0       — COMPLETE implementation (the reference's is unfinished:
  apply declared but never defined, h:1199, inverted error checks,
  h:1743-1780).  apply = unit-lower forward solve then upper solve.
* IC0        — L L^T with zero fill; apply = L forward, L^T backward
  (h:1802-1837); non-SPD input raises instead of silently NaN-ing
  (h:1879).

Triangular sweeps use precond.trisolve strategies (dense / Jacobi-sweep),
selectable via ``method=``/``sweeps=`` at construction.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSRMatrix
from ..formats.dia import DIAMatrix
from ._factorize import (
    FactorizationError,
    ic0_factorize_host,
    ilu0_factorize_host,
    split_triangular,
)
from .trisolve import TriangularMatrix, triangular_from_csr_arrays

__all__ = [
    "SolverPreconditioner",
    "IdentityPreconditioner",
    "JacobiPreconditioner",
    "SGSPreconditioner",
    "ILU0Preconditioner",
    "IC0Preconditioner",
    "get_preconditioner",
    "FactorizationError",
]

_SGS_MIN_DIAG = 1e-5  # reference diagonal magnitude floor (h:1690-1693)


class SolverPreconditioner(enum.Enum):
    """Preconditioner selector (reference enum h:1002-1006; the reference
    misspells SYMMETRIC_GAUS_SEIDEL — both spellings are accepted by
    :func:`get_preconditioner`)."""

    NONE = "none"
    JACOBI = "jacobi"
    SYMMETRIC_GAUSS_SEIDEL = "sgs"
    ILU0 = "ilu0"
    IC0 = "ic0"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    """No-op preconditioner (reference IDPreconditioner, h:1165-1170)."""

    def apply(self, rhs: jnp.ndarray) -> jnp.ndarray:
        return rhs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """M = D: one elementwise multiply per apply."""

    inv_diag: jnp.ndarray

    def apply(self, rhs: jnp.ndarray) -> jnp.ndarray:
        d = self.inv_diag[:, None] if rhs.ndim == 2 else self.inv_diag
        return rhs * d

    @classmethod
    def from_matrix(cls, a: CSRMatrix) -> "JacobiPreconditioner":
        diag, _, _ = _host_split(a)
        if np.any(diag == 0):
            raise FactorizationError("matrix has zero diagonal entries")
        return cls(inv_diag=jnp.asarray((1.0 / diag).astype(np.asarray(a.data).dtype)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SGSPreconditioner:
    """Symmetric Gauss-Seidel: M = (D+L) D^{-1} (D+U).

    apply solves (D+L) y = rhs (forward, h:1672-1695), then
    (I + D^{-1} U) x = y, rewritten as (D+U) x = D y (backward,
    h:1697-1711).
    """

    fwd: TriangularMatrix   # D + L (lower)
    bwd: TriangularMatrix   # D + U (upper)
    diag: jnp.ndarray

    def apply(self, rhs: jnp.ndarray) -> jnp.ndarray:
        y = self.fwd.solve(rhs)
        d = self.diag[:, None] if rhs.ndim == 2 else self.diag
        return self.bwd.solve(d * y)

    @classmethod
    def from_matrix(
        cls, a: CSRMatrix, *, method: str = "auto", sweeps="exact",
    ) -> "SGSPreconditioner":
        diag, (ld, li, lr), (ud, ui, ur) = _host_split(a)
        if np.any(np.abs(diag) < _SGS_MIN_DIAG):
            # reference returns error 1 when |diag| < 1e-5 (h:1690-1693)
            raise FactorizationError(
                f"SGS requires |diagonal| >= {_SGS_MIN_DIAG} on every row"
            )
        n = a.shape[0]
        fwd = _strict_to_triangular(
            ld, li, lr, diag, n, lower=True, method=method, sweeps=sweeps,
        )
        bwd = _strict_to_triangular(
            ud, ui, ur, diag, n, lower=False, method=method, sweeps=sweeps,
        )
        return cls(fwd=fwd, bwd=bwd, diag=jnp.asarray(diag))

    @classmethod
    def from_dia(cls, a: DIAMatrix, *, sweeps: int = 4) -> "SGSPreconditioner":
        """SGS whose strict triangles are the DIA matrix's own lower and
        upper diagonals, each triangular solve ``sweeps`` Jacobi sweeps
        (precond/trisolve.py) — the same arithmetic as ``from_matrix``
        on the CSR form with ``method="jacobi"``.

        A truncated sweep count is a fixed linear operator, so it is a
        legitimate preconditioner M~ ~ (D+L) D^{-1} (D+U); for
        constant-diagonal SPD stencils it is symmetric positive definite
        as well (M~^{-1} = P_k(L^T/d) P_k(L/d)/d), so it is PCG-safe on
        the Poisson systems.  Requires a stored main diagonal with
        ``|d_i| >= 1e-5`` on every row (h:1690-1693).
        """
        if int(sweeps) < 1:
            raise ValueError("sweeps must be >= 1")
        offsets = a.offsets
        if 0 not in offsets:
            raise FactorizationError("SGS requires a stored main diagonal")
        n = a.shape[0]
        diag = np.asarray(a.diags[offsets.index(0)])[:n]
        if np.any(np.abs(diag) < _SGS_MIN_DIAG):
            raise FactorizationError(
                f"SGS requires |diagonal| >= {_SGS_MIN_DIAG} on every row"
            )
        dvec = jnp.asarray(diag)

        def triangle(lower: bool) -> TriangularMatrix:
            keep = [i for i, off in enumerate(offsets)
                    if (off < 0 if lower else off > 0)]
            strict = None
            if keep:
                strict = DIAMatrix(
                    diags=a.diags[jnp.asarray(keep)],
                    offsets=tuple(offsets[i] for i in keep),
                    shape=a.shape,
                    nnz=a.nnz,  # metadata only
                )
            return TriangularMatrix(
                strict=strict, diag=dvec, dense=None, n=int(n),
                lower=lower, depth=-1, method="jacobi", sweeps=int(sweeps),
            )

        return cls(fwd=triangle(True), bwd=triangle(False), diag=dvec)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ILU0Preconditioner:
    """M = L U with the sparsity pattern of A (zero fill).

    apply: forward solve L y = rhs (unit diagonal), backward U x = y.
    The complete version of the reference's unfinished ILU0 (SURVEY §2.1
    #14)."""

    lower: TriangularMatrix  # unit lower (L)
    upper: TriangularMatrix  # upper incl. diag (U)
    # diagonal shift applied before factorisation: 0.0 normally; > 0
    # when the unshifted elimination hit a (near-)zero pivot and the
    # factorisation retried on A + shift*I (the standard Manteuffel-style
    # cure — the shifted factor preconditions the ORIGINAL system,
    # slightly weaker but well-defined, instead of failing outright)
    shift: float = dataclasses.field(
        metadata=dict(static=True), default=0.0
    )

    def apply(self, rhs: jnp.ndarray) -> jnp.ndarray:
        y = self.lower.solve(rhs)
        return self.upper.solve(y)

    @classmethod
    def from_matrix(
        cls, a: CSRMatrix, *, method: str = "auto", sweeps="exact",
        pivot_shift: str = "auto",
    ) -> "ILU0Preconditioner":
        """``pivot_shift='auto'`` (default): on a (near-)zero pivot,
        retry the factorisation on ``A + alpha*I`` with ``alpha``
        escalating from 1e-3 to ~100x the mean |diagonal| — a
        data-dependent zero pivot (e.g. jittered convection-diffusion)
        then degrades to a shifted-but-usable
        preconditioner instead of an error.  ``pivot_shift='never'``
        restores the raise-on-zero-pivot behavior.  The applied shift
        is reported as ``.shift``."""
        data = np.asarray(a.data, dtype=np.float64)
        indices = np.asarray(a.indices, dtype=np.int64)
        indptr = np.asarray(a.indptr, dtype=np.int64)
        n = a.shape[0]
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        on_diag = indices == row_ids
        dscale = float(np.abs(data[on_diag]).mean()) if on_diag.any() else 1.0
        ptol = 1e-12 * max(dscale, np.finfo(np.float64).tiny)
        shifts = [0.0]
        if pivot_shift == "auto":
            shifts += [dscale * 1e-3 * 10.0 ** k for k in range(6)]
        factor = shift = None
        for alpha in shifts:
            d2 = data if alpha == 0.0 else np.where(
                on_diag,
                np.where(data >= 0, data + alpha, data - alpha),
                data,
            )
            try:
                factor, _ = ilu0_factorize_host(
                    d2, indices, indptr, pivot_tol=ptol
                )
                shift = alpha
                break
            except FactorizationError:
                if alpha == shifts[-1]:
                    raise
        dtype = np.asarray(a.data).dtype
        diag_f, (ld, li, lr), (ud, ui, ur) = split_triangular(
            factor.astype(dtype), indices, indptr
        )
        n = a.shape[0]
        lower = _strict_to_triangular(
            ld, li, lr, np.ones(n, dtype=dtype), n,
            lower=True, method=method, sweeps=sweeps,
        )
        upper = _strict_to_triangular(
            ud, ui, ur, diag_f, n, lower=False, method=method, sweeps=sweeps,
        )
        return cls(lower=lower, upper=upper, shift=float(shift))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IC0Preconditioner:
    """M = L L^T with the lower-triangular pattern of A (zero fill).

    apply: forward solve L y = rhs, backward solve L^T x = y
    (reference h:1802-1837)."""

    lower: TriangularMatrix   # L (incl. diag)
    upper: TriangularMatrix   # L^T (incl. diag)

    def apply(self, rhs: jnp.ndarray) -> jnp.ndarray:
        y = self.lower.solve(rhs)
        return self.upper.solve(y)

    @classmethod
    def from_matrix(
        cls, a: CSRMatrix, *, method: str = "auto", sweeps="exact",
    ) -> "IC0Preconditioner":
        data = np.asarray(a.data, dtype=np.float64)
        indices = np.asarray(a.indices, dtype=np.int64)
        indptr = np.asarray(a.indptr, dtype=np.int64)
        lv, lidx, lptr = ic0_factorize_host(data, indices, indptr)
        dtype = np.asarray(a.data).dtype
        lv = lv.astype(dtype)
        n = a.shape[0]
        lower = triangular_from_csr_arrays(
            lv, lidx, lptr, lower=True, method=method, sweeps=sweeps,
        )
        # transpose L -> upper CSR (host)
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(lptr))
        order = np.lexsort((row_ids, lidx))  # sort by (new row=old col, new col)
        t_rows, t_cols, t_vals = lidx[order], row_ids[order], lv[order]
        t_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(t_ptr[1:], t_rows, 1)
        np.cumsum(t_ptr, out=t_ptr)
        upper = triangular_from_csr_arrays(
            t_vals, t_cols, t_ptr, lower=False, method=method, sweeps=sweeps,
        )
        return cls(lower=lower, upper=upper)


def get_preconditioner(
    a: CSRMatrix, kind=SolverPreconditioner.NONE, **kwargs
):
    """Preconditioner factory (reference getPreconditioner, h:1643-1651 —
    which can only create NONE and SGS; this one covers everything,
    including IC0/ILU0 which the reference factory cannot construct)."""
    if isinstance(kind, str):
        if kind.lower() in ("cheby", "chebyshev", "poly", "polynomial"):
            # addition: polynomial preconditioning (the apply
            # is k SpMVs with A — launch-light; precond/cheby_poly.py)
            from .cheby_poly import ChebyshevPreconditioner

            return ChebyshevPreconditioner.from_matrix(a, **kwargs)
        aliases = {
            "none": SolverPreconditioner.NONE,
            "jacobi": SolverPreconditioner.JACOBI,
            "diagonal": SolverPreconditioner.JACOBI,
            "sgs": SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL,
            "symmetric_gauss_seidel": SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL,
            "symmetric_gaus_seidel": SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL,
            "ilu0": SolverPreconditioner.ILU0,
            "ic0": SolverPreconditioner.IC0,
        }
        kind = aliases[kind.lower()]
    if kind == SolverPreconditioner.NONE:
        return IdentityPreconditioner()
    if kind == SolverPreconditioner.JACOBI:
        return JacobiPreconditioner.from_matrix(a, **kwargs)
    if kind == SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL:
        return SGSPreconditioner.from_matrix(a, **kwargs)
    if kind == SolverPreconditioner.ILU0:
        return ILU0Preconditioner.from_matrix(a, **kwargs)
    if kind == SolverPreconditioner.IC0:
        return IC0Preconditioner.from_matrix(a, **kwargs)
    raise ValueError(f"unknown preconditioner kind: {kind!r}")


def _host_split(a: CSRMatrix):
    return split_triangular(
        np.asarray(a.data), np.asarray(a.indices, np.int64),
        np.asarray(a.indptr, np.int64),
    )


def _strict_to_triangular(
    s_data, s_idx, s_row, diag, n, *, lower, method, sweeps,
) -> TriangularMatrix:
    """Assemble a TriangularMatrix from strict-part COO + separate diagonal."""
    counts = np.zeros(n, dtype=np.int64)
    np.add.at(counts, s_row, 1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts + 1, out=indptr[1:])  # +1 slot per row for the diagonal
    nnz = int(indptr[-1])
    out_val = np.empty(nnz, dtype=np.asarray(diag).dtype)
    out_idx = np.empty(nnz, dtype=np.int64)
    # strict entries arrive row-major sorted; place diag at the correct slot
    fill = indptr[:-1].copy()
    rows_order = np.argsort(s_row, kind="stable")
    sr, si, sd = s_row[rows_order], s_idx[rows_order], s_data[rows_order]
    if lower:
        # strict cols < diag: strict entries first, then the diagonal
        offsets = _within_row_offsets(sr, n)
        dst = indptr[sr] + offsets
        out_val[dst] = sd
        out_idx[dst] = si
        ddst = indptr[1:] - 1
        out_val[ddst] = diag
        out_idx[ddst] = np.arange(n)
    else:
        # diagonal first, then strict cols > diag
        ddst = indptr[:-1]
        out_val[ddst] = diag
        out_idx[ddst] = np.arange(n)
        offsets = _within_row_offsets(sr, n)
        dst = indptr[sr] + 1 + offsets
        out_val[dst] = sd
        out_idx[dst] = si
    return triangular_from_csr_arrays(
        out_val, out_idx, indptr, lower=lower, method=method, sweeps=sweeps,
    )


def _within_row_offsets(sorted_rows: np.ndarray, n: int) -> np.ndarray:
    """Offset of each entry within its row, given row-sorted entries."""
    counts = np.zeros(n, dtype=np.int64)
    np.add.at(counts, sorted_rows, 1)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return np.arange(sorted_rows.shape[0], dtype=np.int64) - starts[sorted_rows]
