"""Sparse triangular solves.

The reference's preconditioner applies are sequential row sweeps
(SGS forward/backward substitution include/sparse_matrix_math.h:1672-1711,
IC0 h:1802-1837) — inherently serial, the main design challenge on a
data-parallel device (SURVEY §7 "hard parts" #1).  This module provides a
:class:`TriangularMatrix` factor with selectable solve strategies:

* ``dense``  — materialise the factor once and use
  ``jax.scipy.linalg.solve_triangular`` (exact; memory is
  O(n^2) so this is the small/medium-n path, e.g. the whole reference
  test suite).
* ``jacobi`` — stationary Jacobi iteration on the triangular system:
  ``x_{k+1} = D^{-1} (b - N x_k)`` with ``N`` the strictly-triangular
  part.  ``D^{-1}N`` is nilpotent with index equal to the factor's
  dependency-level count, so ``sweeps >= depth`` gives the EXACT solve;
  fewer sweeps give the standard approximate (iterative) triangular
  solve used by GPU preconditioning.  Each sweep is one fully
  parallel SpMV over the strict part — this is the scalable path.  The
  strict part is stored in any format ``rmult`` takes: CSR for factors
  built from CSR, DIA for the strict triangles of a DIA matrix (each
  sweep is then one fused shifted-slice pass, ops/spmv.py).

The dependency depth is computed at build time (host side) via level
scheduling, so ``sweeps="exact"`` is available without guessing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSRMatrix
from ..ops.spmv import rmult

__all__ = ["TriangularMatrix", "triangular_from_csr_arrays"]

# beyond this level-schedule depth, an "exact" Jacobi-sweep apply costs
# more SpMVs than the Krylov solve it preconditions — warn loudly
_EXACT_SWEEP_WARN_DEPTH = 64


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriangularMatrix:
    """Sparse triangular factor (diagonal stored separately).

    ``strict`` holds the STRICT triangular part as a matrix ``rmult``
    takes (a CSRMatrix, or a DIAMatrix for DIA-built factors; None when
    the part is empty); ``diag`` is the diagonal (all ones for
    unit-diagonal factors).
    """

    strict: Any            # CSRMatrix | DIAMatrix | None
    diag: jnp.ndarray      # (n,)
    dense: Optional[jnp.ndarray]  # (n, n) materialised factor, or None
    n: int = dataclasses.field(metadata=dict(static=True))
    lower: bool = dataclasses.field(metadata=dict(static=True))
    depth: int = dataclasses.field(metadata=dict(static=True))
    method: str = dataclasses.field(metadata=dict(static=True))
    sweeps: int = dataclasses.field(metadata=dict(static=True))

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """x with T x = b (T = strict part + diag).

        ``b`` may be a vector (n,) or a multi-RHS panel (n, m) — every
        step below (rmult, solve_triangular) operates column-wise, so
        panels solve in one pass.
        """
        if self.method == "dense":
            return jax.scipy.linalg.solve_triangular(
                self.dense, b, lower=self.lower
            )
        # Jacobi sweeps: x <- (b - N x) / d.  Exact when sweeps >= depth.
        inv_d = 1.0 / self.diag
        if b.ndim == 2:
            inv_d = inv_d[:, None]

        x0 = b * inv_d
        if self.strict is None:
            return x0

        def sweep(x, _):
            return (b - rmult(self.strict, x)) * inv_d, None

        x, _ = jax.lax.scan(sweep, x0, None, length=max(self.sweeps - 1, 0))
        return x


def triangular_from_csr_arrays(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    *,
    lower: bool,
    unit_diag: bool = False,
    method: str = "auto",
    sweeps="exact",
    dense_threshold: int = 4096,
) -> TriangularMatrix:
    """Build a :class:`TriangularMatrix` from host CSR arrays of a
    triangular matrix (diagonal entries may be present; they are split
    out).  For ``unit_diag`` factors the diagonal is implicit ones.

    ``method="auto"`` picks ``dense`` for n <= dense_threshold else
    ``jacobi``.  ``sweeps="exact"`` uses the level-scheduling depth.
    """
    data = np.asarray(data)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    on_diag = indices == row_ids
    if unit_diag:
        diag = np.ones(n, dtype=data.dtype)
    else:
        diag = np.zeros(n, dtype=data.dtype)
        diag[row_ids[on_diag]] = data[on_diag]
        if np.any(diag == 0):
            raise ValueError("triangular factor has a zero diagonal entry")
    strict = ~on_diag
    s_data, s_idx, s_row = data[strict], indices[strict], row_ids[strict]
    if lower and np.any(s_idx > s_row):
        raise ValueError("matrix is not lower triangular")
    if not lower and np.any(s_idx < s_row):
        raise ValueError("matrix is not upper triangular")

    if method == "auto":
        method = "dense" if n <= dense_threshold else "jacobi"
    if method not in ("dense", "jacobi"):
        raise ValueError(f"unknown triangular solve method {method!r}")
    if sweeps == "exact" or method == "dense":
        # level-scheduling depth: only computed when actually needed — the
        # host-side scan is O(n) Python work, pointless for explicit sweeps
        depth = _level_depth(s_idx, s_row, n, lower=lower)
    else:
        depth = -1  # unknown (not needed)
    if sweeps == "exact":
        n_sweeps = depth
        if method == "jacobi" and depth > _EXACT_SWEEP_WARN_DEPTH:
            import warnings

            warnings.warn(
                f"sweeps='exact' implies {depth} Jacobi sweeps per "
                "triangular apply (each sweep is a full SpMV) — at this "
                "depth the preconditioner is technically exact but "
                "practically unusable.  Pass an explicit small sweep "
                "count (e.g. sweeps=2..8, the standard approximate "
                "triangular solve) for scale.",
                RuntimeWarning,
                stacklevel=3,
            )
    else:
        n_sweeps = int(sweeps)

    dense = None
    if method == "dense":
        dmat = np.zeros((n, n), dtype=data.dtype)
        dmat[s_row, s_idx] = s_data
        dmat[np.arange(n), np.arange(n)] = diag
        dense = jnp.asarray(dmat)

    s_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(s_row, minlength=n), out=s_ptr[1:])
    strict = CSRMatrix(
        data=jnp.asarray(s_data),
        indices=jnp.asarray(s_idx.astype(np.int32)),
        indptr=jnp.asarray(s_ptr.astype(np.int32)),
        row_ids=jnp.asarray(s_row.astype(np.int32)),
        shape=(int(n), int(n)),
    )
    return TriangularMatrix(
        strict=strict,
        diag=jnp.asarray(diag),
        dense=dense,
        n=int(n),
        lower=bool(lower),
        depth=int(depth),
        method=method,
        sweeps=int(n_sweeps),
    )


def _level_depth(s_idx: np.ndarray, s_row: np.ndarray, n: int, *, lower: bool) -> int:
    """Level-scheduling depth of a strict triangular pattern: the length of
    the longest dependency chain = nilpotency index of D^{-1}N."""
    level = np.zeros(n, dtype=np.int64)
    if s_row.size == 0:
        return 1
    order = range(n) if lower else range(n - 1, -1, -1)
    # group strict entries by row
    by_row_start = np.zeros(n + 1, dtype=np.int64)
    np.add.at(by_row_start[1:], s_row, 1)
    np.cumsum(by_row_start, out=by_row_start)
    sort = np.argsort(s_row, kind="stable")
    cols_sorted = s_idx[sort]
    for r in order:
        lo, hi = by_row_start[r], by_row_start[r + 1]
        if hi > lo:
            level[r] = level[cols_sorted[lo:hi]].max() + 1
    return int(level.max()) + 1
