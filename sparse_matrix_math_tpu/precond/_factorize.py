"""Host-side incomplete factorisations: IC(0) and ILU(0).

The reference computes these with in-place CSR loops
(IC0: include/sparse_matrix_math.h:1839-1928; ILU0: h:1727-1790 —
the latter broken/unfinished: ``apply`` never defined, error checks
inverted, SURVEY §2.1 #14).  Factorisation is an inherently sequential,
pattern-driven computation, so it stays on the host (NumPy) — the
*apply* is what runs on the device every iteration (trisolve.py).  A C++
fast path for large matrices lives in native/ (same algorithm).

Both raise informative errors instead of the reference's failure modes
(IC0 silently produces NaN on non-SPD input under NDEBUG, h:1879).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["ic0_factorize_host", "ilu0_factorize_host", "split_triangular"]


class FactorizationError(ValueError):
    """Raised when an incomplete factorisation does not exist
    (e.g. IC(0) on a non-SPD matrix — reference h:1873-1880)."""


def split_triangular(
    data: np.ndarray, indices: np.ndarray, indptr: np.ndarray
) -> Tuple[np.ndarray, ...]:
    """Split square CSR arrays into (diag, strict-lower CSR, strict-upper CSR)."""
    n = indptr.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag = np.zeros(n, dtype=data.dtype)
    on_d = indices == row_ids
    diag[row_ids[on_d]] = data[on_d]
    lo = indices < row_ids
    up = indices > row_ids
    return (
        diag,
        (data[lo], indices[lo], row_ids[lo]),
        (data[up], indices[up], row_ids[up]),
    )


def _csr_rows_as_dicts(data, indices, indptr):
    n = indptr.shape[0] - 1
    return [
        dict(zip(indices[indptr[i]: indptr[i + 1]].tolist(),
                 data[indptr[i]: indptr[i + 1]].tolist()))
        for i in range(n)
    ]


def ic0_factorize_host(
    data: np.ndarray, indices: np.ndarray, indptr: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Incomplete Cholesky with zero fill: A ~= L L^T on the lower-triangular
    pattern of A.  Returns lower-triangular CSR (incl. diagonal) arrays
    (l_data, l_indices, l_indptr).

    Up-looking row algorithm — mathematically the reference's
    (h:1856-1920: ``l_ii = sqrt(a_ii - sum l_ik^2)``,
    ``l_ji = (a_ji - sum l_ik l_jk) / l_ii``) restructured per-row.
    Raises :class:`FactorizationError` on non-SPD input instead of the
    reference's silent NaN (h:1879).
    """
    data = np.asarray(data, dtype=np.float64)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1

    native_result = _ic0_try_native(data, indices, indptr, n)
    if native_result is not None:
        return native_result

    l_rows: list[dict[int, float]] = []
    l_cols_sorted: list[list[int]] = []
    for i in range(n):
        a_row = {
            int(c): float(v)
            for c, v in zip(
                indices[indptr[i]: indptr[i + 1]], data[indptr[i]: indptr[i + 1]]
            )
            if c <= i
        }
        if i not in a_row:
            raise FactorizationError(
                f"row {i} has no diagonal entry; matrix is not SPD"
            )
        li: dict[int, float] = {}
        cols = sorted(c for c in a_row if c < i)
        for k in cols:
            lk = l_rows[k]
            # sum over shared columns j < k
            s = 0.0
            if len(li) <= len(lk):
                for j, v in li.items():
                    if j < k and j in lk:
                        s += v * lk[j]
            else:
                for j, v in lk.items():
                    if j < k and j in li:
                        s += v * li[j]
            li[k] = (a_row[k] - s) / lk[k]
        d = a_row[i] - sum(v * v for c, v in li.items())
        if d <= 0.0:
            raise FactorizationError(
                f"non-positive pivot {d:.3e} at row {i}; matrix is not SPD "
                "(reference would silently produce NaN here, h:1879)"
            )
        li[i] = float(np.sqrt(d))
        l_rows.append(li)
        l_cols_sorted.append(cols + [i])

    return _rows_to_csr(l_rows, l_cols_sorted, n, data.dtype)


def _ic0_try_native(data, indices, indptr, n):
    """Native-C IC(0) fast path (native/smm_native.cpp); None → fall back
    to the Python implementation below (identical algorithm)."""
    from .. import native

    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    low = indices <= row_ids
    l_idx = indices[low]
    l_val = data[low]
    l_row = row_ids[low]
    counts = np.bincount(l_row, minlength=n)
    if np.any(counts == 0):
        missing = int(np.nonzero(counts == 0)[0][0])
        raise FactorizationError(
            f"row {missing} has no diagonal entry; matrix is not SPD"
        )
    l_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=l_ptr[1:])
    # CSR columns ascend, so each row's last lower entry must be its diagonal
    last = l_idx[l_ptr[1:] - 1]
    if np.any(last != np.arange(n)):
        missing = int(np.nonzero(last != np.arange(n))[0][0])
        raise FactorizationError(
            f"row {missing} has no diagonal entry; matrix is not SPD"
        )
    try:
        l_values = native.ic0_factorize_native(l_ptr, l_idx, l_val)
    except ValueError as e:
        raise FactorizationError(str(e)) from e
    if l_values is None:
        return None
    return l_values, l_idx, l_ptr


def ilu0_factorize_host(
    data: np.ndarray, indices: np.ndarray, indptr: np.ndarray,
    pivot_tol: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """ILU(0): incomplete LU with zero fill on the pattern of A.

    Returns ``factor`` values aligned with the input CSR pattern: strict
    lower entries hold L (unit diagonal implicit), diagonal + strict upper
    hold U.  This is the complete version of the reference's intent —
    its ``apply`` is declared but never defined and the factorisation's
    error logic is inverted (SURVEY §2.1 #14, h:1743-1780).

    Second return value is the diagonal of U (for convenience).
    Classic IKJ algorithm (Saad §10.3.2).

    ``pivot_tol``: pivots with ``|pivot| <= pivot_tol`` raise
    ``FactorizationError`` — a data-dependent NEAR-zero pivot yields a
    factor with huge entries that is useless as a preconditioner.
    ``ILU0Preconditioner.from_matrix`` escalates through diagonal
    shifts on that error.
    """
    data = np.asarray(data, dtype=np.float64)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    factor = data.copy()

    # position of each row's diagonal within the CSR arrays (vectorised)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_pos = np.full(n, -1, dtype=np.int64)
    on_diag = np.nonzero(indices == row_ids)[0]
    diag_pos[row_ids[on_diag]] = on_diag
    if np.any(diag_pos < 0):
        missing = int(np.nonzero(diag_pos < 0)[0][0])
        raise FactorizationError(
            f"row {missing} has no diagonal entry; ILU(0) requires a full "
            "diagonal (reference would need reordering, h:1741-1746)"
        )

    from .. import native

    try:
        native_factor = native.ilu0_factorize_native(
            indptr, indices, diag_pos, data, float(pivot_tol)
        )
    except ValueError as e:
        raise FactorizationError(str(e)) from e
    if native_factor is not None:
        return native_factor, native_factor[diag_pos]

    col_pos = {}  # transient map col -> position for the active row
    for i in range(1, n):
        row_lo, row_hi = indptr[i], indptr[i + 1]
        col_pos.clear()
        for p in range(row_lo, row_hi):
            col_pos[int(indices[p])] = p
        for p in range(row_lo, row_hi):
            k = int(indices[p])
            if k >= i:
                break
            pivot = factor[diag_pos[k]]
            if abs(pivot) <= pivot_tol:
                raise FactorizationError(f"zero pivot at row {k} during ILU(0)")
            alpha = factor[p] / pivot
            factor[p] = alpha
            # subtract alpha * U(k, j) for j > k within our pattern
            for q in range(diag_pos[k] + 1, indptr[k + 1]):
                j = int(indices[q])
                pj = col_pos.get(j)
                if pj is not None:
                    factor[pj] -= alpha * factor[q]
        if abs(factor[diag_pos[i]]) <= pivot_tol:
            raise FactorizationError(f"zero pivot at row {i} during ILU(0)")

    u_diag = factor[diag_pos]
    return factor, u_diag


def _rows_to_csr(rows_dicts, cols_sorted, n, dtype):
    counts = np.fromiter((len(c) for c in cols_sorted), dtype=np.int64, count=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    out_idx = np.empty(nnz, dtype=np.int64)
    out_val = np.empty(nnz, dtype=dtype)
    pos = 0
    for i in range(n):
        for c in cols_sorted[i]:
            out_idx[pos] = c
            out_val[pos] = rows_dicts[i][c]
            pos += 1
    return out_val, out_idx, indptr
