"""CSR (compressed sparse row) device matrix.

Re-design of the reference ``CSRMatrix`` (reference:
include/sparse_matrix_math.h:1008-1651).  The reference stores three
heap arrays — ``values`` (nnz), ``positions`` (column indices, sorted
ascending within each row, h:1246-1251), ``start`` (row pointers,
h:1252-1255).  Here the same three arrays are JAX device arrays in an
immutable pytree, plus a precomputed ``row_ids`` array (the row index of
every stored value) so SpMV can be expressed as gather + segment-sum
without any dynamic shapes.

All mutating operations of the reference (``updateEntry``, ``addEntry``,
``zeroValues``, ``operator*=``, ``inplaceAdd/Subtract`` — h:1525-1604)
become pure functions returning a new ``CSRMatrix`` sharing index arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .triplet import COOArrays, TripletMatrix, coo_from_arrays

__all__ = ["CSRMatrix", "csr_from_triplet", "csr_from_coo", "csr_from_dense"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Immutable CSR matrix pytree.

    Fields mirror the reference's arrays (sparse_matrix_math.h:1243-1255):

    * ``data``    — nnz stored values (reference ``values``)
    * ``indices`` — nnz column indices, ascending within each row
      (reference ``positions``)
    * ``indptr``  — rows+1 row pointers (reference ``start``)
    * ``row_ids`` — nnz row index per stored value (derived; lets SpMV be a
      single segment-sum, and makes empty rows free — the reference instead
      tracks ``firstActiveStart``, h:1258-1259)
    """

    data: jnp.ndarray      # (nnz,) float
    indices: jnp.ndarray   # (nnz,) int32
    indptr: jnp.ndarray    # (rows+1,) int32
    row_ids: jnp.ndarray   # (nnz,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    # -- metadata -------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def dense_row_count(self) -> int:
        return self.shape[0]

    @property
    def dense_col_count(self) -> int:
        return self.shape[1]

    # -- element access (reference h:1551-1604) -------------------------------
    def get_value_index(self, row: int, col: int):
        """Index into ``data`` for (row, col), or -1 when not stored.

        Binary search within the row, like the reference ``getValueIndex``
        (sparse_matrix_math.h:1551-1570): O(log row-nnz) probes of the
        column array, no O(nnz) temporaries.  Works traced or concrete.
        """
        start = self.indptr[row].astype(jnp.int32)
        end = self.indptr[jnp.asarray(row) + 1].astype(jnp.int32)
        n = self.indices.shape[0]
        col = jnp.asarray(col, self.indices.dtype)

        def cond(lohi):
            lo, hi = lohi
            return lo < hi

        def body(lohi):
            lo, hi = lohi
            mid = (lo + hi) // 2
            below = self.indices[jnp.clip(mid, 0, n - 1)] < col
            return jnp.where(below, mid + 1, lo), jnp.where(below, hi, mid)

        lo, _ = jax.lax.while_loop(cond, body, (start, end))
        found = (lo < end) & (self.indices[jnp.clip(lo, 0, n - 1)] == col)
        return jnp.where(found, lo, -1)

    def get_value(self, row: int, col: int):
        """Value at (row, col); 0 when not stored (reference h:1582-1589)."""
        idx = self.get_value_index(row, col)
        n = self.data.shape[0]
        return jnp.where(idx >= 0, self.data[jnp.clip(idx, 0, n - 1)], 0).astype(
            self.dtype
        )

    def update_entry(self, row: int, col: int, value) -> "CSRMatrix":
        """Overwrite a stored entry; no-op when absent (reference h:1572-1580)."""
        idx = self.get_value_index(row, col)
        n = self.data.shape[0]
        safe = jnp.clip(idx, 0, n - 1)
        new_data = jnp.where(
            (jnp.arange(n) == safe) & (idx >= 0),
            jnp.asarray(value, self.dtype),
            self.data,
        )
        return dataclasses.replace(self, data=new_data)

    def add_entry(self, row: int, col: int, value) -> "CSRMatrix":
        """Accumulate into a stored entry; no-op when the position is absent
        (reference ``addEntry`` h:1596-1604 — CSR cannot change pattern)."""
        idx = self.get_value_index(row, col)
        n = self.data.shape[0]
        safe = jnp.clip(idx, 0, n - 1)
        new_data = self.data + jnp.where(
            (jnp.arange(n) == safe) & (idx >= 0), jnp.asarray(value, self.dtype), 0
        )
        return dataclasses.replace(self, data=new_data)

    def zero_values(self) -> "CSRMatrix":
        """All stored values set to 0, pattern kept (reference h:1591-1594)."""
        return dataclasses.replace(self, data=jnp.zeros_like(self.data))

    def with_data(self, data: jnp.ndarray) -> "CSRMatrix":
        """Same pattern, new values."""
        if data.shape != self.data.shape:
            raise ValueError("data must match nnz")
        return dataclasses.replace(self, data=data)

    # -- matrix-level ops (reference h:1525-1549) ------------------------------
    def scale(self, scalar) -> "CSRMatrix":
        """Scalar multiply (reference operator*=, h:1525-1531)."""
        return dataclasses.replace(self, data=self.data * scalar)

    def __mul__(self, scalar) -> "CSRMatrix":
        return self.scale(scalar)

    __rmul__ = __mul__

    def has_same_nonzero_pattern(self, other: "CSRMatrix") -> bool:
        """Pattern equality (reference memcmp check, h:1366-1385)."""
        if self.shape != other.shape or self.nnz != other.nnz:
            return False
        return bool(
            jnp.array_equal(self.indices, other.indices)
            and jnp.array_equal(self.indptr, other.indptr)
        )

    def add(self, other: "CSRMatrix") -> "CSRMatrix":
        """Element-wise add; requires identical pattern (reference
        inplaceAdd, h:1533-1540)."""
        self._require_same_pattern(other)
        return dataclasses.replace(self, data=self.data + other.data)

    def subtract(self, other: "CSRMatrix") -> "CSRMatrix":
        """Element-wise subtract; requires identical pattern (reference
        inplaceSubtract, h:1542-1549)."""
        self._require_same_pattern(other)
        return dataclasses.replace(self, data=self.data - other.data)

    def _require_same_pattern(self, other: "CSRMatrix") -> None:
        if not self.has_same_nonzero_pattern(other):
            raise ValueError("matrices must share an identical non-zero pattern")

    # -- SpMV facade (delegates to ops.spmv) -----------------------------------
    def rmult(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x (reference rMult, h:1501-1505)."""
        from ..ops import spmv as _spmv

        return _spmv.rmult(self, x)

    def rmult_add(self, lhs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """y = lhs + A @ x (reference rMultAdd, h:1507-1510)."""
        from ..ops import spmv as _spmv

        return _spmv.rmult_add(self, lhs, x)

    def rmult_sub(self, lhs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """y = lhs - A @ x (reference rMultSub, h:1512-1515)."""
        from ..ops import spmv as _spmv

        return _spmv.rmult_sub(self, lhs, x)

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.rmult(x)

    def get_preconditioner(self, kind="none", **kwargs):
        """Member-function preconditioner factory (reference
        ``CSRMatrix::getPreconditioner``, h:1643-1651 — which can only build
        NONE/SGS; this one builds all five kinds)."""
        from ..precond.preconditioners import get_preconditioner as _factory

        return _factory(self, kind, **kwargs)

    # -- iteration (host-side convenience; reference CSRIterator h:879-1000) ---
    def __iter__(self) -> Iterator[Tuple[int, int, float]]:
        """(row, col, value) over stored entries; empty rows are skipped
        naturally (reference skips them in operator++, h:920-931)."""
        rows = np.asarray(self.row_ids)
        cols = np.asarray(self.indices)
        vals = np.asarray(self.data)
        for r, c, v in zip(rows, cols, vals):
            yield int(r), int(c), v.item()

    def iter_row(self, row: int) -> Iterator[Tuple[int, int, float]]:
        """Per-row iteration (reference CSRRowIterator, h:946-1000)."""
        start = int(self.indptr[row])
        end = int(self.indptr[row + 1])
        cols = np.asarray(self.indices[start:end])
        vals = np.asarray(self.data[start:end])
        for c, v in zip(cols, vals):
            yield int(row), int(c), v.item()

    def row_nnz(self, row: int) -> int:
        return int(self.indptr[row + 1] - self.indptr[row])

    # -- conversions -----------------------------------------------------------
    def to_dense(self) -> jnp.ndarray:
        """Dense scatter (reference toLinearDenseRowMajor, h:1995-2008)."""
        out = jnp.zeros(self.shape, dtype=self.dtype)
        return out.at[self.row_ids, self.indices].add(self.data)

    def to_coo(self) -> COOArrays:
        return COOArrays(
            rows=self.row_ids, cols=self.indices, vals=self.data, shape=self.shape
        )

    def transpose(self) -> "CSRMatrix":
        """A^T as a new CSR (used by preconditioner factorisations)."""
        coo = self.to_coo()
        return csr_from_coo(
            COOArrays(
                rows=coo.cols,
                cols=coo.rows,
                vals=coo.vals,
                shape=(self.shape[1], self.shape[0]),
            ),
            needs_sort=True,
        )

    def astype(self, dtype) -> "CSRMatrix":
        return dataclasses.replace(self, data=self.data.astype(dtype))


def _csr_from_sorted_host(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape: Tuple[int, int]
) -> CSRMatrix:
    """Assemble CSR arrays from row-major-sorted COO (host-side counting sort,
    the functional analogue of the reference ``fillArrays``, h:1606-1641)."""
    n_rows = shape[0]
    counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSRMatrix(
        data=jnp.asarray(vals),
        indices=jnp.asarray(cols.astype(np.int32)),
        indptr=jnp.asarray(indptr),
        row_ids=jnp.asarray(rows.astype(np.int32)),
        shape=(int(shape[0]), int(shape[1])),
    )


def csr_from_coo(coo: COOArrays, *, needs_sort: bool = False) -> CSRMatrix:
    """CSR from device COO arrays (reference CSRMatrix::init, h:1327-1349).

    ``COOArrays`` built through :func:`coo_from_arrays`/``TripletMatrix`` are
    already row-major sorted; pass ``needs_sort=True`` for raw arrays.  The
    reference asserts sortedness (h:1635) because ``UnorderedTripletMatrix``
    could violate it — here we sort explicitly instead of asserting.
    """
    rows = np.asarray(coo.rows, dtype=np.int64)
    cols = np.asarray(coo.cols, dtype=np.int64)
    vals = np.asarray(coo.vals)
    if needs_sort and rows.size:
        key = rows * np.int64(coo.shape[1]) + cols
        order = np.argsort(key, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
    return _csr_from_sorted_host(rows, cols, vals, coo.shape)


def csr_from_triplet(triplet: Union[TripletMatrix, COOArrays], dtype=None) -> CSRMatrix:
    """CSR from an assembly container (reference init-from-triplet path,
    SURVEY §3.1)."""
    if isinstance(triplet, TripletMatrix):
        coo = triplet.to_coo(dtype=dtype)
    else:
        coo = triplet
        if dtype is not None:
            coo = dataclasses.replace(coo, vals=coo.vals.astype(dtype))
    return csr_from_coo(coo)


def csr_from_dense(dense, dtype=None, tol: float = 0.0) -> CSRMatrix:
    """CSR from a dense array, dropping entries with |v| <= tol."""
    dense = np.asarray(dense)
    if dtype is not None:
        dense = dense.astype(dtype)
    rows, cols = np.nonzero(np.abs(dense) > tol)
    vals = dense[rows, cols]
    return _csr_from_sorted_host(
        rows.astype(np.int64), cols.astype(np.int64), vals, dense.shape
    )
