"""Triplet (COO / coordinate) sparse-matrix assembly containers.

Re-design of the reference's ``_TripletMatrixCommon`` family
(reference: include/sparse_matrix_math.h:487-684).  The reference stores
entries in a ``std::map``/``std::unordered_map`` keyed by ``row<<32|col`` and
accumulates duplicates on ``addEntry`` (sparse_matrix_math.h:607-618).  Here:

* :class:`TripletMatrix` is a host-side assembly container (a Python dict
  keyed by ``(row, col)``) with the same semantics: ``add_entry`` accumulates
  duplicates, ``update_entry`` only overwrites existing entries,
  ``get_value`` returns 0 for missing entries.
* :class:`COOArrays` is the device-side bulk representation: three flat
  arrays ``(rows, cols, vals)`` as a JAX pytree, built either from a
  ``TripletMatrix`` or directly from arrays with a vectorised
  sort + segment-sum duplicate reduction (the functional equivalent of the
  reference's map-insert-or-accumulate loop).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["TripletMatrix", "COOArrays", "coo_from_arrays", "host_coo_arrays"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COOArrays:
    """Device-side COO matrix: parallel (rows, cols, vals) arrays.

    Entries are sorted row-major (row, then column) with duplicates already
    summed, matching the ordering invariant the reference gets for free from
    ``std::map`` key order (sparse_matrix_math.h:1635).
    """

    rows: jnp.ndarray  # (nnz,) int32
    cols: jnp.ndarray  # (nnz,) int32
    vals: jnp.ndarray  # (nnz,) float
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    def to_dense(self) -> jnp.ndarray:
        """Dense row-major scatter (reference toLinearDenseRowMajor,
        sparse_matrix_math.h:1995-2008)."""
        out = jnp.zeros(self.shape, dtype=self.vals.dtype)
        return out.at[self.rows, self.cols].add(self.vals)

    def scale(self, scalar) -> "COOArrays":
        """Scalar multiply (reference operator*=, h:672-678)."""
        return dataclasses.replace(self, vals=self.vals * scalar)


def host_coo_arrays(
    rows,
    cols,
    vals,
    shape: Tuple[int, int],
    *,
    sum_duplicates: bool = True,
    dtype=None,
):
    """Host-side sort/deduplicate of flat COO arrays.

    Returns ``(rows_i32, cols_i32, vals, shape)`` as NumPy arrays sorted
    row-major with duplicates summed — the precision-preserving core of
    :func:`coo_from_arrays` (float64 values stay float64 here; shipping
    to a device without f64 support is what rounds them)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=dtype if dtype is not None else None)
    if vals.dtype == np.int64 or not np.issubdtype(vals.dtype, np.floating):
        vals = vals.astype(np.float64 if dtype is None else dtype)
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError("rows/cols/vals must have identical shapes")
    n_rows, n_cols = shape
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("row index out of range")
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("column index out of range")

    # Sort row-major; stable so duplicate groups stay contiguous.
    key = rows * np.int64(n_cols) + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    if sum_duplicates and key.size:
        uniq, inverse = np.unique(key, return_inverse=True)
        summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
        np.add.at(summed, inverse, vals)
        key, vals = uniq, summed
    out_rows = (key // n_cols).astype(np.int32)
    out_cols = (key % n_cols).astype(np.int32)
    return out_rows, out_cols, vals, (int(n_rows), int(n_cols))


def coo_from_arrays(
    rows,
    cols,
    vals,
    shape: Tuple[int, int],
    *,
    sum_duplicates: bool = True,
    dtype=None,
) -> COOArrays:
    """Build sorted, duplicate-summed :class:`COOArrays` from flat arrays.

    The vectorised equivalent of repeated ``addEntry`` calls
    (sparse_matrix_math.h:607-618): duplicates at the same (row, col)
    accumulate.  Runs on host with NumPy (assembly is a host-side concern;
    the result ships to device as a pytree).
    """
    out_rows, out_cols, vals, shape = host_coo_arrays(
        rows, cols, vals, shape, sum_duplicates=sum_duplicates, dtype=dtype
    )
    n_rows, n_cols = shape
    return COOArrays(
        rows=jnp.asarray(out_rows),
        cols=jnp.asarray(out_cols),
        vals=jnp.asarray(vals),
        shape=(int(n_rows), int(n_cols)),
    )


class TripletMatrix:
    """Host-side incremental assembly container (COO with dict storage).

    Mirrors the reference ``TripletMatrix`` semantics
    (sparse_matrix_math.h:487-684):

    * ``add_entry`` accumulates duplicates (h:607-618)
    * ``update_entry`` overwrites only if the entry exists (h:621-632)
    * ``get_value`` returns 0.0 for absent entries (h:635-645)
    * iteration yields entries in row-major order (std::map key order)
    * row/column counts are metadata only — adding entries never resizes

    Unlike the reference there is no separate ``UnorderedTripletMatrix``:
    ordering is produced on export, so the reference's unsorted-map→CSR
    hazard (h:1635) cannot occur here.
    """

    def __init__(self, rows: int = 0, cols: int = 0, dtype=np.float64):
        self._shape = (int(rows), int(cols))
        self._entries: dict[tuple[int, int], float] = {}
        self.dtype = np.dtype(dtype)

    # -- reference API parity ------------------------------------------------
    def init(self, rows: int, cols: int) -> None:
        """Re-initialise dimensions and clear entries (h:589-597)."""
        self._shape = (int(rows), int(cols))
        self._entries.clear()

    def deinit(self) -> None:
        """Clear all state (h:599-604)."""
        self._shape = (0, 0)
        self._entries.clear()

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def dense_row_count(self) -> int:
        return self._shape[0]

    @property
    def dense_col_count(self) -> int:
        return self._shape[1]

    @property
    def nnz(self) -> int:
        """Count of stored entries (getNonZeroCount in the reference)."""
        return len(self._entries)

    def add_entry(self, row: int, col: int, value: float) -> None:
        """Add ``value`` at (row, col); duplicates accumulate (h:607-618)."""
        self._check_index(row, col)
        key = (int(row), int(col))
        self._entries[key] = self._entries.get(key, 0.0) + float(value)

    def update_entry(self, row: int, col: int, value: float) -> bool:
        """Overwrite an existing entry; returns False if absent (h:621-632)."""
        key = (int(row), int(col))
        if key in self._entries:
            self._entries[key] = float(value)
            return True
        return False

    def get_value(self, row: int, col: int) -> float:
        """Value at (row, col), 0.0 when not stored (h:635-645)."""
        return self._entries.get((int(row), int(col)), 0.0)

    def scale(self, scalar: float) -> None:
        """In-place scalar multiply (operator*=, h:672-678)."""
        for key in self._entries:
            self._entries[key] *= scalar

    def __imul__(self, scalar: float) -> "TripletMatrix":
        self.scale(scalar)
        return self

    def __iter__(self) -> Iterator[Tuple[int, int, float]]:
        """Row-major (row, col, value) iteration — the map-order guarantee."""
        for (r, c) in sorted(self._entries):
            yield r, c, self._entries[(r, c)]

    def __len__(self) -> int:
        return len(self._entries)

    # -- export --------------------------------------------------------------
    def to_host_coo(self, dtype=None):
        """Sorted host (rows, cols, vals) NumPy arrays — like
        :meth:`to_coo` but never shipped to device, so float64 values
        survive on backends without f64 (the ``load_matrix_df`` chain)."""
        dtype = np.dtype(dtype) if dtype is not None else self.dtype
        items = sorted(self._entries.items())
        rows = np.fromiter((k[0] for k, _ in items), dtype=np.int32, count=len(items))
        cols = np.fromiter((k[1] for k, _ in items), dtype=np.int32, count=len(items))
        vals = np.fromiter((v for _, v in items), dtype=dtype, count=len(items))
        return rows, cols, vals, self._shape

    def to_coo(self, dtype=None) -> COOArrays:
        dtype = np.dtype(dtype) if dtype is not None else self.dtype
        if not self._entries:
            z = np.zeros(0)
            return COOArrays(
                rows=jnp.asarray(z, dtype=jnp.int32),
                cols=jnp.asarray(z, dtype=jnp.int32),
                vals=jnp.asarray(z, dtype=dtype),
                shape=self._shape,
            )
        items = sorted(self._entries.items())
        rows = np.fromiter((k[0] for k, _ in items), dtype=np.int32, count=len(items))
        cols = np.fromiter((k[1] for k, _ in items), dtype=np.int32, count=len(items))
        vals = np.fromiter((v for _, v in items), dtype=dtype, count=len(items))
        return COOArrays(
            rows=jnp.asarray(rows),
            cols=jnp.asarray(cols),
            vals=jnp.asarray(vals),
            shape=self._shape,
        )

    def to_dense(self, dtype=None) -> np.ndarray:
        dtype = np.dtype(dtype) if dtype is not None else self.dtype
        out = np.zeros(self._shape, dtype=dtype)
        for (r, c), v in self._entries.items():
            out[r, c] = v
        return out

    def _check_index(self, row: int, col: int) -> None:
        if not (0 <= int(row) < self._shape[0] and 0 <= int(col) < self._shape[1]):
            raise IndexError(
                f"entry ({row}, {col}) out of bounds for shape {self._shape}"
            )
