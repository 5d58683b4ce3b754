"""ELLPACK (padded) sparse format — the rectangular compute layout.

The reference's CSR SpMV walks ragged rows with a scalar FMA loop
(include/sparse_matrix_math.h:1478-1491).  Vector units want
rectangular data, so this format pads every row to the same slot count
K (the max row nnz):

* ``vals``: (rows_padded, K) — stored values, zero-padded
* ``cols``: (rows_padded, K) — column index per slot; padding slots point
  at column 0 with value 0, so ``x[cols] * vals`` is exact with no masking.

SpMV becomes ``y = sum_k vals[:, k] * x[cols[:, k]]`` — a dense gather +
FMA that XLA vectorises.  Rows are padded to a multiple of 8 for tile
alignment.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix

__all__ = ["ELLMatrix", "ell_from_csr"]

_ROW_ALIGN = 8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Padded row-major sparse matrix (derived from CSR, never assembled
    directly)."""

    vals: jnp.ndarray  # (rows_padded, K)
    cols: jnp.ndarray  # (rows_padded, K) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def rows_padded(self) -> int:
        return int(self.vals.shape[0])

    @property
    def slots(self) -> int:
        return int(self.vals.shape[1])

    @property
    def fill_ratio(self) -> float:
        """nnz / padded slots — storage efficiency of the padding."""
        total = self.vals.shape[0] * self.vals.shape[1]
        return self.nnz / total if total else 1.0

    def rmult(self, x: jnp.ndarray) -> jnp.ndarray:
        from ..ops import spmv as _spmv

        return _spmv.rmult(self, x)

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.rmult(x)

    def to_dense(self) -> jnp.ndarray:
        n_rows, n_cols = self.shape
        rows = jnp.broadcast_to(
            jnp.arange(self.rows_padded)[:, None], self.vals.shape
        )
        out = jnp.zeros((self.rows_padded, n_cols), self.dtype)
        out = out.at[rows.ravel(), self.cols.ravel()].add(self.vals.ravel())
        return out[:n_rows]


def ell_from_csr(csr: CSRMatrix, *, row_align: int = _ROW_ALIGN) -> ELLMatrix:
    """Pad a CSR matrix into ELL slots (host-side layout transform)."""
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = np.asarray(csr.indices, dtype=np.int64)
    data = np.asarray(csr.data)
    n_rows, n_cols = csr.shape
    row_nnz = np.diff(indptr)
    k = int(row_nnz.max()) if n_rows and row_nnz.size else 0
    k = max(k, 1)
    rows_padded = max(_round_up(n_rows, row_align), row_align)

    vals = np.zeros((rows_padded, k), dtype=data.dtype)
    cols = np.zeros((rows_padded, k), dtype=np.int32)
    # scatter each row's entries into its slot prefix
    slot = np.arange(len(indices)) - np.repeat(indptr[:-1], row_nnz)
    row_of = np.repeat(np.arange(n_rows), row_nnz)
    vals[row_of, slot] = data
    cols[row_of, slot] = indices
    return ELLMatrix(
        vals=jnp.asarray(vals),
        cols=jnp.asarray(cols),
        shape=(int(n_rows), int(n_cols)),
        nnz=csr.nnz,
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
