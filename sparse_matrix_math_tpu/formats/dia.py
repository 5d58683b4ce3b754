"""DIA (diagonal) sparse format — speed-of-light layout for stencil matrices.

Structured matrices (finite-difference / finite-element stencils like the
reference's test suite and the 2D/5-point Poisson benchmark,
BASELINE.json config 4) have all nonzeros on a handful of diagonals.
Storing them per-diagonal turns SpMV into a few shifted elementwise FMAs —
no gather at all, so the SpMV runs at memory bandwidth:

    y = sum_d diags[d, :] * shift(x, offsets[d])

The reference has no equivalent (its only compute format is CSR).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix

__all__ = ["DIAMatrix", "dia_from_csr", "try_dia_from_csr"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Diagonal-storage square-ish sparse matrix.

    ``diags[d, i]`` is the entry at ``(i, i + offsets[d])``; slots that fall
    outside the matrix are zero.
    """

    diags: jnp.ndarray  # (ndiags, rows)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.diags.dtype

    def rmult(self, x: jnp.ndarray) -> jnp.ndarray:
        from ..ops import spmv as _spmv

        return _spmv.rmult(self, x)

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.rmult(x)

    def astype(self, dtype) -> "DIAMatrix":
        """Cast stored diagonal values (e.g. to bfloat16 for a ~1.5x
        bandwidth win when the stencil weights are exactly representable;
        SpMV accumulation stays in the multiplicand's dtype)."""
        return dataclasses.replace(self, diags=self.diags.astype(dtype))

    def to_dense(self) -> jnp.ndarray:
        n_rows, n_cols = self.shape
        out = jnp.zeros(self.shape, self.dtype)
        rows = jnp.arange(n_rows)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            valid = (cols >= 0) & (cols < n_cols)
            out = out.at[
                jnp.where(valid, rows, 0), jnp.where(valid, cols, 0)
            ].add(jnp.where(valid, self.diags[d], 0))
        return out


def dia_from_csr(csr: CSRMatrix, *, max_diags: int = 64) -> DIAMatrix:
    """Convert CSR → DIA.  Raises ValueError when the matrix has more than
    ``max_diags`` distinct diagonals (then DIA would waste memory — use
    ELL/CSR instead; see :func:`try_dia_from_csr`)."""
    indices = np.asarray(csr.indices, dtype=np.int64)
    row_ids = np.asarray(csr.row_ids, dtype=np.int64)
    data = np.asarray(csr.data)
    n_rows, n_cols = csr.shape

    offs = indices - row_ids
    uniq = np.unique(offs)
    if uniq.size > max_diags:
        raise ValueError(
            f"matrix has {uniq.size} distinct diagonals (> {max_diags}); "
            "DIA layout not suitable"
        )
    diags = np.zeros((uniq.size, n_rows), dtype=data.dtype)
    diags[np.searchsorted(uniq, offs), row_ids] = data
    return DIAMatrix(
        diags=jnp.asarray(diags),
        offsets=tuple(int(o) for o in uniq),
        shape=(int(n_rows), int(n_cols)),
        nnz=csr.nnz,
    )


def try_dia_from_csr(
    csr: CSRMatrix, *, max_diags: int = 64, min_fill: float = 0.25
) -> Optional[DIAMatrix]:
    """DIA when profitable (few diagonals, reasonably dense along them),
    else None."""
    indices = np.asarray(csr.indices, dtype=np.int64)
    row_ids = np.asarray(csr.row_ids, dtype=np.int64)
    uniq = np.unique(indices - row_ids)
    if uniq.size > max_diags:
        return None
    fill = csr.nnz / max(uniq.size * csr.shape[0], 1)
    if fill < min_fill:
        return None
    return dia_from_csr(csr, max_diags=max_diags)
