"""HYB (hybrid) sparse format: dominant diagonals + sparse remainder.

Real matrices are often *nearly* banded (sherman1 is exactly 7 diagonals;
FEM matrices concentrate on a band plus stragglers).  HYB splits a CSR
matrix into

* a :class:`DIAMatrix` holding every diagonal whose fill ratio clears a
  threshold — SpMV'd by shifted slices at bandwidth speed, and
* a CSR remainder for the leftover entries — SpMV'd by the XLA
  segment-sum path (cheap when the remainder is small).

``y = dia @ x + rest @ x``.  The reference has no equivalent (CSR only);
this is the answer to its general-matrix coverage: structure
runs at stencil speed, irregularity degrades gracefully.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix, _csr_from_sorted_host
from .dia import DIAMatrix

__all__ = ["HYBMatrix", "hyb_from_csr"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HYBMatrix:
    """Diagonal part + remainder; either may be absent (None)."""

    dia: Optional[DIAMatrix]
    rest: Optional[CSRMatrix]
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        if self.dia is not None:
            return self.dia.dtype
        if self.rest is not None:
            return self.rest.dtype
        import jax.numpy as _jnp

        return _jnp.zeros(0).dtype  # degenerate empty matrix

    @property
    def diagonal_fraction(self) -> float:
        """Share of nnz on the DIA side (1.0 = perfectly banded)."""
        return (self.dia.nnz / self.nnz) if (self.dia and self.nnz) else 0.0

    def rmult(self, x: jnp.ndarray) -> jnp.ndarray:
        from ..ops import spmv as _spmv

        return _spmv.rmult(self, x)

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.rmult(x)

    def to_dense(self) -> jnp.ndarray:
        out = jnp.zeros(self.shape, self.dtype)
        if self.dia is not None:
            out = out + self.dia.to_dense()
        if self.rest is not None:
            out = out + self.rest.to_dense()
        return out


def hyb_from_csr(
    csr: CSRMatrix,
    *,
    min_diag_fill: float = 0.5,
    max_diags: int = 64,
) -> HYBMatrix:
    """Split ``csr`` into dominant diagonals + remainder.

    A diagonal qualifies when it holds at least ``min_diag_fill`` · n_rows
    entries; at most ``max_diags`` qualify (densest first).
    """
    indices = np.asarray(csr.indices, dtype=np.int64)
    row_ids = np.asarray(csr.row_ids, dtype=np.int64)
    data = np.asarray(csr.data)
    n_rows, n_cols = csr.shape

    offs = indices - row_ids
    uniq, inverse, counts = np.unique(offs, return_inverse=True, return_counts=True)
    qualified = counts >= max(min_diag_fill * n_rows, 1)
    if qualified.sum() > max_diags:
        order = np.argsort(-counts)
        keep = np.zeros_like(qualified)
        keep[order[:max_diags]] = True
        qualified &= keep

    on_dia = qualified[inverse]
    dia = None
    if on_dia.any():
        kept = uniq[qualified]
        diags = np.zeros((kept.size, n_rows), dtype=data.dtype)
        slot = np.searchsorted(kept, offs[on_dia])
        diags[slot, row_ids[on_dia]] = data[on_dia]
        dia = DIAMatrix(
            diags=jnp.asarray(diags),
            offsets=tuple(int(o) for o in kept),
            shape=(int(n_rows), int(n_cols)),
            nnz=int(on_dia.sum()),
        )

    rest = None
    if (~on_dia).any():
        rest = _csr_from_sorted_host(
            row_ids[~on_dia], indices[~on_dia], data[~on_dia],
            (int(n_rows), int(n_cols)),
        )
    if dia is None and rest is None:
        rest = csr  # empty matrix: keep the (empty) CSR so ops stay total

    return HYBMatrix(dia=dia, rest=rest, shape=(int(n_rows), int(n_cols)), nnz=csr.nnz)
