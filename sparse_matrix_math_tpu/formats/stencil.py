"""Matrix-free constant-coefficient grid stencils — zero matrix traffic.

A DIA SpMV streams its diagonal planes on every call, and at Poisson
widths those planes are most of the bytes.  But the reference's own
benchmark class
— finite-difference stencils on structured grids (2-D/3-D Poisson,
convection-diffusion; the reference applies them through its generic
CSR loop, include/sparse_matrix_math.h:1458-1515) — carries no per-entry
information at all: each diagonal holds ONE coefficient and the zero/cut
pattern is pure index arithmetic.  Storing those matrices explicitly
streams megabytes per SpMV to re-read a handful of scalars.

:class:`GridStencilMatrix` stores exactly (coefficients, grid shape,
grid offsets).  The apply reshapes the vector to the grid, zero-pads
once, and accumulates one statically-shifted slice per stencil point —
XLA fuses the whole thing into a single elementwise pass whose only
memory traffic is the vector itself.  Boundary cuts (a row's missing west neighbour at
the grid edge) are exact: the pad ring is zero, and interior cuts do
not exist on a tensor-product grid — which is precisely the condition
:func:`try_grid_stencil_from_csr` verifies ENTRY-FOR-ENTRY before
accepting a matrix, so the routed operator is always bit-equivalent to
the CSR it came from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix

__all__ = [
    "GridStencilMatrix",
    "try_grid_stencil_from_csr",
    "try_grid_stencil_from_dia",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridStencilMatrix:
    """Constant-coefficient stencil on an N-D tensor-product grid.

    ``coeffs[k]`` is the scalar applied to the neighbour at grid offset
    ``doffs[k]`` (a length-``ndim`` tuple, row-major: the LAST entry is
    the fastest-varying axis).  ``dims`` is the grid shape; the operator
    acts on flat vectors of length ``prod(dims)``.
    """

    coeffs: jnp.ndarray  # (npoints,)
    doffs: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    dims: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.coeffs.dtype

    def to_grid(self, x: jnp.ndarray) -> jnp.ndarray:
        return x.reshape(self.dims)

    def from_grid(self, xg: jnp.ndarray) -> jnp.ndarray:
        return xg.reshape(-1)

    def apply_grid(self, xg: jnp.ndarray) -> jnp.ndarray:
        """y = A x with x, y in the grid layout — the solver fast path
        keeps every carry in this layout (solvers/_stencil.py).  Any
        TRAILING axes beyond the grid dims are batch axes (multi-RHS
        panels): the shifted slices broadcast over them in the same
        fused pass."""
        nd = len(self.dims)
        extra = xg.ndim - nd
        lo = [max(-min(o[d] for o in self.doffs), 0) for d in range(nd)]
        hi = [max(max(o[d] for o in self.doffs), 0) for d in range(nd)]
        xp = jnp.pad(
            xg, tuple(zip(lo, hi)) + ((0, 0),) * extra
        )
        tail = (slice(None),) * extra
        y = None
        for k, off in enumerate(self.doffs):
            sl = tuple(
                slice(lo[d] + off[d], lo[d] + off[d] + self.dims[d])
                for d in range(nd)
            ) + tail
            term = self.coeffs[k] * xp[sl]
            y = term if y is None else y + term
        return y

    def apply_batched(self, xg: jnp.ndarray) -> jnp.ndarray:
        """y = A x for a LEADING-batch grid panel ``xg`` of shape
        ``(m, *dims)`` — the multi-RHS solver layout (solvers/block.py).

        Written as ONE explicit pad + shifted slices over the grid axes
        (batch axis untouched) rather than ``jax.vmap(apply_grid)``, so
        each column stays a contiguous run of the grid's memory."""
        nd = len(self.dims)
        lo = [max(-min(o[d] for o in self.doffs), 0) for d in range(nd)]
        hi = [max(max(o[d] for o in self.doffs), 0) for d in range(nd)]
        xp = jnp.pad(xg, ((0, 0),) + tuple(zip(lo, hi)))
        y = None
        for k, off in enumerate(self.doffs):
            sl = (slice(None),) + tuple(
                slice(lo[d] + off[d], lo[d] + off[d] + self.dims[d])
                for d in range(nd)
            )
            term = self.coeffs[k] * xp[sl]
            y = term if y is None else y + term
        return y

    def rmult(self, x: jnp.ndarray) -> jnp.ndarray:
        if x.ndim == 2:  # multi-RHS panel: batched fused pass
            m = x.shape[1]
            xg = x.reshape(self.dims + (m,))
            return self.apply_grid(xg).reshape(-1, m)
        return self.from_grid(self.apply_grid(self.to_grid(x)))

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.rmult(x)

    def diagonal(self) -> jnp.ndarray:
        """The matrix diagonal (constant: the (0,...,0) coefficient)."""
        for k, off in enumerate(self.doffs):
            if all(o == 0 for o in off):
                return jnp.full(
                    (self.shape[0],), self.coeffs[k], self.dtype
                )
        return jnp.zeros((self.shape[0],), self.dtype)

    def to_dense(self) -> jnp.ndarray:
        n = self.shape[0]
        eye = jnp.eye(n, dtype=self.dtype)
        cols = [self.rmult(eye[:, j]) for j in range(n)]
        return jnp.stack(cols, axis=1)


def _strides(dims: Tuple[int, ...]):
    """Row-major strides: strides[i] = prod(dims[i+1:])."""
    out = []
    s = 1
    for d in reversed(dims):
        out.append(s)
        s *= d
    return out[::-1]


def _decompose(off: int, dims: Tuple[int, ...], max_d: int):
    """Mixed-radix decomposition of a flat offset into per-axis grid
    offsets with each |component| <= max_d, or None.  Balanced rounding
    from the slowest axis is exact while max_d is well under every
    dimension (the detector's regime)."""
    comps = []
    rem = int(off)
    for s in _strides(dims):
        c = int(round(rem / s))
        if abs(c) > max_d:
            return None
        comps.append(c)
        rem -= c * s
    if rem != 0:
        return None
    return tuple(comps)


def try_grid_stencil_from_csr(
    csr: CSRMatrix,
    dims: Optional[Tuple[int, ...]] = None,
    *,
    max_point_offset: int = 2,
    max_diags: int = 32,
    dia=None,
) -> Optional[GridStencilMatrix]:
    """Detect a constant-coefficient grid stencil, verifying EVERY entry.

    ``dims`` gives the grid shape explicitly; without it, square 2-D and
    cubic 3-D grids are inferred from n.  Returns None unless the CSR is
    EXACTLY the stencil operator (values constant per offset, zero/cut
    pattern exactly the tensor-product boundary pattern) — detection is
    by reconstruction and exact comparison, so a routed operator is
    always bit-equivalent to its source.
    """
    from .dia import try_dia_from_csr

    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        return None
    if dia is None:
        # pass an existing DIAMatrix via ``dia=`` to skip this build
        dia = try_dia_from_csr(csr, max_diags=max_diags)
    if dia is None:
        return None
    return _detect_from_dia(
        dia, (int(n_rows), int(n_cols)), int(csr.nnz), dims,
        max_point_offset,
    )


def try_grid_stencil_from_dia(
    dia,
    dims: Optional[Tuple[int, ...]] = None,
    *,
    max_point_offset: int = 2,
) -> Optional[GridStencilMatrix]:
    """Stencil detection directly from a DIAMatrix (same entry-for-entry
    verification as :func:`try_grid_stencil_from_csr` — the check runs
    on the diagonal planes, which ARE the full value set of a DIA
    matrix)."""
    n_rows, n_cols = dia.shape
    if n_rows != n_cols:
        return None
    return _detect_from_dia(
        dia, (int(n_rows), int(n_cols)), int(dia.nnz), dims,
        max_point_offset,
    )


def _detect_from_dia(dia, shape, nnz, dims, max_point_offset):
    n_rows, n_cols = shape
    candidates = []
    if dims is not None:
        candidates.append(tuple(int(d) for d in dims))
    else:
        r2 = round(n_rows ** 0.5)
        if r2 * r2 == n_rows and r2 > 1:
            candidates.append((r2, r2))
        r3 = round(n_rows ** (1.0 / 3.0))
        for rr in (r3 - 1, r3, r3 + 1):
            if rr > 1 and rr**3 == n_rows:
                candidates.append((rr, rr, rr))

    diags = np.asarray(dia.diags)
    offsets = dia.offsets
    for cand in candidates:
        if int(np.prod(cand)) != n_rows:
            continue
        doffs, coeffs = [], []
        ok = True
        # index grids for the mask check (built once per candidate)
        idx = np.arange(n_rows, dtype=np.int64)
        coords = []
        rem = idx
        for s in _strides(cand):
            coords.append(rem // s)
            rem = rem % s
        for d_i, off in enumerate(offsets):
            row = diags[d_i]
            comp = _decompose(int(off), cand, max_point_offset)
            if comp is None:
                ok = False
                break
            nz = row[row != 0]
            if nz.size == 0:
                continue  # all-zero diagonal contributes nothing
            c = nz[0]
            mask = np.ones(n_rows, bool)
            for ax in range(len(cand)):
                v = coords[ax] + comp[ax]
                mask &= (v >= 0) & (v < cand[ax])
            expected = np.where(mask, c, np.zeros((), row.dtype))
            if not np.array_equal(row, expected):
                ok = False
                break
            doffs.append(comp)
            coeffs.append(c)
        if ok and doffs:
            return GridStencilMatrix(
                coeffs=jnp.asarray(np.asarray(coeffs)),
                doffs=tuple(doffs),
                dims=cand,
                shape=(int(n_rows), int(n_cols)),
                nnz=int(nnz),
            )
    return None
