"""Loader dispatch by file extension.

Re-design of the reference ``loadMatrix`` overloads
(include/sparse_matrix_math.h:2648-2669): ``.mtx`` → Matrix Market,
``.smmdt`` → dense-text, anything else →
FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT.  The CSR convenience form builds the
triplet then converts (h:2661-2669).
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

from ..formats.csr import CSRMatrix, csr_from_coo, csr_from_triplet
from ..formats.triplet import TripletMatrix
from .matrix_market import (
    MatrixLoadStatus,
    MatrixMarketError,
    load_matrix_market,
    load_matrix_market_coo,
)
from .smmdt import load_smmdt

__all__ = ["load_matrix", "load_matrix_csr", "load_matrix_df"]


def load_matrix(
    path: Union[str, os.PathLike], *, dtype=np.float64, allow_general: bool = False
) -> TripletMatrix:
    """Load a matrix file into a :class:`TripletMatrix`, dispatching on
    extension (h:2650-2657)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".mtx":
        return load_matrix_market(path, dtype=dtype, allow_general=allow_general)
    if ext == ".smmdt":
        return load_smmdt(path, dtype=dtype)
    raise MatrixMarketError(
        MatrixLoadStatus.FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT,
        f"unknown matrix file extension: {ext!r} (expected .mtx or .smmdt)",
    )


def load_matrix_df(
    path: Union[str, os.PathLike], *, allow_general: bool = False
):
    """Load a matrix file into a double-word operator (DfDiaMatrix for
    stencil patterns, DfEllMatrix otherwise).

    The reference loads into ``double`` matrices end-to-end
    (h:2648-2669 dispatch over ``TripletMatrix<double>``); this is the
    equivalent with f32 storage: values are parsed on the
    host in float64 and split EXACTLY into (hi, lo) float32 planes
    (ops/df32.py), so the operator reaching the device carries the full
    f64 data.  Pair with :func:`~..solvers.df64.cg_df64` for 1e-8-grade
    solves on-chip.
    """
    from ..formats.triplet import host_coo_arrays
    from ..ops.df32 import df_operator_from_host_csr

    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".mtx":
        from .. import native

        try:
            parsed = native.mtx_read_native(str(path), allow_general)
        except native._MtxNativeError as e:
            raise MatrixMarketError(MatrixLoadStatus(e.status), str(e)) from e
        if parsed is not None:
            n_rows, n_cols, r, c, v = parsed
            rows, cols, vals, shape = host_coo_arrays(
                r, c, v, (n_rows, n_cols), dtype=np.float64
            )
        else:
            rows, cols, vals, shape = load_matrix_market(
                path, allow_general=allow_general, dtype=np.float64
            ).to_host_coo(dtype=np.float64)
    else:
        rows, cols, vals, shape = load_matrix(
            path, dtype=np.float64, allow_general=allow_general
        ).to_host_coo(dtype=np.float64)
    n_rows = shape[0]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return df_operator_from_host_csr(vals, cols, indptr, shape)


def load_matrix_csr(
    path: Union[str, os.PathLike], *, dtype=np.float64, allow_general: bool = False
) -> CSRMatrix:
    """Load straight to CSR (reference CSR overload, h:2661-2669).

    ``.mtx`` files take the bulk path (native C parser when available →
    sorted/deduplicated COO → CSR), skipping the per-entry container.
    """
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".mtx":
        return csr_from_coo(
            load_matrix_market_coo(path, dtype=dtype, allow_general=allow_general)
        )
    return csr_from_triplet(
        load_matrix(path, dtype=dtype, allow_general=allow_general)
    )
