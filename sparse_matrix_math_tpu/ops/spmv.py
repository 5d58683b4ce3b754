"""SpMV kernel family: y = op(lhs, A @ x).

Re-design of the reference's ``rMultOp`` family
(include/sparse_matrix_math.h:1458-1515): ``rmult`` (y = A@x),
``rmult_add`` (y = lhs + A@x), ``rmult_sub`` (y = lhs - A@x).  The
reference walks ragged CSR rows with a scalar FMA loop parallelised over
row ranges by TBB (h:1493-1497); here each format gets a vectorised XLA
formulation:

* CSR — gather ``x`` by column index, multiply, segment-sum by row.
  Empty rows produce 0 contributions exactly as the reference's
  ``op(lhs[row], 0)`` does (h:1479-1483).
* ELL — rectangular gather + FMA reduction over slots.
* DIA — shifted elementwise FMAs, no gather (stencil fast path).

All functions are jit-safe (static shapes, no Python branching on traced
values) and differentiable.
"""

from __future__ import annotations

from functools import singledispatch

import jax
import jax.numpy as jnp

from ..formats.csr import CSRMatrix
from ..formats.dia import DIAMatrix
from ..formats.ell import ELLMatrix
from ..formats.hyb import HYBMatrix
from ..formats.reorder import ReorderedMatrix
from ..formats.stencil import GridStencilMatrix

__all__ = ["rmult", "rmult_add", "rmult_sub", "matvec_fn"]

# -- per-format y = A @ x ----------------------------------------------------


@singledispatch
def rmult(a, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x (reference rMult, h:1501-1505).

    Unlike the reference (which forbids ``mult == res`` aliasing,
    h:1272-1274), the functional form has no aliasing constraints.
    Falls back to dense matmul for 2-D arrays and to direct application
    for callables (the LinearOperator escape hatch the reference lacks).
    """
    if hasattr(a, "ndim") and a.ndim == 2:
        # pinned: the default f32 matmul precision may be TF32 on GPUs
        return jnp.matmul(a, x, precision=jax.lax.Precision.HIGHEST)
    if callable(a):
        return a(x)
    raise TypeError(f"unsupported matrix type: {type(a).__name__}")


def _bcast(v: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Append singleton dims so per-entry coefficients broadcast against a
    (possibly multi-column) multiplicand — SpMM support: x may be (n,) or
    (n, k) [or higher], y matches."""
    return v.reshape(v.shape + (1,) * (x.ndim - 1))


@rmult.register
def _rmult_csr(a: CSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    gathered = _bcast(a.data, x) * jnp.take(x, a.indices, axis=0)
    return jax.ops.segment_sum(
        gathered, a.row_ids, num_segments=a.shape[0], indices_are_sorted=True
    )


@rmult.register
def _rmult_stencil(a: GridStencilMatrix, x: jnp.ndarray) -> jnp.ndarray:
    # matrix-free: one fused elementwise pass, zero matrix traffic
    # (formats/stencil.py; the solver fast path keeps carries in the
    # grid layout and skips the per-call reshapes entirely)
    return a.rmult(x)


@rmult.register
def _rmult_ell(a: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    # (rows_padded, K) gather; padding slots have val 0 so contribute nothing.
    gathered = jnp.take(x, a.cols, axis=0)  # (rows, K[, k])
    y = jnp.sum(_bcast(a.vals, x) * gathered, axis=1)
    return y[: a.shape[0]]


@rmult.register
def dia_rmult_xla(a: DIAMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """The shifted-slice DIA SpMV.

    Static-offset shifted reads: pad x once, then every diagonal is a
    contiguous static slice (no gather at all) — XLA fuses the whole
    thing into one elementwise pass over contiguous memory, bound by
    memory bandwidth.  Out-of-range slots read padding zeros, and DIA
    construction guarantees their stored values are 0 (formats/dia.py),
    so no masking is needed."""
    if not a.offsets:  # no stored diagonals: A == 0
        return jnp.zeros(
            (a.shape[0],) + x.shape[1:], dtype=jnp.result_type(a.dtype, x.dtype)
        )
    n_rows, n_cols = a.shape
    lpad = max(-min(a.offsets), 0)
    rpad = max(max(a.offsets) + n_rows - n_cols, 0)
    xp = jnp.pad(x, ((lpad, rpad),) + ((0, 0),) * (x.ndim - 1))
    y = jnp.zeros(
        (n_rows,) + x.shape[1:], dtype=jnp.result_type(a.dtype, x.dtype)
    )
    for d, off in enumerate(a.offsets):
        window = jax.lax.slice_in_dim(xp, lpad + off, lpad + off + n_rows, axis=0)
        y = y + _bcast(a.diags[d], x) * window
    return y


@rmult.register
def _rmult_reordered(a: ReorderedMatrix, x: jnp.ndarray) -> jnp.ndarray:
    # acts as the ORIGINAL A: route through the permutation (two vector
    # gathers per call — solvers hoist these out of their loops instead,
    # formats/reorder.py:reorder_hoisted)
    yp = rmult(a.inner, jnp.take(x, a.perm, axis=0))
    return jnp.take(yp, a.iperm, axis=0)


@rmult.register
def _rmult_hyb(a: HYBMatrix, x: jnp.ndarray) -> jnp.ndarray:
    # dominant diagonals at stencil speed + sparse remainder
    if a.dia is not None and a.rest is not None:
        return dia_rmult_xla(a.dia, x) + _rmult_csr(a.rest, x)
    if a.dia is not None:
        return dia_rmult_xla(a.dia, x)
    if a.rest is not None:
        return _rmult_csr(a.rest, x)
    return jnp.zeros((a.shape[0],), dtype=jnp.result_type(a.dtype, x.dtype))


# -- fused facades (reference h:1501-1515) ------------------------------------


def rmult_add(a, lhs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y = lhs + A @ x (reference rMultAdd, h:1507-1510)."""
    return lhs + rmult(a, x)


def rmult_sub(a, lhs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y = lhs - A @ x (reference rMultSub, h:1512-1515)."""
    return lhs - rmult(a, x)


def matvec_fn(a):
    """Normalise a matrix-like object to a matvec closure for the solvers.

    Accepts any registered sparse format, a dense 2-D array, or an
    arbitrary callable (the LinearOperator escape hatch the reference
    lacks)."""
    if isinstance(
        a, (CSRMatrix, ELLMatrix, DIAMatrix, HYBMatrix, ReorderedMatrix,
            GridStencilMatrix)
    ):
        return lambda x: rmult(a, x)
    if callable(a):
        return a
    return lambda x: rmult(a, x)


def as_operator(a):
    """Normalise ``a`` into something that can cross a ``jax.jit`` boundary
    as a pytree argument: registered formats and arrays pass through,
    bare callables are wrapped in ``jax.tree_util.Partial`` (so solver
    compilations are cached per matrix *structure*, not per call)."""
    if isinstance(
        a, (CSRMatrix, ELLMatrix, DIAMatrix, HYBMatrix, ReorderedMatrix,
            GridStencilMatrix)
    ):
        return a
    if hasattr(a, "ndim") and a.ndim == 2:
        return a
    if callable(a) and not isinstance(a, jax.tree_util.Partial):
        return jax.tree_util.Partial(a)
    return a
