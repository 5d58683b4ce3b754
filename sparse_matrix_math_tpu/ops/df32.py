"""Double-word f32 ("df32") arithmetic: ~f64 accuracy carried in f32 pairs.

The reference library is templated over ``double`` throughout
(include/sparse_matrix_math.h:42 ``Vector<T>``, :2316
``ConjugateGradient<T>``) and its accuracy contract is 1e-8 residuals in
f64 (test/include/test_common.h:30-38).  This module meets that contract
with f32 storage: every value is carried as an unevaluated pair
``(hi, lo)`` of float32 with ``|lo| <= ulp(hi)/2``, giving an effective
48-bit significand (~1.1e-16 unit roundoff per operation with the
accurate double-word algorithms below) — comfortably past the 1e-8 bar.

The primitives are the classical error-free transforms (Dekker 1971,
Knuth TAOCP 4.2.2, and the double-word algorithms analysed in
Joldes-Muller-Popescu 2017):

* ``two_sum``      — branch-free exact a+b = s + e  (6 flops)
* ``two_prod``     — exact a*b = p + e via Dekker splitting (no FMA
  required; XLA exposes none)
* ``df_add/df_mul/df_div`` — accurate double-word ops (relative error
  ~2^-47 each)
* ``df_dot/df_norm2``      — compensated reductions: elementwise
  two_prod, then a pairwise tree of df_add (error ~log2(n) * 2^-47,
  i.e. f64-quality dots at any practical n)
* ``DfEllMatrix``  — double-word ELL SpMV: per-slot two_prod of the hi
  parts plus the f32 cross terms, accumulated in double-word

Everything is ordinary jax.numpy — jit/while_loop friendly and
bandwidth-bound at ~7 nnz/row.

Safety note: the error-free transforms require strict IEEE f32
semantics — no reassociation, no mul+add contraction into FMA.  XLA
never reassociates, but LLVM-based backends DO contract: inside large
fusions (a jitted CG body) a product is re-materialised per consumer
and contracted into an FMA there, silently replacing the value
``two_prod``/``two_sum`` subtract back out.  The measured effect on a
2304-row Poisson CG on the CPU backend was a true-residual floor of
7.4e-6 instead of 8.1e-11 — and ``lax.optimization_barrier`` pinning did
not stop it.  The fix (``_via_f64``): with x64 enabled, the EFT
primitives compute through ONE exact f64 op and re-split — bit-exact
two_sum/two_prod with nothing to contract.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "two_sum",
    "two_prod",
    "df_add",
    "df_sub",
    "df_mul",
    "df_div",
    "df_scale_add",
    "df_dot",
    "df_norm2",
    "df_from_host",
    "df_to_host",
    "DfEllMatrix",
    "DfDiaMatrix",
    "DfGridStencil",
    "df_operator_from_host_csr",
]

_SPLIT = np.float32(4097.0)  # 2^12 + 1: Dekker split point for f32


def _via_f64() -> bool:
    """Trace-time choice of EFT implementation: with x64 enabled, route
    each primitive through a single f64 op followed by an exact
    re-split, which is bit-identical to the true error-free transform
    and has nothing for the compiler to contract into an FMA (see the
    module docstring).  Without x64 the pure-f32 sequences are used."""
    return bool(jax.config.jax_enable_x64)


def _f64(x):
    return jnp.asarray(x, jnp.float64)


def _resplit64(s64):
    """Exact (hi, lo) f32 pair from an f64 holding ≤49 significand bits.

    The hi word is rounded with ``reduce_precision``, not an f32 round
    trip: with excess precision allowed (XLA's default), the GPU
    compiler removes an f64->f32->f64 conversion pair, which would make
    the lo word zero."""
    hi = jax.lax.reduce_precision(s64, exponent_bits=8, mantissa_bits=23)
    return hi.astype(jnp.float32), (s64 - hi).astype(jnp.float32)


def two_sum(a, b):
    """Exact a + b = s + e (Knuth; branch-free, any magnitudes)."""
    if _via_f64():
        # f32 + f32 is exact in f64; the error term of the f32-rounded
        # sum is representable in f32 (Knuth), so the re-split is the
        # bit-exact two_sum
        return _resplit64(_f64(a) + _f64(b))
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _fast_two_sum(a, b):
    """Exact a + b = s + e, requiring |a| >= |b| (or a == 0)."""
    if _via_f64():
        return _resplit64(_f64(a) + _f64(b))
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Dekker split: a = hi + lo with hi, lo 12-bit significands."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact a * b = p + e via Dekker splitting (no FMA needed)."""
    if _via_f64():
        # f32 * f32 is exact in f64 (24+24 <= 53 bits)
        return _resplit64(_f64(a) * _f64(b))
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(a: Tuple, b: Tuple) -> Tuple:
    """Accurate double-word + double-word (AccurateDWPlusDW, ~2^-47)."""
    sh, sl = two_sum(a[0], b[0])
    th, tl = two_sum(a[1], b[1])
    c = sl + th
    vh, vl = _fast_two_sum(sh, c)
    w = tl + vl
    return _fast_two_sum(vh, w)


def df_sub(a: Tuple, b: Tuple) -> Tuple:
    return df_add(a, (-b[0], -b[1]))


def df_add_f(a: Tuple, f) -> Tuple:
    """double-word + plain f32."""
    sh, sl = two_sum(a[0], f)
    return _fast_two_sum(sh, sl + a[1])


def df_mul(a: Tuple, b: Tuple) -> Tuple:
    """Accurate double-word * double-word."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return _fast_two_sum(p, e)


def df_mul_f(a: Tuple, f) -> Tuple:
    """double-word * plain f32."""
    p, e = two_prod(a[0], f)
    return _fast_two_sum(p, e + a[1] * f)


def df_div(a: Tuple, b: Tuple) -> Tuple:
    """double-word / double-word (one Newton-style correction)."""
    q1 = a[0] / b[0]
    r = df_sub(a, df_mul_f(b, q1))
    q2 = r[0] / b[0]
    r = df_sub(r, df_mul_f(b, q2))
    q3 = r[0] / b[0]
    q, e = _fast_two_sum(q1, q2)
    return _fast_two_sum(q, e + q3)


def df_scale_add(y: Tuple, alpha: Tuple, x: Tuple) -> Tuple:
    """y + alpha * x elementwise over double-word VECTORS, with a
    double-word SCALAR alpha (the CG/axpy workhorse)."""
    p, e = two_prod(alpha[0], x[0])
    e = e + (alpha[0] * x[1] + alpha[1] * x[0])
    return df_add(y, _fast_two_sum(p, e))


def _df_pairwise_reduce(hi: jnp.ndarray, lo: jnp.ndarray) -> Tuple:
    """Pairwise (binary-tree) double-word sum of elementwise pairs —
    error grows like log2(n) * 2^-47 instead of n * 2^-24."""
    n = hi.shape[0]
    # pad to a power of two with exact zeros (trace-time unrolled tree)
    p2 = 1 if n == 0 else 1 << (int(n - 1).bit_length())
    hi = jnp.pad(hi, (0, p2 - n))
    lo = jnp.pad(lo, (0, p2 - n))
    while hi.shape[0] > 1:
        m = hi.shape[0] // 2
        hi, lo = df_add((hi[:m], lo[:m]), (hi[m:], lo[m:]))
    return hi[0], lo[0]


def df_dot(x: Tuple, y: Tuple) -> Tuple:
    """Compensated double-word dot product of double-word vectors."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _df_pairwise_reduce(p, e)


def df_norm2(x: Tuple) -> Tuple:
    """||x||^2 as a double-word scalar."""
    return df_dot(x, x)


def df_from_host(v: np.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split host float64 into an exact (hi, lo) float32 pair."""
    v = np.asarray(v, dtype=np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_host(x: Tuple) -> np.ndarray:
    """Recombine a (hi, lo) pair into host float64."""
    return np.asarray(x[0], dtype=np.float64) + np.asarray(
        x[1], dtype=np.float64
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DfEllMatrix:
    """Double-word ELL matrix: the f64 values split exactly into
    (hi, lo) f32 planes, so the PROBLEM itself is represented to ~2^-48
    — the reference's f64 operator, on hardware without f64.

    SpMV computes, per slot k: two_prod(hi, x_hi) exactly, plus the
    f32 cross terms hi*x_lo + lo*x_hi (their own rounding sits at the
    2^-48 level of the result), accumulated across slots in double-word.
    Padding slots carry hi = lo = 0 and col 0 — exact no-ops.
    """

    vals_hi: jnp.ndarray  # (rows_padded, K) f32
    vals_lo: jnp.ndarray  # (rows_padded, K) f32
    cols: jnp.ndarray     # (rows_padded, K) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_host_csr(
        cls, data: np.ndarray, indices: np.ndarray, indptr: np.ndarray,
        shape: Tuple[int, int],
    ) -> "DfEllMatrix":
        """Build from host CSR arrays (values in float64)."""
        data = np.asarray(data, dtype=np.float64)
        indices = np.asarray(indices, dtype=np.int64)
        indptr = np.asarray(indptr, dtype=np.int64)
        n_rows, n_cols = shape
        row_nnz = np.diff(indptr)
        k = int(row_nnz.max()) if row_nnz.size else 0
        k = max(k, 1)
        rows_p = max(-(-n_rows // 8) * 8, 8)
        vals = np.zeros((rows_p, k), np.float64)
        cols = np.zeros((rows_p, k), np.int32)
        r = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
        slot = np.arange(indptr[-1], dtype=np.int64) - np.repeat(
            indptr[:-1], row_nnz
        )
        vals[r, slot] = data
        cols[r, slot] = indices
        hi = vals.astype(np.float32)
        lo = (vals - hi.astype(np.float64)).astype(np.float32)
        return cls(
            vals_hi=jnp.asarray(hi),
            vals_lo=jnp.asarray(lo),
            cols=jnp.asarray(cols),
            shape=(int(n_rows), int(n_cols)),
            nnz=int(data.shape[0]),
        )

    @classmethod
    def from_csr(cls, csr) -> "DfEllMatrix":
        """Build from a device CSRMatrix.  NOTE: the device arrays are
        usually float32, so the lo planes are zero — the operator is only
        f32-accurate.  Use :meth:`from_host_csr` (or io.load_matrix_df)
        with the original f64 data for the full f64-parity chain."""
        return cls.from_host_csr(
            np.asarray(csr.data, dtype=np.float64),
            np.asarray(csr.indices, dtype=np.int64),
            np.asarray(csr.indptr, dtype=np.int64),
            csr.shape,
        )

    def rmult_df(self, x: Tuple) -> Tuple:
        """y = A @ x with x, y double-word vectors (reference rMult
        h:1458-1478, at f64 accuracy on f32 hardware).

        Stencil matrices should use :class:`DfDiaMatrix` (static shifted
        reads, no gather), which :func:`df_operator_from_host_csr`
        selects automatically."""
        n_rows, _ = self.shape
        x_hi, x_lo = x
        rows_p, k = self.vals_hi.shape
        y = (jnp.zeros(rows_p, jnp.float32), jnp.zeros(rows_p, jnp.float32))

        def slot(j, y):
            a_hi = self.vals_hi[:, j]
            a_lo = self.vals_lo[:, j]
            c = self.cols[:, j]
            xh = jnp.take(x_hi, c)
            xl = jnp.take(x_lo, c)
            p, e = two_prod(a_hi, xh)
            e = e + (a_hi * xl + a_lo * xh)
            return df_add(y, _fast_two_sum(p, e))

        y = jax.lax.fori_loop(0, k, slot, y)
        return y[0][:n_rows], y[1][:n_rows]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DfDiaMatrix:
    """Double-word DIA (diagonal-storage) matrix: the gather-free
    operator for stencil matrices in double-word arithmetic.

    Same layout contract as :class:`~..formats.dia.DIAMatrix`
    (``diags[d, i]`` is the entry at ``(i, i + offsets[d])``, out-of-range
    slots store exact zeros), with the values split into (hi, lo) f32
    planes.  SpMV pads x once and reads every diagonal as a contiguous
    STATIC slice — no gather — so XLA fuses the whole multiply into one
    elementwise pass at HBM bandwidth (the same idiom as the f32 XLA DIA
    path, ops/spmv.py:_rmult_dia), with double-word accumulation.
    """

    diags_hi: jnp.ndarray  # (ndiags, rows) f32
    diags_lo: jnp.ndarray  # (ndiags, rows) f32
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_host_csr(
        cls, data: np.ndarray, indices: np.ndarray, indptr: np.ndarray,
        shape: Tuple[int, int],
    ) -> "DfDiaMatrix":
        """Build from host CSR arrays (values float64), storing one
        (hi, lo) plane pair per populated diagonal."""
        data = np.asarray(data, dtype=np.float64)
        indices = np.asarray(indices, dtype=np.int64)
        indptr = np.asarray(indptr, dtype=np.int64)
        n_rows, n_cols = shape
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        offs = indices - rows
        uniq = np.unique(offs)
        diags = np.zeros((uniq.shape[0], n_rows), np.float64)
        d_idx = np.searchsorted(uniq, offs)
        diags[d_idx, rows] = data
        hi = diags.astype(np.float32)
        lo = (diags - hi.astype(np.float64)).astype(np.float32)
        return cls(
            diags_hi=jnp.asarray(hi),
            diags_lo=jnp.asarray(lo),
            offsets=tuple(int(o) for o in uniq),
            shape=(int(n_rows), int(n_cols)),
            nnz=int(data.shape[0]),
        )

    def rmult_df(self, x: Tuple) -> Tuple:
        """y = A @ x, double-word in and out, gather-free: pad x once,
        then every diagonal is a contiguous static slice accumulated in
        double-word."""
        n_rows, n_cols = self.shape
        x_hi, x_lo = x
        if not self.offsets:
            z = jnp.zeros(n_rows, jnp.float32)
            return z, z
        lpad = max(-min(self.offsets), 0)
        rpad = max(max(self.offsets) + n_rows - n_cols, 0)
        xh = jnp.pad(x_hi, (lpad, rpad))
        xl = jnp.pad(x_lo, (lpad, rpad))
        y = (jnp.zeros(n_rows, jnp.float32), jnp.zeros(n_rows, jnp.float32))
        for d, off in enumerate(self.offsets):
            wh = jax.lax.slice_in_dim(xh, lpad + off, lpad + off + n_rows)
            wl = jax.lax.slice_in_dim(xl, lpad + off, lpad + off + n_rows)
            a_hi = self.diags_hi[d]
            a_lo = self.diags_lo[d]
            p, e = two_prod(a_hi, wh)
            e = e + (a_hi * wl + a_lo * wh)
            y = df_add(y, _fast_two_sum(p, e))
        return y


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DfGridStencil:
    """Double-word matrix-free grid stencil: the df64 twin of
    formats/stencil.py:GridStencilMatrix.  The operator data is a
    handful of (hi, lo) scalar pairs; the apply is the same
    zero-pad + statically-shifted-slice accumulation with double-word
    arithmetic — still zero matrix traffic."""

    coeffs_hi: jnp.ndarray  # (npoints,)
    coeffs_lo: jnp.ndarray  # (npoints,)
    doffs: tuple = dataclasses.field(metadata=dict(static=True))
    dims: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_stencil(cls, st, coeffs64=None) -> "DfGridStencil":
        """From a GridStencilMatrix; ``coeffs64`` (host float64)
        overrides the coefficient values.  By default the stencil's OWN
        values are split exactly — a float64-valued stencil (the x64
        CPU backend) keeps its full precision in the lo words, unlike
        the other df builders whose device sources are always f32."""
        c64 = np.asarray(
            st.coeffs if coeffs64 is None else coeffs64, np.float64
        )
        hi = c64.astype(np.float32)
        lo = (c64 - hi.astype(np.float64)).astype(np.float32)
        return cls(
            coeffs_hi=jnp.asarray(hi),
            coeffs_lo=jnp.asarray(lo),
            doffs=st.doffs,
            dims=st.dims,
            shape=st.shape,
            nnz=int(st.nnz),
        )

    def rmult_df(self, x):
        """y = A @ x, (hi, lo) in and out — double-word accumulation of
        the shifted slices (see GridStencilMatrix.apply_grid)."""
        dims = self.dims
        xg_hi = x[0].reshape(dims)
        xg_lo = x[1].reshape(dims)
        lo_pad = [max(-min(o[d] for o in self.doffs), 0)
                  for d in range(len(dims))]
        hi_pad = [max(max(o[d] for o in self.doffs), 0)
                  for d in range(len(dims))]
        pads = tuple(zip(lo_pad, hi_pad))
        xph = jnp.pad(xg_hi, pads)
        xpl = jnp.pad(xg_lo, pads)
        y = None
        for k, off in enumerate(self.doffs):
            sl = tuple(
                slice(lo_pad[d] + off[d], lo_pad[d] + off[d] + dims[d])
                for d in range(len(dims))
            )
            wh, wl = xph[sl], xpl[sl]
            c_hi, c_lo = self.coeffs_hi[k], self.coeffs_lo[k]
            p, e = two_prod(c_hi, wh)
            e = e + (c_hi * wl + c_lo * wh)
            t = _fast_two_sum(p, e)
            y = t if y is None else df_add(y, t)
        return y[0].reshape(-1), y[1].reshape(-1)


# Diagonal-count budget for auto-selecting DfDiaMatrix: mirrors the f32
# formats' try_dia_from_csr default (formats/dia.py) — past this many
# populated diagonals the dense (ndiags, n) planes waste more bandwidth
# than the ELL gather costs.
_DF_DIA_MAX_DIAGS = 64


def df_operator_from_host_csr(
    data: np.ndarray, indices: np.ndarray, indptr: np.ndarray,
    shape: Tuple[int, int],
):
    """Pick the fastest double-word operator for the pattern: DIA
    (gather-free shifted reads) when the matrix is a narrow stencil and
    the diagonal fill doesn't blow up storage, ELL otherwise."""
    data = np.asarray(data, dtype=np.float64)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n_rows = shape[0]
    if data.size:
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        ndiags = np.unique(indices - rows).shape[0]
        fill = ndiags * n_rows / max(data.size, 1)
        if ndiags <= _DF_DIA_MAX_DIAGS and fill <= 4.0:
            return DfDiaMatrix.from_host_csr(data, indices, indptr, shape)
    return DfEllMatrix.from_host_csr(data, indices, indptr, shape)
