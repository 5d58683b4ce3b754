"""Bandwidth-reducing reordering (reverse Cuthill-McKee).

Scattered patterns — shuffled meshes, arbitrarily-numbered graphs,
permuted banded systems — make every SpMV gather ``x`` from all over
memory.  The classical cure is a symmetric BANDWIDTH-REDUCING
permutation: reverse Cuthill-McKee (RCM) renumbers the rows/columns by
breadth-first levels so the permuted matrix is banded, and the gathers
of each row block then read a narrow, cache-resident window of ``x``.
The reference has no analogue (its scalar CSR loop is
pattern-indifferent, h:1458-1515).

Pipeline (`reorder_rcm`):

1. ``rcm_permutation`` — RCM on the symmetrised pattern (SciPy's
   csgraph implementation when available, else a pure-NumPy BFS);
2. ``permute_csr`` — host-side A' = A[p, :][:, p].

The result is wrapped in :class:`ReorderedMatrix`, which acts as the
ORIGINAL operator A everywhere (``rmult`` routes x through the
permutation: y = (A' x[p])[p^-1]).  Per-call that costs two vector
gathers; the solver entry points hoist them OUT of the iteration loop
(solve A' x' = b[p] once, un-permute x at the end) via
:func:`reorder_hoisted` — zero per-iteration overhead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSRMatrix, csr_from_coo
from .triplet import COOArrays

__all__ = [
    "ReorderedMatrix",
    "rcm_permutation",
    "permute_csr",
    "reorder_rcm",
]


def _rcm_numpy(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Pure-NumPy RCM on a symmetric adjacency (CSR indptr/indices):
    BFS from a minimum-degree start per component, neighbors visited in
    degree order, final order reversed."""
    degree = np.diff(indptr)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    # process components in order of their minimum-degree seed
    seeds = np.argsort(degree, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = indices[indptr[u]: indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)  # unique also sorts; stable tie-break
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos: pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()


def rcm_permutation(csr: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a square matrix's pattern.

    Returns ``perm`` (int64) such that ``A[perm, :][:, perm]`` has
    (near-)minimal bandwidth.  The pattern is symmetrised first (RCM is
    a graph algorithm; for structurally nonsymmetric A the permuted
    matrix is still correct, just ordered by A + A^T's graph).
    """
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        raise ValueError("rcm_permutation needs a square matrix")
    r = np.asarray(csr.row_ids, dtype=np.int64)
    c = np.asarray(csr.indices, dtype=np.int64)
    # symmetrise the pattern: edges both ways, dedup, drop self-loops
    rs = np.concatenate([r, c])
    cs = np.concatenate([c, r])
    keep = rs != cs
    rs, cs = rs[keep], cs[keep]
    key = rs * n_rows + cs
    key = np.unique(key)
    rs, cs = key // n_rows, key % n_rows
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rs, minlength=n_rows), out=indptr[1:])
    try:
        from scipy.sparse import csr_matrix as _sp_csr
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        g = _sp_csr(
            (np.ones(cs.shape[0], np.int8), cs.astype(np.int32), indptr),
            shape=(n_rows, n_rows),
        )
        return np.asarray(
            reverse_cuthill_mckee(g, symmetric_mode=True), dtype=np.int64
        )
    except ImportError:
        return _rcm_numpy(indptr, cs, n_rows)


def permute_csr(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Host-side symmetric permutation: returns A' with
    ``A'[i, j] = A[perm[i], perm[j]]``."""
    perm = np.asarray(perm, dtype=np.int64)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.shape[0])
    r = iperm[np.asarray(csr.row_ids, dtype=np.int64)]
    c = iperm[np.asarray(csr.indices, dtype=np.int64)]
    return csr_from_coo(
        COOArrays(
            rows=r, cols=c, vals=np.asarray(csr.data), shape=csr.shape
        ),
        needs_sort=True,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReorderedMatrix:
    """A sparse operator stored in a bandwidth-reduced ordering.

    Acts as the ORIGINAL matrix A: ``rmult(x)`` routes the vector
    through the permutation (two gathers per call).  Solvers hoist the
    permutation outside their iteration loop instead — see
    :func:`reorder_hoisted`.

    ``inner`` is the operator for A' = A[perm][:, perm] (any format);
    ``inner_csr`` keeps the permuted CSR for preconditioner
    factorisations in the permuted domain.
    """

    inner: object
    inner_csr: Optional[CSRMatrix]
    perm: jnp.ndarray    # (n,) int32: new index i holds old index perm[i]
    iperm: jnp.ndarray   # (n,) int32: inverse permutation
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.inner.dtype

    def to_permuted(self, x: jnp.ndarray) -> jnp.ndarray:
        """Vector old-order -> permuted order (x' = x[perm])."""
        return x[self.perm]

    def from_permuted(self, xp: jnp.ndarray) -> jnp.ndarray:
        """Vector permuted order -> old order."""
        return xp[self.iperm]

    def rmult(self, x: jnp.ndarray) -> jnp.ndarray:
        from ..ops import spmv as _spmv

        return _spmv.rmult(self, x)

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.rmult(x)

    def to_dense(self) -> jnp.ndarray:
        inner_dense = self.inner.to_dense()
        return inner_dense[self.iperm][:, self.iperm]


def reorder_rcm(csr: CSRMatrix) -> ReorderedMatrix:
    """RCM-permute a square ``csr``; the permuted CSR is the inner
    operator."""
    perm = rcm_permutation(csr)
    permuted = permute_csr(csr, perm)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.shape[0])
    return ReorderedMatrix(
        inner=permuted,
        inner_csr=permuted,
        perm=jnp.asarray(perm.astype(np.int32)),
        iperm=jnp.asarray(iperm.astype(np.int32)),
        shape=csr.shape,
        nnz=int(csr.nnz),
    )


def reorder_hoisted(solver_fn):
    """Wrap a solver entry ``f(a, b, x0=None, **kw) -> SolveResult`` so a
    ReorderedMatrix is solved ENTIRELY in the permuted domain: permute b
    (and x0) once, run the inner solve, un-permute x once — zero
    per-iteration permutation cost.  Residual norms, iteration counts
    and statuses are permutation-invariant and pass through unchanged.
    """
    import functools

    @functools.wraps(solver_fn)
    def wrapped(a, b, x0=None, *args, **kwargs):
        if not isinstance(a, ReorderedMatrix):
            return solver_fn(a, b, x0, *args, **kwargs)
        bp = a.to_permuted(jnp.asarray(b))
        x0p = None if x0 is None else a.to_permuted(jnp.asarray(x0))
        res = solver_fn(a.inner, bp, x0p, *args, **kwargs)
        return dataclasses.replace(res, x=a.from_permuted(res.x))

    return wrapped
