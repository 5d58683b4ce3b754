"""Test/benchmark matrix generators.

The reference ships static .mtx assets (test/assets/: small SPD
structural matrices + sherman1); for a self-contained library we also
generate the standard model problems programmatically:

* 2-D / 3-D Poisson finite-difference stencils (5-point / 7-point) —
  SPD; the benchmark configs in BASELINE.json (configs 4-5) use these.
* random SPD matrices (diagonally dominant) for property tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats.csr import CSRMatrix, _csr_from_sorted_host
from ..formats.triplet import coo_from_arrays

__all__ = [
    "poisson_2d", "poisson_3d", "poisson_3d_27pt", "random_spd_csr",
    "laplace_1d", "laplace_3d_jittered", "reservoir_3d",
    "uniform_random_csr", "convection_diffusion_2d",
]


def laplace_1d(n: int, dtype=np.float64) -> CSRMatrix:
    """Tridiagonal [-1, 2, -1] SPD matrix."""
    rows, cols, vals = [], [], []
    main = np.full(n, 2.0)
    r = np.arange(n)
    rows = np.concatenate([r[1:], r, r[:-1]])
    cols = np.concatenate([r[:-1], r, r[1:]])
    vals = np.concatenate([np.full(n - 1, -1.0), main, np.full(n - 1, -1.0)])
    return _sorted_csr(rows, cols, vals.astype(dtype), (n, n))


def poisson_2d(nx: int, ny: int = None, dtype=np.float64) -> CSRMatrix:
    """5-point 2-D Poisson stencil on an nx-by-ny grid (n = nx*ny rows).

    Diagonal 4, off-diagonals -1 at (+-1, +-nx) with row-boundary cuts on
    the +-1 couplings.  SPD.  This is the benchmark matrix of
    BASELINE.json config 4 (~10M nnz at nx=ny=1414).
    """
    ny = nx if ny is None else ny
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]

    west = ix > 0
    rows.append(idx[west]); cols.append(idx[west] - 1)
    vals.append(np.full(west.sum(), -1.0))
    east = ix < nx - 1
    rows.append(idx[east]); cols.append(idx[east] + 1)
    vals.append(np.full(east.sum(), -1.0))
    north = idx >= nx
    rows.append(idx[north]); cols.append(idx[north] - nx)
    vals.append(np.full(north.sum(), -1.0))
    south = idx < n - nx
    rows.append(idx[south]); cols.append(idx[south] + nx)
    vals.append(np.full(south.sum(), -1.0))

    return _sorted_csr(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        (n, n),
    )


def poisson_3d(nx: int, ny: int = None, nz: int = None, dtype=np.float64) -> CSRMatrix:
    """7-point 3-D Poisson stencil (BASELINE.json config 5 weak-scaling
    matrix)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 6.0)]

    def couple(mask, offset):
        rows.append(idx[mask])
        cols.append(idx[mask] + offset)
        vals.append(np.full(mask.sum(), -1.0))

    couple(ix > 0, -1)
    couple(ix < nx - 1, +1)
    couple(iy > 0, -nx)
    couple(iy < ny - 1, +nx)
    couple(idx >= nx * ny, -nx * ny)
    couple(idx < n - nx * ny, +nx * ny)

    return _sorted_csr(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        (n, n),
    )


def poisson_3d_27pt(
    nx: int, ny: int = None, nz: int = None, dtype=np.float64
) -> CSRMatrix:
    """27-point 3-D Laplacian (all 26 grid neighbors coupled at -1,
    diagonal 26) — the WIDE-stencil model problem.

    SPD (symmetric, weakly diagonally dominant with strict dominance at
    the boundary).  Where :func:`poisson_3d`'s 7 diagonals make the DIA
    SpMV vector-traffic-bound, 27 diagonals make it MATRIX-stream-bound
    (the regime the bf16 matrix_dtype split targets — solvers/mixed.py);
    the small-integer values are exactly representable in bfloat16, so
    the bf16-rounded operator equals the f32 one bit-for-bit.
    """
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 26.0)]
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                m = (
                    (ix + dx >= 0) & (ix + dx < nx)
                    & (iy + dy >= 0) & (iy + dy < ny)
                    & (iz + dz >= 0) & (iz + dz < nz)
                )
                rows.append(idx[m])
                cols.append(idx[m] + dx + dy * nx + dz * nx * ny)
                vals.append(np.full(int(m.sum()), -1.0))

    return _sorted_csr(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        (n, n),
    )


def convection_diffusion_2d(
    nx: int, ny: int = None, cx: float = 0.5, cy: float = 0.25,
    dtype=np.float64,
) -> CSRMatrix:
    """Upwind convection-diffusion stencil: the standard NONSYMMETRIC
    model problem (diffusion 5-point Laplacian + first-order upwind
    convection with cell Peclet numbers ``cx``/``cy``).

    Row (i,j): diag ``4 + cx + cy``; west ``-1 - cx``; east ``-1``;
    north ``-1 - cy``; south ``-1``.  Row-diagonally dominant M-matrix,
    so BiCGStab/CGS converge — exercises the nonsymmetric solver paths
    (the reference's own nonsymmetric coverage is sherman1,
    test/cpp/bicgstab.cpp) over every storage format.
    """
    ny = nx if ny is None else ny
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0 + cx + cy)]

    west = ix > 0
    rows.append(idx[west]); cols.append(idx[west] - 1)
    vals.append(np.full(west.sum(), -1.0 - cx))
    east = ix < nx - 1
    rows.append(idx[east]); cols.append(idx[east] + 1)
    vals.append(np.full(east.sum(), -1.0))
    north = idx >= nx
    rows.append(idx[north]); cols.append(idx[north] - nx)
    vals.append(np.full(north.sum(), -1.0 - cy))
    south = idx < n - nx
    rows.append(idx[south]); cols.append(idx[south] + nx)
    vals.append(np.full(south.sum(), -1.0))

    return _sorted_csr(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        (n, n),
    )


def random_spd_csr(
    n: int, density: float = 0.05, seed: int = 0, dtype=np.float64
) -> CSRMatrix:
    """Random symmetric diagonally dominant (hence SPD) sparse matrix."""
    rng = np.random.default_rng(seed)
    nnz_target = max(int(n * n * density / 2), n)
    r = rng.integers(0, n, nnz_target)
    c = rng.integers(0, n, nnz_target)
    off = r != c
    r, c = r[off], c[off]
    v = rng.uniform(-1.0, 1.0, r.shape[0])
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    vals = np.concatenate([v, v])
    # dedup by summing, then add dominant diagonal
    coo = coo_from_arrays(rows, cols, vals, (n, n), dtype=np.float64)
    rr = np.asarray(coo.rows, np.int64)
    cc = np.asarray(coo.cols, np.int64)
    vv = np.asarray(coo.vals)
    row_abs = np.zeros(n)
    np.add.at(row_abs, rr, np.abs(vv))
    rows = np.concatenate([rr, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cc, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([vv, row_abs + 1.0])
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    return _sorted_csr(rows[order], cols[order], vals[order].astype(dtype), (n, n))


def _sorted_csr(rows, cols, vals, shape: Tuple[int, int]) -> CSRMatrix:
    key = rows * np.int64(shape[1]) + cols
    order = np.argsort(key, kind="stable")
    return _csr_from_sorted_host(rows[order], cols[order], vals[order], shape)


def laplace_3d_jittered(
    m: int, jitter: int = 8, seed: int = 0, dtype=np.float64,
    symmetric: bool = False, shift: float = 0.0,
) -> CSRMatrix:
    """7-point 3-D Laplacian whose off-diagonal COLUMN indices are
    randomly jittered by up to ``jitter`` — a "banded-broken random"
    pattern: the band locality survives but no diagonal structure does
    (DIA extraction fails, so it runs on the general CSR/ELL paths).
    The benchmark matrix class for unstructured-SpMV measurements.

    ``symmetric=True`` returns (A + A^T)/2 — same unstructured pattern
    class, but SPD(-ish, diagonally dominant), so CG applies and the
    in-solver SpMV rate is measurable through a Krylov loop.

    ``shift`` adds a constant to the diagonal.  The bare symmetrised
    operator is near-singular (interior row sums ~ 0, like a Neumann
    Laplacian), which f32 Krylov cannot solve to tight tolerances; a
    positive shift bounds the spectrum away from zero and makes the
    system genuinely solvable.  Only diagonal VALUES change — the
    sparsity pattern is identical to shift=0."""
    n = m ** 3
    i = np.arange(n)
    iz, iy, ix = i // (m * m), (i // m) % m, i % m
    rows, cols, vals = [i], [i], [np.full(n, 6.0 + shift)]
    rng = np.random.default_rng(seed)
    for off, valid in (
        (1, ix < m - 1), (-1, ix > 0),
        (m, iy < m - 1), (-m, iy > 0),
        (m * m, iz < m - 1), (-m * m, iz > 0),
    ):
        r = i[valid]
        c = np.clip(r + off + rng.integers(-jitter, jitter + 1, r.shape[0]), 0, n - 1)
        rows.append(r)
        cols.append(c)
        vals.append(np.full(r.shape[0], -1.0))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals)
    if symmetric:
        r, c, v = (
            np.concatenate([r, c]),
            np.concatenate([c, r]),
            np.concatenate([v, v]) * 0.5,
        )
    # jitter collisions sum like the reference's triplet addEntry (h:607-618)
    key = r * np.int64(n) + c
    order = np.argsort(key, kind="stable")
    key, r, c, v = key[order], r[order], c[order], v[order]
    uniq = np.ones(key.shape[0], bool)
    uniq[1:] = key[1:] != key[:-1]
    grp = np.cumsum(uniq) - 1
    v_sum = np.bincount(grp, weights=v)
    return _csr_from_sorted_host(r[uniq], c[uniq], v_sum.astype(dtype), (n, n))


def reservoir_3d(
    m: int, seed: int = 0, sigma: float = 1.0, peclet: float = 1.0,
    jitter: bool = False, dtype=np.float64,
) -> CSRMatrix:
    """Seeded NONSYMMETRIC reservoir-class system on an m^3 grid.

    A 7-point finite-volume operator: diffusion through faces whose
    transmissibility is the harmonic mean of a log-normal permeability
    field (``sigma`` is the log standard deviation — heterogeneous
    coefficients), plus first-order upwind convection by a random face
    flux of magnitude ``peclet`` times the face transmissibility, plus a
    small accumulation term on the diagonal.  Column-diagonally dominant
    M-matrix, so it is nonsingular and ILU(0)/SGS apply.

    ``jitter=True`` moves each off-diagonal entry's column by up to +-2
    (diagonal kept), an unstructured variant whose values no longer sit
    on the pattern they were computed for — elimination-based
    factorizations may then meet data-dependent zero pivots.
    """
    n = m ** 3
    rng = np.random.default_rng(seed)
    perm = np.exp(sigma * rng.standard_normal(n))
    i = np.arange(n, dtype=np.int64)
    coords = (i // (m * m), (i // m) % m, i % m)
    rows, cols, vals = [], [], []
    diag = np.zeros(n)
    for ax, stride in enumerate((m * m, m, 1)):
        lo = i[coords[ax] < m - 1]
        hi = lo + stride
        t = 2.0 * perm[lo] * perm[hi] / (perm[lo] + perm[hi])
        q = peclet * t * rng.uniform(-1.0, 1.0, lo.shape[0])
        out_lo = np.maximum(q, 0.0)   # flux lo -> hi, upwinded at lo
        out_hi = np.maximum(-q, 0.0)  # flux hi -> lo, upwinded at hi
        np.add.at(diag, lo, t + out_lo)
        np.add.at(diag, hi, t + out_hi)
        rows += [lo, hi]
        cols += [hi, lo]
        vals += [-(t + out_hi), -(t + out_lo)]
    diag += 1e-2 * float(np.mean(diag))
    r = np.concatenate(rows + [i])
    c = np.concatenate(cols + [i])
    v = np.concatenate(vals + [diag])
    if jitter:
        cj = np.clip(c + rng.integers(-2, 3, r.shape[0]), 0, n - 1)
        c = np.where((r != c) & (cj != r), cj, c)
    key = r * np.int64(n) + c
    order = np.argsort(key, kind="stable")
    key, r, c, v = key[order], r[order], c[order], v[order]
    uniq = np.ones(key.shape[0], bool)
    uniq[1:] = key[1:] != key[:-1]
    grp = np.cumsum(uniq) - 1
    v_sum = np.bincount(grp, weights=v)
    return _csr_from_sorted_host(r[uniq], c[uniq], v_sum.astype(dtype), (n, n))


def uniform_random_csr(
    n: int, per_row: int = 5, seed: int = 42, dtype=np.float64
) -> CSRMatrix:
    """Diagonal + ``per_row`` uniformly-random off-diagonal entries per
    row — the ZERO-locality adversarial pattern.  No permutation can
    recover structure from it (tile density is invariant under row/col
    reordering at ~nnz/n^2), so it is the worst case for every blocked
    or windowed layout — and equally for the reference's CSR loop, whose
    x accesses miss cache once per nnz at this scale (measured: its
    2M-row rate collapses 3.8x below its banded-matrix rate).  Used by
    the bench's honest worst-case entry and the format-selection tests.
    """
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n, dtype=np.int64), per_row + 1)
    c = np.empty((n, per_row + 1), np.int64)
    c[:, 0] = np.arange(n)
    c[:, 1:] = rng.integers(0, n, (n, per_row))
    c = c.reshape(-1)
    v = np.where(c == r, float(per_row + 1), -1.0)
    key = r * np.int64(n) + c
    order = np.argsort(key, kind="stable")
    key, r, c, v = key[order], r[order], c[order], v[order]
    uniq = np.ones(key.shape[0], bool)
    uniq[1:] = key[1:] != key[:-1]
    grp = np.cumsum(uniq) - 1
    v_sum = np.bincount(grp, weights=v)
    return _csr_from_sorted_host(r[uniq], c[uniq], v_sum.astype(dtype), (n, n))
