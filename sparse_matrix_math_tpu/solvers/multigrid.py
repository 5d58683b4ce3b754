"""Geometric multigrid for 2-D/3-D Poisson-class grids (5/7-point).

The reference tops out at Krylov + one-level preconditioners, whose
iteration counts grow with the grid; the operator-aware answer is
multigrid: O(1)
V-cycles, each a handful of stencil applies, instead of O(sqrt(kappa))
Krylov iterations.  This module implements geometric MG for the
dimensionless 5/7-point Laplacian family that `utils.generate
.poisson_2d` / `poisson_3d` produce (diag 2d, neighbors -1, homogeneous
Dirichlet) — the benchmark system class:

* vectors live GRID-SHAPED ((ny, nx) or (nz, ny, nx)): every operator
  is a few shifted adds XLA fuses into bandwidth-bound elementwise
  code.  No gather;
* coarse operators are GALERKIN (A_c = P^T A P), kept in closed
  tensor-product form: with P = kron of per-axis prolongations and
  A = sum_ax kron(M_1, ..., L_ax, ..., M_d) (1-D tridiagonal factors,
  L = Laplacian-like, M = mass-like; at the finest level M = I), the
  Galerkin triple product stays in the same family with
  L' = P_ax^T L P_ax, M' = P_ax^T M P_ax — so every level is an exact
  Galerkin operator applied as d^2 one-axis tridiagonal stencils.
  Unlike rediscretisation this is geometry-exact for ANY side length
  (even, odd, anisotropic): no vertex-centred 2^k-1 restriction;
* smoothing: weighted Jacobi (omega = 4/5) with the level's TRUE
  operator diagonal (position-dependent on coarse levels);
* coarsest level: exact dense solve with a precomputed inverse;
* `PoissonMultigrid.solve` runs V-cycles in a jitted while_loop with
  the usual SolveResult statuses; `.apply(r)` is one V-cycle — a
  symmetric positive operation usable as a CG preconditioner.

Numerical contract (tests/test_multigrid.py): residual contraction
>= 4x per V-cycle on the model family, mesh-size independent, for
arbitrary grid dims (measured prototype rates: ~0.12/cycle 2-D,
~0.26/cycle 3-D, even and anisotropic sides included).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .types import RUNNING, SolveResult, SolverStatus

__all__ = ["PoissonMultigrid"]

# <= this many points per side -> exact dense solve; measured 2-D
# optimum is 31 (stopping at ~44 costs more in the dense coarse matmul
# than the saved small-grid level).  3-D stops earlier: the dense
# inverse is cubic in side length.
_COARSEST = {2: 31, 3: 12}


def _stencil_apply(x: jnp.ndarray) -> jnp.ndarray:
    """y = A x for the dimensionless 2d+1-point Laplacian on a
    grid-shaped x (homogeneous Dirichlet outside the grid) — the
    finest-level fast path (uniform stencil, M = I).  Written as padded
    shifts — one fused elementwise expression — rather than .at[].add
    updates, which lower to separate dynamic-update ops."""
    d = x.ndim
    p = jnp.pad(x, 1)
    y = (2.0 * d) * x
    for ax in range(d):
        lo = tuple(
            slice(0, -2) if a == ax else slice(1, -1) for a in range(d)
        )
        hi = tuple(
            slice(2, None) if a == ax else slice(1, -1) for a in range(d)
        )
        y = y - p[lo] - p[hi]
    return y


def _sl(x: jnp.ndarray, axis: int, start: int, limit: int, stride: int):
    """Strided slice along one axis — a single lax.slice, NO transpose.
    (moveaxis-based transfers cost a full transpose per call; profiled
    on hardware, the V-cycle was op-bound on exactly those.)"""
    starts = [0] * x.ndim
    limits = list(x.shape)
    strides = [1] * x.ndim
    starts[axis], limits[axis], strides[axis] = start, limit, stride
    return jax.lax.slice(x, starts, limits, strides)


def _pad_axis(x: jnp.ndarray, axis: int, lo: int, hi: int):
    pads = [(0, 0)] * x.ndim
    pads[axis] = (lo, hi)
    return jnp.pad(x, pads)


def _bcast(v: jnp.ndarray, ndim: int, axis: int) -> jnp.ndarray:
    """Reshape a 1-D coefficient vector to broadcast along ``axis`` of an
    ``ndim``-D grid."""
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def _tridiag_apply(x, diag, upper, axis: int):
    """Apply a symmetric tridiagonal operator along one grid axis:
    y_i = diag_i x_i + upper_i x_{i+1} + upper_{i-1} x_{i-1}
    (``upper`` has length n with upper_{n-1} = 0) — three shifted
    multiplies XLA fuses; transpose-free."""
    n = x.shape[axis]
    d = _bcast(diag, x.ndim, axis)
    u = _bcast(upper, x.ndim, axis)
    lo = _bcast(jnp.pad(upper[:-1], (1, 0)), x.ndim, axis)  # upper_{i-1}
    x_up = _pad_axis(_sl(x, axis, 1, n, 1), axis, 0, 1)  # x_{i+1}
    x_dn = _pad_axis(_sl(x, axis, 0, n - 1, 1), axis, 1, 0)  # x_{i-1}
    return d * x + u * x_up + lo * x_dn


def _prolong_1d(c: jnp.ndarray, nf: int, axis: int) -> jnp.ndarray:
    """Bilinear interpolation along ``axis``: coarse node j sits at fine
    index 2j+1; even fine indices average their coarse neighbors
    (Dirichlet zeros beyond the ends).  Built transpose-free: the even
    and odd fine sequences interleave via stack+reshape."""
    nc = c.shape[axis]
    cpad = _pad_axis(c, axis, 1, 1)
    n_even = (nf + 1) // 2  # fine indices 0, 2, 4, ...
    even = 0.5 * (
        _sl(cpad, axis, 0, n_even, 1) + _sl(cpad, axis, 1, n_even + 1, 1)
    )
    odd = c if nc == n_even else _pad_axis(c, axis, 0, n_even - nc)
    pair = jnp.stack([even, odd], axis=axis + 1)
    shape = list(c.shape)
    shape[axis] = 2 * n_even
    out = pair.reshape(shape)
    return _sl(out, axis, 0, nf, 1)


def _restrict_1d(f: jnp.ndarray, nc: int, axis: int) -> jnp.ndarray:
    """Adjoint of :func:`_prolong_1d` (exact P^T, matching the Galerkin
    coarse operators): rc[j] = f[2j+1] + 0.5 f[2j] + 0.5 f[2j+2]."""
    fpad = _pad_axis(f, axis, 0, 2)
    center = _sl(f, axis, 1, 2 * nc, 2)
    left = _sl(fpad, axis, 0, 2 * nc, 2)
    right = _sl(fpad, axis, 2, 2 * nc + 2, 2)
    return center + 0.5 * (left + right)


# -- host-side hierarchy construction (NumPy, float64) -----------------------


def _prolong_matrix_np(nf: int, nc: int) -> np.ndarray:
    """Dense 1-D prolongation: column j has tap 1 at fine 2j+1 and taps
    0.5 at fine 2j, 2j+2 — the matrix _prolong_1d applies."""
    p = np.zeros((nf, nc))
    for j in range(nc):
        p[2 * j + 1, j] = 1.0
        p[2 * j, j] += 0.5
        if 2 * j + 2 < nf:
            p[2 * j + 2, j] += 0.5
    return p


def _lap1d_np(n: int) -> np.ndarray:
    lap = 2.0 * np.eye(n)
    lap -= np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    return lap


def _tri_vectors(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(diag, upper) of a symmetric tridiagonal matrix; upper padded to
    length n with a trailing zero."""
    n = t.shape[0]
    upper = np.zeros(n)
    if n > 1:
        upper[:-1] = np.diag(t, 1)
    return np.diag(t).copy(), upper


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoissonMultigrid:
    """Galerkin tensor-product V-cycle solver/preconditioner for
    `poisson_2d(nx, ny)` / `poisson_3d` systems.

    ``coarse_inv`` is the dense inverse of the coarsest-level operator.
    ``factors[l][ax] = (dL, uL, dM, uM)``: the 1-D tridiagonal Galerkin
    factors of intermediate level ``l+1`` (level 0 uses the uniform
    fused stencil), as (diag, upper) coefficient vectors.
    ``winv[l]``: grid-shaped omega / diag(A_{l+1}) Jacobi weights.
    The grid hierarchy is static (baked into the jitted cycle).
    """

    coarse_inv: jnp.ndarray
    factors: Tuple[Tuple[Tuple[jnp.ndarray, ...], ...], ...]
    winv: Tuple[jnp.ndarray, ...]
    dims: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    nu1: int = dataclasses.field(metadata=dict(static=True), default=2)
    nu2: int = dataclasses.field(metadata=dict(static=True), default=2)
    omega: float = dataclasses.field(metadata=dict(static=True), default=0.8)

    @classmethod
    def for_stencil(cls, st, **kw) -> "PoissonMultigrid":
        """Build the hierarchy for a :class:`~formats.stencil
        .GridStencilMatrix` that IS the dimensionless 2d+1-point
        Laplacian (center ``2d``, each unit axis neighbour ``-1`` —
        exactly what ``poisson_2d``/``poisson_3d`` produce).  Raises
        ``ValueError`` for any other stencil: the V-cycle's finest-level
        operator is hard-coded to this family, so silently accepting a
        different stencil would converge to the wrong system.

        This is what ``solve(a, b, preconditioner="multigrid")`` calls
        when ``a`` is a grid stencil (solvers/api.py)."""
        d = len(st.dims)
        coeffs = np.asarray(st.coeffs, np.float64)
        want = {(0,) * d: 2.0 * d}
        for ax in range(d):
            for s in (-1, 1):
                off = [0] * d
                off[ax] = s
                want[tuple(off)] = -1.0
        got = {tuple(o): float(c) for o, c in zip(st.doffs, coeffs)}
        if got != want:
            raise ValueError(
                "PoissonMultigrid.for_stencil: stencil is not the "
                f"dimensionless {2 * d + 1}-point Laplacian "
                f"(got offsets/coeffs {got})"
            )
        # for_grid's dims[0] is (ny, nx) / (nz, ny, nx) — map the
        # stencil's row-major dims onto that ordering exactly
        rev = tuple(int(m) for m in reversed(st.dims))
        return cls.for_grid(*rev, **kw)

    @classmethod
    def for_grid(
        cls, nx: int, ny: Optional[int] = None, nz: Optional[int] = None, *,
        nu1: int = 2, nu2: int = 2, omega: float = 0.8,
        dtype=jnp.float32,
    ) -> "PoissonMultigrid":
        """Build the hierarchy for an ``nx x ny`` (2-D) or
        ``nx x ny x nz`` (3-D) interior grid, matching the row-major
        node ordering of ``poisson_2d`` / ``poisson_3d``."""
        ny = nx if ny is None else ny
        if nz is None:
            dims = [(int(ny), int(nx))]
        else:
            dims = [(int(nz), int(ny), int(nx))]
        d = len(dims[0])
        coarsest = _COARSEST[d]
        # keep coarsening while the grid is large on ANY measure: the
        # per-side cap handles isotropic grids; the product cap keeps
        # anisotropic grids (e.g. 4096 x 16) from leaving a huge
        # "coarsest" level whose dense inverse would be O(n^2) memory
        while (
            min(dims[-1]) > coarsest or int(np.prod(dims[-1])) > 2048
        ) and min(dims[-1]) > 2:
            dims.append(tuple(m // 2 for m in dims[-1]))

        # Galerkin recursion on the 1-D factors (exact for any dims)
        level_mats = [[(_lap1d_np(n), np.eye(n)) for n in dims[0]]]
        for lvl in range(1, len(dims)):
            prev = level_mats[-1]
            cur = []
            for ax in range(d):
                p = _prolong_matrix_np(dims[lvl - 1][ax], dims[lvl][ax])
                lap, mass = prev[ax]
                cur.append((p.T @ lap @ p, p.T @ mass @ p))
            level_mats.append(cur)

        def as_dt(a):
            return jnp.asarray(a, dtype)

        factors = []
        winv = []
        for lvl in range(1, len(dims) - 1):  # intermediate levels only
            per_axis = []
            diag_grid = np.zeros(dims[lvl])
            for ax in range(d):
                lap, mass = level_mats[lvl][ax]
                dl, ul = _tri_vectors(lap)
                dm, um = _tri_vectors(mass)
                per_axis.append((as_dt(dl), as_dt(ul), as_dt(dm), as_dt(um)))
                vecs = [
                    np.diag(level_mats[lvl][a][0 if a == ax else 1])
                    for a in range(d)
                ]
                g = vecs[0]
                for v in vecs[1:]:
                    g = np.multiply.outer(g, v)
                diag_grid += g
            factors.append(tuple(per_axis))
            winv.append(as_dt(omega / diag_grid))

        # dense coarsest operator: sum over axes of kron(T_1, ..., T_d)
        cdims = dims[-1]
        n = int(np.prod(cdims))
        a = np.zeros((n, n))
        for ax in range(d):
            term = np.ones((1, 1))
            for aa in range(d):
                term = np.kron(term, level_mats[-1][aa][0 if aa == ax else 1])
            a += term
        inv = np.linalg.inv(a)
        return cls(
            coarse_inv=as_dt(inv),
            factors=tuple(factors),
            winv=tuple(winv),
            dims=tuple(dims),
            nu1=int(nu1), nu2=int(nu2), omega=float(omega),
        )

    # -- cycle ---------------------------------------------------------------

    def _apply(self, level: int, x: jnp.ndarray) -> jnp.ndarray:
        """y = A_level x.  Level 0: the uniform fused stencil; coarse
        levels: the Galerkin tensor operator — for each axis term,
        apply L along that axis and M along the others (d^2 tridiagonal
        passes, all shifted elementwise code)."""
        if level == 0:
            return _stencil_apply(x)
        per_axis = self.factors[level - 1]
        d = x.ndim
        y = None
        for ax in range(d):
            t = x
            for a in range(d):
                dl, ul, dm, um = per_axis[a]
                if a == ax:
                    t = _tridiag_apply(t, dl, ul, a)
                else:
                    t = _tridiag_apply(t, dm, um, a)
            y = t if y is None else y + t
        return y

    def _smooth(self, level: int, x, b, steps: int):
        if level == 0:
            w = self.omega / (2.0 * len(self.dims[0]))
            for _ in range(steps):
                x = x + w * (b - _stencil_apply(x))
            return x
        w = self.winv[level - 1]
        for _ in range(steps):
            x = x + w * (b - self._apply(level, x))
        return x

    def _vcycle(self, b, level: int):
        """One V-cycle for A e = b from a zero initial guess."""
        if level == len(self.dims) - 1:
            # pinned: the default f32 matmul precision may be TF32 on GPUs
            flat = jnp.matmul(
                self.coarse_inv, b.reshape(-1).astype(self.coarse_inv.dtype),
                precision=jax.lax.Precision.HIGHEST,
            )
            return flat.reshape(b.shape).astype(b.dtype)
        x = self._smooth(level, jnp.zeros_like(b), b, self.nu1)
        r = b - self._apply(level, x)
        rc = r
        for ax, m in enumerate(self.dims[level + 1]):
            rc = _restrict_1d(rc, m, ax)
        ec = self._vcycle(rc, level + 1)
        up = ec
        for ax, m in enumerate(self.dims[level]):
            up = _prolong_1d(up, m, ax)
        x = x + up
        return self._smooth(level, x, b, self.nu2)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        """One V-cycle as a linear operator z ~= A^{-1} r (flat in/out:
        usable directly as a CG preconditioner apply)."""
        return self._vcycle(r.reshape(self.dims[0]), 0).reshape(-1)

    def solve(
        self,
        b: jnp.ndarray,
        x0: Optional[jnp.ndarray] = None,
        max_iterations: int = 100,
        epsilon: float = 1e-8,
    ) -> SolveResult:
        """Stationary V-cycle iteration to ||r|| <= epsilon.

        With Galerkin coarse operators the stationary iteration
        contracts mesh-independently (~4-10x per cycle) for ARBITRARY
        grid sizes — even, odd, rectangular, 3-D.  A runaway guard
        (residual growth beyond 100x the initial) still reports
        DIVERGED if the operator is not from the supported Laplacian
        family.  The V-cycle also serves as a CG preconditioner
        (``cg(a, b, preconditioner=mg)``).
        """
        bg = b.reshape(self.dims[0])
        x0g = jnp.zeros_like(bg) if x0 is None else x0.reshape(self.dims[0])
        eps = jnp.asarray(epsilon, b.dtype)
        res = _mg_solve_jit(self, bg, x0g, eps, int(max_iterations))
        return dataclasses.replace(res, x=res.x.reshape(-1))


@partial(jax.jit, static_argnums=(4,))
def _mg_solve_jit(mg: PoissonMultigrid, b, x0, eps, maxiter: int) -> SolveResult:
    eps2 = eps * eps

    r0 = b - _stencil_apply(x0)
    rr0 = jnp.sum(r0 * r0)
    # runaway guard: catches mismatched operators (the cycle assumes the
    # dimensionless Laplacian family) rather than marching to the cap
    rr_cap = 1e4 * rr0 + jnp.asarray(1.0, rr0.dtype)

    def cond(carry):
        _, _, _, k, status = carry
        return (status == RUNNING) & (k < maxiter)

    def body(carry):
        x, r, _, k, status = carry
        x = x + mg._vcycle(r, 0)
        r = b - _stencil_apply(x)
        rr = jnp.sum(r * r)
        status = jnp.where(
            ~jnp.isfinite(rr) | (rr > rr_cap),
            SolverStatus.DIVERGED,
            jnp.where(rr <= eps2, SolverStatus.SUCCESS, RUNNING),
        ).astype(jnp.int32)
        return x, r, rr, k + 1, status

    init_status = jnp.where(rr0 <= eps2, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )
    x, _, rr, k, status = jax.lax.while_loop(
        cond, body, (x0, r0, rr0, jnp.int32(0), init_status)
    )
    status = jnp.where(status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status)
    return SolveResult(
        x=x,
        status=status.astype(jnp.int32),
        iterations=k,
        residual_norm=jnp.sqrt(rr),
        residual_trace=None,
    )
