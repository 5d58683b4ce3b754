"""Deflated CG: remove the lowest modes from the Krylov iteration.

Beyond the reference (no equivalent there): for ill-conditioned SPD
systems — or sequences of solves with the same operator — CG's
iteration count is governed by the lowest eigenvalues.  Deflation
handles those k modes DIRECTLY with a small dense solve and runs CG in
the A-orthogonal complement, so the effective condition number becomes
lambda_max / lambda_{k+1} (Saad, Yeung, Erhel & Guyomarc'h, "A deflated
version of the conjugate gradient algorithm", SISC 21(5), 2000):

* ``lanczos_deflation_basis`` — m Lanczos steps with full
  reorthogonalisation (one (n, m) panel; the m x m tridiagonal eigen-
  solve is host-side), returning the k lowest Ritz vectors;
* ``deflated_cg`` — init-CG: the W-component of the initial residual is
  eliminated with one (k, k) Cholesky solve, and every search direction
  is A-orthogonalised against W (``p = P z + beta p`` with
  ``P z = z - W G^{-1} (AW)^T z``), which keeps ``W^T r = 0`` so the
  small solve never has to be repeated.

The per-iteration extra cost over plain CG is one (n, k) matmul pair
and one (k, k) triangular solve — negligible for k <= 64 — and the basis
is reusable across right-hand sides.  Every dense product pins
``precision=HIGHEST``: the default f32 matmul precision may be TF32 on
GPUs, which would break the A-orthogonality the method relies on.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

import dataclasses

from ..ops.spmv import as_operator, matvec_fn
from ..formats.reorder import ReorderedMatrix
from .types import RUNNING, SolveResult, SolverStatus, resolve_max_iterations

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


def _vdot(a, b):
    return jnp.vdot(a, b, precision=_HIGHEST)

__all__ = ["lanczos_deflation_basis", "deflated_cg"]


def lanczos_deflation_basis(
    a, n_vectors: int = 8, steps: Optional[int] = None, seed: int = 0,
    n: Optional[int] = None, residual_rtol: float = 0.1,
) -> jnp.ndarray:
    """Up to ``n_vectors`` CONVERGED lowest Ritz vectors of SPD ``a`` as
    an (n, k) panel, from ``steps`` (default ``4 * n_vectors``) Lanczos
    steps with full reorthogonalisation.

    Only Ritz pairs whose residual estimate ``|beta_m * Y[m-1, i]|`` is
    below ``residual_rtol * lambda_i`` are kept: deflating with an
    UNCONVERGED pair is worse than not deflating — the projection
    multiplies the pair's residual by ``1/lambda_i`` (the (k, k) Gram
    inverse), re-injecting large W-components every iteration (measured:
    8 unconverged pairs took the 1-D-Laplacian test from 128 plain-CG
    iterations to 224).  Isolated low modes (near-null spaces, the
    practical deflation case) converge in a few dozen steps; CLUSTERED
    low spectra (e.g. a 1-D Laplacian's) may yield k = 0 here — use an
    exact/precomputed basis for those, or more ``steps``.

    Full reorthogonalisation (two classical Gram-Schmidt passes per
    step against the whole stored panel) costs two (n, m) matmuls per
    step and keeps the Ritz vectors usable in f32, where
    plain Lanczos loses orthogonality within tens of steps.
    """
    a = as_operator(a)
    if n is None:
        if hasattr(a, "shape"):
            n = a.shape[0]
        else:
            raise ValueError(
                "lanczos_deflation_basis needs n= for callable operators"
            )
    if steps is not None:
        m = int(steps)
        if m > n:
            raise ValueError(f"steps={m} exceeds the system size n={n}")
    else:
        # default: 4 steps per requested vector, clamped to the system
        # size so small systems don't reject the documented defaults
        m = min(4 * int(n_vectors), n)
    m = max(min(m, n), 1)
    dtype = getattr(a, "dtype", jnp.float32)

    V, alphas, betas = _lanczos_panel(a, jnp.int32(seed), n, m, dtype)

    al = np.asarray(alphas, np.float64)
    be = np.asarray(betas, np.float64)
    t = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    evals, evecs = np.linalg.eigh(t)  # ascending
    res = np.abs(be[-1] * evecs[-1, :])  # per-pair residual estimates
    cand = np.arange(min(int(n_vectors), m))
    keep = cand[res[cand] < residual_rtol * np.maximum(evals[cand], 0.0)]
    if keep.shape[0] < int(n_vectors):
        import warnings

        warnings.warn(
            f"lanczos_deflation_basis: only {keep.shape[0]} of "
            f"{int(n_vectors)} requested Ritz pairs converged after "
            f"{m} steps (residual < {residual_rtol}*lambda); deflating "
            "with the converged subset.  More steps, or an exact basis, "
            "recover the rest.",
            RuntimeWarning,
            stacklevel=2,
        )
    y = jnp.asarray(evecs[:, keep].astype(np.asarray(V).dtype))
    w = _mm(V, y)  # (n, k) Ritz vectors (orthonormal up to Lanczos accuracy)
    return w / jnp.maximum(
        jnp.linalg.norm(w, axis=0, keepdims=True), 1e-30
    )


@partial(jax.jit, static_argnums=(2, 3, 4))
def _lanczos_panel(a, seed, n: int, m: int, dtype):
    matvec = matvec_fn(a)
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=dtype)
    v0 = v0 / jnp.linalg.norm(v0)
    V0 = jnp.zeros((n, m), dtype).at[:, 0].set(v0)

    def step(carry, j):
        V, beta_prev = carry
        v = V[:, j]
        w = matvec(v) - beta_prev * V[:, j - 1] * (j > 0)
        alpha = _vdot(v, w)
        w = w - alpha * v
        # two classical Gram-Schmidt passes against the stored panel
        # (columns > j are zero, so the full-panel matmul is safe)
        for _ in range(2):
            w = w - _mm(V, _mm(V.T, w))
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.maximum(beta, jnp.asarray(1e-30, dtype))
        V = jax.lax.cond(
            j + 1 < m, lambda: V.at[:, j + 1].set(v_next), lambda: V
        )
        return (V, beta), (alpha, beta)

    (V, _), (alphas, betas) = jax.lax.scan(
        step, (V0, jnp.asarray(0.0, dtype)), jnp.arange(m)
    )
    return V, alphas, betas


def deflated_cg(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    deflation_basis: Optional[jnp.ndarray] = None,
    n_deflate: int = 8,
    preconditioner=None,
) -> SolveResult:
    """Solve SPD ``a @ x = b`` with the lowest modes deflated.

    ``deflation_basis`` is an (n, k) panel W (build once with
    :func:`lanczos_deflation_basis` and reuse across solves with the
    same operator); when None, one is built with ``n_deflate`` vectors.
    ``preconditioner`` composes as in :func:`solvers.cg.cg`.
    """
    a = as_operator(a)
    if isinstance(a, ReorderedMatrix):
        # hoist the permutation ourselves (reorder_hoisted can't — the
        # DEFLATION BASIS rows must be permuted along with b/x0, or the
        # inner solve would deflate a scrambled subspace)
        bp = a.to_permuted(jnp.asarray(b))
        x0p = None if x0 is None else a.to_permuted(jnp.asarray(x0))
        wp = (
            None if deflation_basis is None
            else a.to_permuted(jnp.asarray(deflation_basis))
        )
        res = deflated_cg(
            a.inner, bp, x0p, max_iterations, epsilon,
            deflation_basis=wp, n_deflate=n_deflate,
            preconditioner=preconditioner,
        )
        return dataclasses.replace(res, x=a.from_permuted(res.x))
    n = b.shape[0]
    w = deflation_basis
    if w is None:
        w = lanczos_deflation_basis(a, n_vectors=n_deflate, n=n)
    if w.ndim != 2 or w.shape[0] != n:
        raise ValueError(
            f"deflation basis must be (n, k) = ({n}, *), got {w.shape}"
        )
    if w.shape[1] == 0:
        # nothing converged to deflate with — plain (P)CG, same result
        # contract (lanczos_deflation_basis already warned)
        from .cg import conjugate_gradient

        return conjugate_gradient(
            a, b, x0, max_iterations, epsilon,
            preconditioner=preconditioner,
        )
    if x0 is None:
        x0 = jnp.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    eps = jnp.asarray(epsilon, dtype=b.dtype)
    return _deflated_cg_loop(a, preconditioner, w, b, x0, eps, maxiter)


@partial(jax.jit, static_argnums=(6,))
def _deflated_cg_loop(a, precond, w, b, x0, eps, maxiter: int) -> SolveResult:
    matvec = matvec_fn(a)
    eps2 = eps * eps

    def mapply(r):
        return r if precond is None else precond.apply(r)

    aw = matvec(w)                       # (n, k): rmult broadcasts panels
    g = _mm(w.T, aw)                     # (k, k) SPD Gram matrix
    cho = jax.scipy.linalg.cho_factor(g)

    def gsolve(u):
        return jax.scipy.linalg.cho_solve(cho, u)

    def project(z):
        # P z = z - W G^{-1} (AW)^T z  =>  (AW)^T P z = 0
        return z - _mm(w, gsolve(_mm(aw.T, z)))

    # init-CG: eliminate the W-component of the initial residual with
    # one small dense solve; afterwards W^T r = 0 and the projected
    # directions keep it so
    r = b - matvec(x0)
    x0 = x0 + _mm(w, gsolve(_mm(w.T, r)))
    r = b - matvec(x0)
    z = mapply(r)
    rz = _vdot(r, z)
    rr = _vdot(r, r)
    p = project(z)
    status0 = jnp.where(rr <= eps2, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )

    def cond(carry):
        _, _, _, _, _, k, status = carry
        return (status == RUNNING) & (k < maxiter)

    def body(carry):
        x, r, z, p, rz, k, status = carry
        ap = matvec(p)
        pap = _vdot(p, ap)
        alpha = rz / pap
        x = x + alpha * p
        r = r - alpha * ap
        # explicit residual re-projection: in exact arithmetic W^T r is
        # already 0, but in f32 the G^{-1} amplification (1/lambda_min)
        # lets rounding re-grow the deflated component until the solve
        # DIVERGES (measured on the near-null ring Laplacian); this one
        # (n, k) matmul pair per iteration keeps it pinned at roundoff
        r = r - _mm(aw, gsolve(_mm(w.T, r)))
        z = mapply(r)
        new_rz = _vdot(r, z)
        rr = _vdot(r, r)
        diverged = ~jnp.isfinite(rr)
        converged = rr <= eps2
        status = jnp.where(
            diverged,
            SolverStatus.DIVERGED,
            jnp.where(converged, SolverStatus.SUCCESS, RUNNING),
        ).astype(jnp.int32)
        beta = new_rz / rz
        p = project(z) + beta * p
        return x, r, z, p, new_rz, k + 1, status

    carry = (x0, r, z, p, rz, jnp.int32(0), status0)
    x, r, _, _, _, k, status = jax.lax.while_loop(cond, body, carry)
    status = jnp.where(
        status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status
    ).astype(jnp.int32)
    # final W-component correction: the iteration solved the projected
    # system; whatever deflated-space residual accumulated in finite
    # precision is eliminated with one more small dense solve
    rfin = b - matvec(x)
    coef = gsolve(_mm(w.T, rfin))
    x = x + _mm(w, coef)
    rfin = rfin - _mm(aw, coef)
    return SolveResult(
        x=x,
        status=status,
        iterations=k,
        residual_norm=jnp.sqrt(_vdot(rfin, rfin)),
        residual_trace=None,
    )
