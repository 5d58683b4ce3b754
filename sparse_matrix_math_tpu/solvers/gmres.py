"""Restarted GMRES — the general nonsymmetric workhorse, panel-shaped.

Beyond the reference (its nonsymmetric solvers are BiCGStab/CGS,
include/sparse_matrix_math.h:2109-2303; it has no minimal-residual
method).  With the Krylov panel V stored as an (m+1, n) matrix, each
Arnoldi orthogonalisation is two panel products (``V @ w`` then
``w - V.T @ h``, classical Gram-Schmidt twice — CGS2, the
communication-minimal variant), not m sequential dot/axpy pairs.

Every dense product here pins ``precision=HIGHEST``: the default f32
matmul precision may be TF32 on GPUs, which would cost the basis its
orthogonality.

Design points:

* fixed shapes under ``jit``: every restart cycle runs exactly ``m``
  Arnoldi steps as a ``fori_loop``; steps after in-cycle convergence
  freeze (H gets a unit diagonal, g a zero entry, so the final
  triangular solve yields y_j = 0 for them) — no dynamic shapes;
* Givens rotations applied on the fly keep a running residual estimate
  ``|g[j+1]|``, so the restart loop stops without forming residuals;
* RIGHT preconditioning (solve ``A M^{-1} u = b``, ``x = M^{-1} u``):
  the running estimate then tracks the TRUE residual norm, matching the
  library-wide ||b - A x|| <= eps convergence contract.  The
  preconditioner applies once per Arnoldi step and once per restart on
  the correction (V is stored unpreconditioned).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.spmv import as_operator, matvec_fn
from ..formats.reorder import reorder_hoisted
from .types import harmonize_dtypes, RUNNING, SolveResult, SolverStatus, resolve_max_iterations

__all__ = ["gmres", "gmres_core", "arnoldi_basis"]

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


def _cgs2(Vj, w, paneldot):
    """Classical Gram-Schmidt twice: w orthogonalised against the rows
    of ``Vj``; returns (w, h) with h the projection coefficients."""
    h = paneldot(Vj, w)
    w = w - _mm(Vj.T, h)
    h2 = paneldot(Vj, w)
    return w - _mm(Vj.T, h2), h + h2


@reorder_hoisted
def gmres(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    restart: int = 32,
    preconditioner=None,
    record_residuals: bool = False,
    s_step: int = 1,
) -> SolveResult:
    """Solve ``a @ x = b`` (any invertible ``a``) by GMRES(restart).

    ``max_iterations`` counts ARNOLDI steps (matvecs), not cycles, so
    it is comparable with the other solvers' iteration counts; -1 means
    n as usual.  ``record_residuals`` records the per-step Givens
    residual estimates (free — GMRES tracks them anyway).

    ``s_step > 1`` switches to the communication-avoiding (s-step)
    Arnoldi: blocks of ``s_step`` scaled matrix powers orthogonalised
    TOGETHER (BCGS2 + CholQR2), so the basis panel is read twice per
    BLOCK instead of four times per STEP.  The panel passes dominate a
    GMRES step at scale, so s_step=4 cuts their traffic ~4x.
    Trade-offs: the residual estimate updates at
    block boundaries (the trace's intermediate slots stay NaN), the
    iteration cap is honored at block granularity (never exceeded;
    the solve may stop up to s-1 matvecs short), and the scaled
    monomial basis mildly worsens orthogonality — CholQR2 + the
    per-restart true residual keep it honest.  ``restart`` is rounded down
    to a multiple of ``s_step``.
    """
    a = as_operator(a)
    n = b.shape[0]
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    m = int(restart)
    if m < 1:
        raise ValueError(f"restart must be >= 1, got {restart}")
    m = min(m, n)
    maxiter = resolve_max_iterations(max_iterations, n)
    eps = jnp.asarray(epsilon, dtype=b.dtype)
    s = max(int(s_step), 1)
    if s > 1:
        if m >= s:
            m = (m // s) * s
        else:
            s = m
        return _ca_gmres_loop(
            a, preconditioner, b, x0, eps, m, s, maxiter,
            bool(record_residuals),
        )
    return _gmres_loop(
        a, preconditioner, b, x0, eps, m, maxiter,
        bool(record_residuals),
    )


@partial(jax.jit, static_argnums=(5, 6, 7))
def _gmres_loop(
    a, precond, b, x0, eps, m: int, maxiter: int, record: bool
) -> SolveResult:
    matvec = matvec_fn(a)

    def mapply(v):
        return v if precond is None else precond.apply(v)

    return gmres_core(
        matvec, mapply, lambda u, v: jnp.vdot(u, v, precision=_HIGHEST),
        _mm, b, x0, eps, m, maxiter, record,
    )


@partial(jax.jit, static_argnums=(2,))
def arnoldi_basis(a, b, m: int) -> jnp.ndarray:
    """The (m+1, n) orthonormal Krylov basis one GMRES(m) cycle from
    x0 = 0 builds for ``a`` (no preconditioner): the same CGS2 step as
    :func:`gmres_core`, exposed so its orthogonality can be checked."""
    matvec = matvec_fn(a)
    n = b.shape[0]
    V = jnp.zeros((m + 1, n), b.dtype).at[0].set(
        b / jnp.sqrt(jnp.vdot(b, b, precision=_HIGHEST))
    )
    for j in range(m):
        w, _ = _cgs2(V[: j + 1], matvec(V[j]), _mm)
        V = V.at[j + 1].set(w / jnp.sqrt(jnp.vdot(w, w, precision=_HIGHEST)))
    return V


def gmres_core(
    matvec, precond_apply, dotfn, paneldot, b, x0, eps,
    m: int, maxiter: int, record: bool,
) -> SolveResult:
    """GMRES(m) algorithm core with injectable reductions.

    ``dotfn(u, v)`` is the (global) inner product and ``paneldot(V, w)``
    the (global) panel contraction ``V @ w`` — on a mesh both psum over
    the row axis while ``V.T @ h`` stays shard-local, which is the whole
    distribution story (parallel/dist.py wires this into dist_solve).
    """
    n = b.shape[0]
    dtype = b.dtype
    mapply = precond_apply

    def cycle(x, k0, trace):
        """One GMRES(m) restart cycle from iterate ``x``.

        Steps past ``maxiter - k0`` freeze exactly like post-convergence
        steps, so the iteration cap is honored mid-cycle (the library
        contract: caps are counted in matvecs and respected).

        Returns (x_new, residual_estimate, steps_taken, trace)."""
        cap = maxiter - k0
        r = b - matvec(x)
        beta = jnp.sqrt(dotfn(r, r))
        safe_beta = jnp.maximum(beta, jnp.asarray(1e-30, dtype))
        V = jnp.zeros((m + 1, n), dtype).at[0].set(r / safe_beta)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        rest = beta
        steps = jnp.int32(0)
        done = beta <= eps

        # BLOCKED Arnoldi: steps run in blocks of 8; within block bk the
        # CGS2 panel contractions use the STATIC slice V[:8*(bk+1)]
        # instead of the whole (m+1, n) panel under a mask.  The panel
        # passes dominate a GMRES step at scale (4 full-panel passes =
        # ~1 GB/step at n=2M/m=32) and rows > j are zeros, so the masked
        # form paid ~2x the average traffic for nothing; the quantized
        # slice stays exact.  The block outer loop is the unroll
        # granularity: ceil(m/8) compiled step bodies (a fully per-j
        # unroll compiles far slower).
        def make_step(nrows: int):
            def step(j, carry):
                V, H, cs, sn, g, rest, steps, done, trace = carry
                frozen = done | (j >= cap)
                w = matvec(mapply(V[j]))
                Vj = jax.lax.slice(V, (0, 0), (nrows, n))
                w, h_low = _cgs2(Vj, w, paneldot)
                hj1 = jnp.sqrt(dotfn(w, w))
                V = V.at[j + 1].set(
                    jnp.where(
                        frozen, V[j + 1],
                        w / jnp.maximum(hj1, jnp.asarray(1e-30, dtype)),
                    )
                )

                # accumulated Givens rotations on the new column
                hcol = jnp.zeros((m + 1,), dtype).at[:nrows].set(h_low)
                hcol = hcol.at[j + 1].set(hj1)

                def rot(i, hc):
                    hi = cs[i] * hc[i] + sn[i] * hc[i + 1]
                    hi1 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                    return hc.at[i].set(hi).at[i + 1].set(hi1)

                hcol = jax.lax.fori_loop(0, j, rot, hcol)
                # new rotation zeroing hcol[j+1]
                denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                safe = jnp.maximum(denom, jnp.asarray(1e-30, dtype))
                c, s = hcol[j] / safe, hcol[j + 1] / safe
                # `safe` also guards the R diagonal: an exact Krylov
                # breakdown (h_{j+1,j} = hcol_j = 0, the "lucky" case)
                # otherwise writes a zero pivot and NaNs the solve
                hcol = hcol.at[j].set(safe).at[j + 1].set(0.0)
                gj = c * g[j]
                gj1 = -s * g[j]

                # frozen steps write an identity column (and a zero g
                # entry) so the triangular solve returns y_j = 0 for them
                unit = jnp.zeros((m + 1,), dtype).at[j].set(1.0)
                H = H.at[:, j].set(jnp.where(frozen, unit, hcol))
                cs = cs.at[j].set(jnp.where(frozen, 1.0, c))
                sn = sn.at[j].set(jnp.where(frozen, 0.0, s))
                g = jnp.where(
                    frozen,
                    g.at[j].set(0.0),
                    g.at[j].set(gj).at[j + 1].set(gj1),
                )
                rest = jnp.where(frozen, rest, jnp.abs(gj1))
                steps = jnp.where(frozen, steps, (j + 1).astype(jnp.int32))
                if trace is not None:
                    trace = jnp.where(
                        frozen, trace,
                        trace.at[k0 + j + 1].set(jnp.abs(gj1)),
                    )
                done = done | (rest <= eps)
                return V, H, cs, sn, g, rest, steps, done, trace

            return step

        carry = (V, H, cs, sn, g, rest, steps, done, trace)
        for bk in range(-(-m // 8)):
            lo, hi = 8 * bk, min(8 * (bk + 1), m)
            carry = jax.lax.fori_loop(
                lo, hi, make_step(min(hi, m + 1)), carry
            )
        V, H, cs, sn, g, rest, steps, done, trace = carry
        # y = R^{-1} g over the rotated (upper-triangular) H
        y = jax.scipy.linalg.solve_triangular(H[:m, :], g[:m], lower=False)
        x = x + mapply(_mm(V[:m].T, y))
        return x, rest, steps, trace

    def cond(carry):
        _, res, k, status, _ = carry
        return (status == RUNNING) & (k < maxiter)

    def body(carry):
        x, _, k, status, trace = carry
        x, res, steps, trace = cycle(x, k, trace)
        k = k + steps
        # VERIFIED convergence (library-wide contract): the running
        # estimate drifts from ||b - A x|| in f32 at scale (3.6x
        # optimistic at n=2M) — one extra matvec per
        # cycle confirms a claim or sends the loop into another
        # restart; residual_norm always reports the TRUE norm.
        r_t = b - matvec(x)
        true_n = jnp.sqrt(dotfn(r_t, r_t))
        diverged = ~jnp.isfinite(res) | ~jnp.isfinite(true_n)
        status = jnp.where(
            diverged,
            SolverStatus.DIVERGED,
            jnp.where(
                (res <= eps) & (true_n <= eps),
                SolverStatus.SUCCESS,
                RUNNING,
            ),
        ).astype(jnp.int32)
        return x, true_n, k, status, trace

    r0 = b - matvec(x0)
    res0 = jnp.sqrt(dotfn(r0, r0))
    status0 = jnp.where(res0 <= eps, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )
    trace0 = (
        jnp.full((maxiter + 1,), jnp.nan, dtype).at[0].set(res0)
        if record else None
    )
    carry = (x0, res0, jnp.int32(0), status0, trace0)
    x, res, k, status, trace = jax.lax.while_loop(cond, body, carry)
    status = jnp.where(
        status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status
    ).astype(jnp.int32)
    return SolveResult(
        x=x,
        status=status,
        iterations=k,
        residual_norm=res,
        residual_trace=trace,
    )


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _ca_gmres_loop(
    a, precond, b, x0, eps, m: int, s: int, maxiter: int, record: bool
) -> SolveResult:
    """Communication-avoiding GMRES(m) with s-step blocks.

    Each block: ``s`` scaled matrix powers (z_k = A z_{k-1} / ||.||, a
    pure matvec chain), ONE BCGS2 block-orthogonalisation against the
    live basis (two panel passes per block — vs CGS2's four per step)
    plus CholQR2 inside the block, and a reconstruction of the s new
    Hessenberg columns from the power/projection coefficients:

        z^{(k)} = V C[:,k-1] + Q R[:,k-1]        (orthogonalisation)
        A z^{(k-1)} = beta_k z^{(k)}             (power chain)
      => A v_last = beta_1 (V C[:,0] + Q R[:,0])
         A Q[:, :s-1] = (AZ - AV C[:, :s-1]) R^{-1}_{top}

    with AV's columns read back from the H columns already built — all
    (m+1)-sized dense algebra.  The residual estimate comes from a
    small least-squares solve per block (the Givens recurrence needs
    per-step columns); blocks after in-cycle convergence or past the
    matvec budget freeze exactly like the per-step code (unit
    H-columns at row col+1, so the final LS returns y = 0 for them).
    """
    matvec = matvec_fn(a)

    def mapply(v):
        return v if precond is None else precond.apply(v)

    n = b.shape[0]
    dtype = b.dtype
    tiny = jnp.asarray(1e-30, dtype)
    nblocks = m // s
    mach = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    def small_ls(Hsub, g):
        """y, ||g - Hsub y|| via QR (Hsub (rows, cols), rows > cols)."""
        q, rr = jnp.linalg.qr(Hsub, mode="reduced")
        y = jax.scipy.linalg.solve_triangular(
            rr, _mm(q.T, g), lower=False
        )
        resid = g - _mm(Hsub, y)
        return y, jnp.sqrt(jnp.sum(resid * resid))

    def cycle(x, k0, trace):
        budget = maxiter - k0
        r = b - matvec(x)
        beta = jnp.sqrt(jnp.vdot(r, r, precision=_HIGHEST))
        safe_beta = jnp.maximum(beta, tiny)
        V = jnp.zeros((m + 1, n), dtype).at[0].set(r / safe_beta)
        H = jnp.zeros((m + 1, m), dtype)
        done = beta <= eps
        est = beta
        steps = jnp.int32(0)

        for bi in range(nblocks):
            live = bi * s + 1
            run = (~done) & ((bi + 1) * s <= budget)

            # LOCALLY-ORTHOGONALIZED power chain (s matvecs): each new
            # vector is orthogonalized against the previous TWO chain
            # vectors (two dots + two axpys — no panel pass).  A scaled
            # MONOMIAL chain is numerically rank-deficient in f32 by
            # s=4 at bench scale (powers collapse onto the dominant
            # eigenvector: measured stall at n=2M conv-diff, NaN at
            # s=8); the local 3-term chain is exactly Lanczos for
            # symmetric A and conditions well for the mildly nonnormal
            # class.  The exact relation A z^{(k-1)} = beta_k z^{(k)} +
            # hd_k z^{(k-1)} + ho_k z^{(k-2)} is what the Hessenberg
            # reconstruction below consumes.
            zs, bcoef = [], []
            zp = V[live - 1]
            zprev = None
            for _ in range(s):
                t = matvec(mapply(zp))
                h_d = jnp.vdot(zp, t, precision=_HIGHEST)
                t = t - h_d * zp
                if zprev is not None:
                    h_o = jnp.vdot(zprev, t, precision=_HIGHEST)
                    t = t - h_o * zprev
                else:
                    h_o = jnp.zeros((), dtype)
                bk = jnp.sqrt(jnp.vdot(t, t, precision=_HIGHEST))
                znew = t / jnp.maximum(bk, tiny)
                zs.append(znew)
                bcoef.append((h_o, h_d, bk))
                zprev, zp = zp, znew
            Z = jnp.stack(zs)  # (s, n)

            # BCGS2 against the live basis (the two panel passes)
            Vl = jax.lax.slice(V, (0, 0), (live, n))
            C1 = _mm(Vl, Z.T)                  # (live, s)
            Zp = Z - _mm(C1.T, Vl)
            C2 = _mm(Vl, Zp.T)
            Zp = Zp - _mm(C2.T, Vl)
            C = C1 + C2

            # CholQR2 inside the block
            def cholqr(Y):
                G = _mm(Y, Y.T)
                ridge = 10.0 * mach * (jnp.trace(G) / s + tiny)
                L = jnp.linalg.cholesky(
                    G + ridge * jnp.eye(s, dtype=dtype)
                )
                Q = jax.scipy.linalg.solve_triangular(L, Y, lower=True)
                return Q, L

            Q1, L1 = cholqr(Zp)
            Q, L2 = cholqr(Q1)
            R = _mm(L1, L2).T  # upper: Z' (cols) = Q (cols) R

            Qw = jnp.where(run, Q, jax.lax.slice(V, (live, 0), (live + s, n)))
            V = V.at[live: live + s].set(Qw)

            # Hessenberg columns in the extended-basis coordinates.
            # zc_j = z^{(j)} in [V | Q] coordinates (zc_0 = e_{live-1});
            # azw_k = A z^{(k)} via the chain's exact 3-term relation.
            p = live + s
            ZC = jnp.concatenate([C, R], axis=0)        # (p, s)
            zc = [jnp.zeros((p,), dtype).at[live - 1].set(1.0)]
            zc += [ZC[:, j] for j in range(s)]
            azw = []
            for k in range(s):
                h_o, h_d, bk = bcoef[k]
                v = bk * zc[k + 1] + h_d * zc[k]
                if k >= 1:
                    v = v + h_o * zc[k - 1]
                azw.append(v)
            az0 = azw[0]                                # A v_{live-1}
            Hcols = jnp.zeros((m + 1, s), dtype).at[:p, 0].set(az0)
            if s > 1:
                AVW = jnp.zeros((p, live), dtype)
                if live > 1:
                    AVW = AVW.at[:, : live - 1].set(
                        jax.lax.slice(H, (0, 0), (p, live - 1))
                    )
                AVW = AVW.at[:, live - 1].set(az0)
                AZW = jnp.stack(azw[1:], axis=1)         # (p, s-1)
                X = AZW - _mm(AVW, C[:, : s - 1])
                r_top = R[: s - 1, : s - 1]
                AQW = jax.scipy.linalg.solve_triangular(
                    r_top.T, X.T, lower=True
                ).T                                      # X @ R_top^{-1}
                Hcols = Hcols.at[:p, 1:].set(AQW)
            unit = jnp.zeros((m + 1, s), dtype)
            for i in range(s):
                unit = unit.at[live + i, i].set(1.0)
            H = H.at[:, live - 1: live - 1 + s].set(
                jnp.where(run, Hcols, unit)
            )

            # block-boundary residual estimate (small LS)
            filled = live - 1 + s
            g = jnp.zeros((filled + 1,), dtype).at[0].set(beta)
            _, est_b = small_ls(
                jax.lax.slice(H, (0, 0), (filled + 1, filled)), g
            )
            est = jnp.where(run, est_b, est)
            steps = jnp.where(run, steps + s, steps)
            if trace is not None:
                trace = jnp.where(
                    run, trace.at[k0 + filled].set(est_b), trace
                )
            done = done | (est <= eps) | ~jnp.isfinite(est)

        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        y, _ = small_ls(H, g)
        x = x + mapply(_mm(V[:m].T, y))
        return x, est, steps, trace

    def cond(carry):
        _, res, k, status, _ = carry
        return (status == RUNNING) & (k + s <= maxiter)

    def body(carry):
        x, _, k, status, trace = carry
        x, res, steps, trace = cycle(x, k, trace)
        k = k + steps
        # verified convergence — the reconstructed-H estimate drifts
        # further than the Givens one (measured 3.6x at n=2M/f32);
        # see gmres_core.body
        r_t = b - matvec(x)
        true_n = jnp.sqrt(jnp.vdot(r_t, r_t, precision=_HIGHEST))
        status = jnp.where(
            ~jnp.isfinite(res) | ~jnp.isfinite(true_n),
            SolverStatus.DIVERGED,
            jnp.where(
                (res <= eps) & (true_n <= eps),
                SolverStatus.SUCCESS,
                RUNNING,
            ),
        ).astype(jnp.int32)
        return x, true_n, k, status, trace

    r0 = b - matvec(x0)
    res0 = jnp.sqrt(jnp.vdot(r0, r0, precision=_HIGHEST))
    status0 = jnp.where(res0 <= eps, SolverStatus.SUCCESS, RUNNING).astype(
        jnp.int32
    )
    trace0 = (
        jnp.full((maxiter + 1,), jnp.nan, dtype).at[0].set(res0)
        if record else None
    )
    carry = (x0, res0, jnp.int32(0), status0, trace0)
    x, res, k, status, trace = jax.lax.while_loop(cond, body, carry)
    status = jnp.where(
        status == RUNNING, SolverStatus.MAX_ITERATIONS_REACHED, status
    ).astype(jnp.int32)
    return SolveResult(
        x=x,
        status=status,
        iterations=k,
        residual_norm=res,
        residual_trace=trace,
    )
