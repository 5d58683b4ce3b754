"""Breakdown/DIVERGED paths and determinism — coverage the reference
lacks entirely (SURVEY §4 "coverage holes", §5 race-detection analogue)."""

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_dense
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import poisson_2d


class TestBreakdownPaths:
    def test_singular_matrix_does_not_hang(self):
        """A singular system must terminate with a non-SUCCESS status (the
        reference would loop to the cap or produce NaN silently)."""
        dense = np.zeros((8, 8))
        dense[np.arange(7), np.arange(7)] = 1.0  # last row/col all zero
        a = csr_from_dense(dense)
        b = jnp.ones(8, dtype=jnp.float64)
        for solver in (smm.cg, smm.bicg_symmetric, smm.cgs, smm.bicgstab):
            res = solver(a, b, max_iterations=50, epsilon=1e-10)
            assert int(res.status) in (
                SolverStatus.DIVERGED,
                SolverStatus.MAX_ITERATIONS_REACHED,
            ), solver.__name__

    def test_cg_exact_breakdown_reports_diverged(self):
        """CG on A = diag(1, -1), b = ones hits p.A.p = 0 exactly on the
        first iteration; the non-finite guard must convert the resulting
        inf into DIVERGED immediately — not SUCCESS, not a silent-NaN
        march to the iteration cap."""
        a = csr_from_dense(np.diag([1.0, -1.0]))
        b = jnp.asarray([1.0, 1.0], jnp.float64)
        res = smm.cg(a, b, max_iterations=100, epsilon=1e-12)
        assert int(res.status) == SolverStatus.DIVERGED
        assert int(res.iterations) == 1
        # the reported residual must be consistent with the failure claim
        assert not bool(res.residual_norm <= 1e-12)

    def test_bicg_symmetric_serious_breakdown_fires(self):
        """The reference's serious-breakdown heuristic (h:2047-2058):
        |Ap.p| < eps while ||r||^2 > 1 => DIVERGED.  A = diag(1, -1),
        b = ones gives p.A.p = 0 exactly with ||r||^2 = 2 on the first
        iteration, so the heuristic MUST fire there."""
        a = csr_from_dense(np.diag([1.0, -1.0]))
        b = jnp.asarray([1.0, 1.0])
        res = smm.bicg_symmetric(a, b, max_iterations=10, epsilon=1e-10)
        assert int(res.status) == SolverStatus.DIVERGED
        assert int(res.iterations) == 1
        # updates are masked out on serious breakdown: x stays at x0 = 0
        np.testing.assert_array_equal(np.asarray(res.x), np.zeros(2))

    def test_bicg_symmetric_critical_breakdown_fires(self):
        """The reference's critical-breakdown heuristic (h:2073-2081):
        ||r'||^2 > 1 right after ||r||^2 < eps => DIVERGED.  Driven
        directly through the algorithm core with a mock matvec so the
        second iteration's residual explodes."""
        from sparse_matrix_math_tpu.ops.vector import dot as _dot
        from sparse_matrix_math_tpu.solvers.bicg_symmetric import (
            bicg_symmetric_core,
        )

        # b (hence r0) is tiny: rr0 = 2e-14 < eps = 1e-5.  Matvecs of
        # the zero vector (the r0 computation AND the round-4 outer
        # loop's round-entry recompute) return 0, as any linear operator
        # must; the in-loop matvec of p (nonzero) returns a vector
        # nearly orthogonal to p, so alpha = rr/(ap.p) is huge and
        # alpha*ap blows ||r'||^2 past 1 while the old rr < eps.
        def matvec(v):
            zero_in = jnp.all(v == 0)
            return jnp.where(
                zero_in,
                jnp.zeros_like(v),
                jnp.asarray([1.0, -1.0 + 1e-10], v.dtype),
            )

        b = jnp.asarray([1e-7, 1e-7], jnp.float64)
        res = bicg_symmetric_core(
            matvec, _dot, b, jnp.zeros_like(b),
            jnp.asarray(1e-5, b.dtype), 10, False,
        )
        assert int(res.status) == SolverStatus.DIVERGED
        assert int(res.iterations) == 1
        assert bool(jnp.isfinite(res.residual_norm))  # critical, not NaN


class TestDeterminism:
    """XLA reductions have a fixed order per compiled program, so repeated
    runs must be bit-identical (the equivalent of the reference's
    parallel_deterministic_reduce guarantee, h:305-328)."""

    def test_cg_bitwise_reproducible(self, dtype):
        a = poisson_2d(16, dtype=dtype)
        b = a @ jnp.ones(a.shape[0], dtype=dtype)
        r1 = smm.cg(a, b, epsilon=1e-6)
        r2 = smm.cg(a, b, epsilon=1e-6)
        np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))
        assert int(r1.iterations) == int(r2.iterations)
        assert float(r1.residual_norm) == float(r2.residual_norm)

    def test_spmv_bitwise_reproducible(self, dtype):
        a = poisson_2d(16, dtype=dtype)
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal(a.shape[0]).astype(dtype)
        )
        y1 = np.asarray(a @ x)
        y2 = np.asarray(a @ x)
        np.testing.assert_array_equal(y1, y2)


class TestVerifiedConvergence:
    """SUCCESS means the TRUE residual passed eps (VERDICT r2 item 1).

    The recurrence residual in every Krylov core drifts from
    ``||b - A x||`` in finite precision; the cores verify a convergence
    claim against the true residual before reporting SUCCESS.  An affine
    (deliberately inconsistent) operator makes recurrence and truth
    disagree by a controlled amount, exercising the refute/restart/stall
    machinery deterministically on any backend.
    """

    @staticmethod
    def _affine_matvec(offset):
        # matvec(v) = v + offset: the recurrence (which assumes
        # linearity) converges, the true residual stalls at ~||offset||
        def mv(v):
            return v + offset

        return mv

    @staticmethod
    def _cores():
        from sparse_matrix_math_tpu.solvers.bicg_symmetric import (
            bicg_symmetric_core,
        )
        from sparse_matrix_math_tpu.solvers.bicgstab import bicgstab_core
        from sparse_matrix_math_tpu.solvers.cg import cg_core, pcg_core
        from sparse_matrix_math_tpu.solvers.cgs import cgs_core

        def dot(u, v):
            return jnp.sum(u * v)

        ident = lambda v: v  # noqa: E731
        return {
            "cg": lambda mv, b, eps, it: cg_core(
                mv, dot, b, jnp.zeros_like(b), eps, it, False
            ),
            "pcg": lambda mv, b, eps, it: pcg_core(
                mv, ident, dot, b, jnp.zeros_like(b), eps, it, False
            ),
            "bicgstab": lambda mv, b, eps, it: bicgstab_core(
                mv, ident, dot, b, jnp.zeros_like(b), eps, it, False
            ),
            "bicg_symmetric": lambda mv, b, eps, it: bicg_symmetric_core(
                mv, dot, b, jnp.zeros_like(b), eps, it, False
            ),
            "cgs": lambda mv, b, eps, it: cgs_core(
                mv, dot, b, jnp.zeros_like(b), eps, it, False
            ),
        }

    @pytest.mark.parametrize(
        "name", ["cg", "pcg", "bicgstab", "bicg_symmetric", "cgs"]
    )
    def test_refuted_claim_is_not_success(self, name):
        """Recurrence says converged, true residual is ~1e-3 >> eps=1e-6:
        the core must NOT report SUCCESS, and residual_norm must be the
        true residual, not the drifted recurrence value."""
        n = 64
        rng = np.random.default_rng(0)
        b = jnp.asarray(rng.standard_normal(n), jnp.float64)
        offset = jnp.full((n,), 1e-3, jnp.float64)
        mv = self._affine_matvec(offset)
        eps = jnp.float64(1e-6)
        res = self._cores()[name](mv, b, eps, 200)
        assert int(res.status) != SolverStatus.SUCCESS, name
        true_norm = float(jnp.linalg.norm(b - mv(res.x)))
        assert float(res.residual_norm) == pytest.approx(
            true_norm, rel=1e-6
        ), name
        assert true_norm > 1e-6

    @pytest.mark.parametrize(
        "name", ["cg", "pcg", "bicgstab", "bicg_symmetric", "cgs"]
    )
    def test_success_claim_is_true(self, name):
        """On an honest operator SUCCESS still fires, and the reported
        residual_norm equals the true residual within roundoff."""
        n = 128
        a = poisson_2d(16)  # n=256... use explicit small grid
        dense = np.asarray(a.to_dense(), np.float64)
        n = dense.shape[0]
        amat = jnp.asarray(dense)
        mv = lambda v: amat @ v  # noqa: E731
        b = jnp.asarray(dense.sum(axis=1))  # all-ones oracle
        eps = jnp.float64(1e-8)
        res = self._cores()[name](mv, b, eps, 2 * n)
        assert int(res.status) == SolverStatus.SUCCESS, name
        true_norm = float(jnp.linalg.norm(b - mv(res.x)))
        assert true_norm <= 1e-8 * (1 + 1e-6), name

    def test_maxiter_reports_true_residual(self):
        """On an iteration-cap exit residual_norm must be ||b - A x||,
        not the recurrence value."""
        from sparse_matrix_math_tpu.solvers.cg import cg_core

        a = poisson_2d(32)
        dense = np.asarray(a.to_dense(), np.float64)
        amat = jnp.asarray(dense)
        mv = lambda v: amat @ v  # noqa: E731
        b = jnp.asarray(dense.sum(axis=1))

        def dot(u, v):
            return jnp.sum(u * v)

        res = cg_core(mv, dot, b, jnp.zeros_like(b), jnp.float64(1e-14), 5, False)
        assert int(res.status) == SolverStatus.MAX_ITERATIONS_REACHED
        true_norm = float(jnp.linalg.norm(b - mv(res.x)))
        assert float(res.residual_norm) == pytest.approx(true_norm, rel=1e-10)

    def test_bicgstab_noncon_returns_best_iterate(self):
        """Non-SUCCESS BiCGStab exits return the best TRUE-residual
        iterate seen (sampled every 64 iterations + at the cap), with
        residual_norm equal to that iterate's true residual — never the
        recurrence value or an exploded tail (measured at n=2M/f32 the
        unguarded tail reaches +inf; solvers/bicgstab.py docstring)."""
        from sparse_matrix_math_tpu import bicgstab

        a = poisson_2d(32, dtype=np.float64)
        n = a.shape[0]
        b = jnp.asarray(np.asarray(a.to_dense(), np.float64).sum(axis=1))
        res = bicgstab(a, b, max_iterations=7, epsilon=1e-14)
        assert int(res.status) == SolverStatus.MAX_ITERATIONS_REACHED
        true_norm = float(jnp.linalg.norm(b - a @ res.x))
        assert float(res.residual_norm) == pytest.approx(true_norm, rel=1e-9)
        # the returned iterate improves on the zero initial guess
        assert true_norm < float(jnp.linalg.norm(b))
