"""Deflated CG (solvers/deflated.py): init + projected directions.

Correctness bars: the deflated solve reaches the same solution as plain
CG; deflating an ISOLATED near-null mode (the practical case) slashes
the iteration count; unconverged Ritz pairs are filtered out rather
than poisoning the projection; and the basis is reusable across
right-hand sides.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_dense
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import laplace_1d, poisson_2d


def ring_laplacian(n: int, shift: float = 1e-6):
    """Periodic (ring) Laplacian + shift*I: singular-but-for-the-shift,
    with ONE isolated tiny eigenvalue (the constant mode at ``shift``;
    the next is 4 sin^2(pi/n) + shift, a gap ratio of thousands) — the
    canonical near-null-space deflation target."""
    d = np.zeros((n, n))
    idx = np.arange(n)
    d[idx, idx] = 2.0 + shift
    d[idx, (idx + 1) % n] = -1.0
    d[idx, (idx - 1) % n] = -1.0
    return csr_from_dense(d)


class TestDeflationBasis:
    def test_isolated_mode_converges_fast(self):
        """The near-null (constant) mode converges well before n steps
        (its Lanczos rate is set by the gap over the spectral WIDTH,
        (l2-l1)/(lmax-l1), not by how tiny l1 is)."""
        a = ring_laplacian(128, shift=1e-6)
        w = smm.lanczos_deflation_basis(a, n_vectors=1, steps=96)
        assert w.shape == (128, 1)
        ones = np.full(128, 1.0 / np.sqrt(128))
        assert abs(float(np.abs(ones @ np.asarray(w[:, 0])))) > 1 - 1e-8

    def test_unconverged_pairs_filtered_with_warning(self):
        """A clustered low spectrum (1-D Dirichlet Laplacian) cannot
        converge 8 Ritz pairs in 64 steps — the basis must come back
        SMALLER (possibly empty), with a warning, never poisoned."""
        a = laplace_1d(256, dtype=np.float64)
        with pytest.warns(RuntimeWarning, match="converged"):
            w = smm.lanczos_deflation_basis(a, n_vectors=8, steps=64)
        assert w.shape[1] < 8

    def test_orthonormal_columns(self):
        a = ring_laplacian(96, shift=1e-5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            w = smm.lanczos_deflation_basis(a, n_vectors=2, steps=72)
        gram = np.asarray(w.T @ w)
        np.testing.assert_allclose(
            gram, np.eye(w.shape[1]), atol=1e-8
        )

    def test_rejects_steps_over_n(self):
        a = poisson_2d(3, dtype=np.float64)
        with pytest.raises(ValueError):
            smm.lanczos_deflation_basis(a, n_vectors=4, steps=100)


class TestDeflatedCG:
    def test_matches_cg_solution(self):
        a = poisson_2d(16, dtype=np.float64)
        n = a.shape[0]
        b = a @ jnp.ones(n, jnp.float64)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = smm.deflated_cg(a, b, epsilon=1e-10, n_deflate=4)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)

    def test_f32_near_null_mode(self):
        """The f32 case: plain CG on the near-null ring
        system needs ~2x the iterations and loses ~1 digit of solution
        accuracy to the tiny mode; the (stabilised) deflated solve
        converges in roughly the well-conditioned count with a visibly
        more accurate solution.  (In f64 a SINGLE outlier eigenvalue is
        nearly free for plain CG — its minimax polynomial spends one
        root on it — so deflation pays for mode CLUSTERS, reused bases,
        and low precision, not for one outlier in f64.)"""
        n = 128

        def ring32(shift):
            d = np.zeros((n, n))
            i = np.arange(n)
            d[i, i] = 2.0 + shift
            d[i, (i + 1) % n] = -1.0
            d[i, (i - 1) % n] = -1.0
            return csr_from_dense(d.astype(np.float32))

        a = ring32(1e-5)
        rng = np.random.default_rng(2)
        b64 = rng.standard_normal(n)
        b = jnp.asarray(b64.astype(np.float32))
        x_true = np.linalg.solve(
            np.asarray(a.to_dense(), np.float64), b64
        )
        scale = np.abs(x_true).max()
        plain = smm.cg(a, b, epsilon=1e-5, max_iterations=5000)
        w = smm.lanczos_deflation_basis(a, n_vectors=1, steps=96)
        defl = smm.deflated_cg(
            a, b, epsilon=1e-5, deflation_basis=w, max_iterations=5000
        )
        assert int(defl.status) == SolverStatus.SUCCESS
        assert int(defl.iterations) < int(plain.iterations)
        derr = np.abs(np.asarray(defl.x, np.float64) - x_true).max() / scale
        perr = np.abs(np.asarray(plain.x, np.float64) - x_true).max() / scale
        assert derr < 1e-3
        assert derr < perr / 3

    def test_exact_low_modes_reduce_iterations(self):
        """With an exact basis (the reusable-across-solves scenario),
        deflation helps even on a clustered spectrum."""
        a = laplace_1d(256, dtype=np.float64)
        b = a @ jnp.ones(256, jnp.float64)
        plain = smm.cg(a, b, epsilon=1e-10)
        evals, evecs = np.linalg.eigh(np.asarray(a.to_dense()))
        w = jnp.asarray(evecs[:, :16])
        defl = smm.deflated_cg(a, b, epsilon=1e-10, deflation_basis=w)
        assert int(defl.status) == SolverStatus.SUCCESS
        assert int(defl.iterations) < int(plain.iterations)
        np.testing.assert_allclose(np.asarray(defl.x), 1.0, atol=1e-7)

    def test_basis_reusable_across_rhs(self):
        n = 96
        a = ring_laplacian(n, shift=1e-5)
        w = smm.lanczos_deflation_basis(a, n_vectors=1, steps=72)
        rng = np.random.default_rng(5)
        for _ in range(2):
            xt = jnp.asarray(rng.standard_normal(n))
            res = smm.deflated_cg(
                a, a @ xt, epsilon=1e-8, deflation_basis=w,
                max_iterations=5000,
            )
            assert int(res.status) == SolverStatus.SUCCESS
            np.testing.assert_allclose(
                np.asarray(res.x), np.asarray(xt), atol=1e-4
            )

    def test_composes_with_preconditioner(self):
        from sparse_matrix_math_tpu.precond.preconditioners import (
            get_preconditioner,
        )

        n = 128
        a = ring_laplacian(n, shift=1e-6)
        b = a @ jnp.ones(n, jnp.float64)
        m = get_preconditioner(a, "sgs")
        pcg = smm.cg(a, b, preconditioner=m, epsilon=1e-8,
                     max_iterations=5000)
        w = smm.lanczos_deflation_basis(a, n_vectors=1, steps=96)
        defl = smm.deflated_cg(
            a, b, epsilon=1e-8, deflation_basis=w, preconditioner=m,
            max_iterations=5000,
        )
        assert int(defl.status) == SolverStatus.SUCCESS
        assert int(defl.iterations) < int(pcg.iterations)
        np.testing.assert_allclose(np.asarray(defl.x), 1.0, atol=1e-5)

    def test_empty_basis_degrades_to_plain_cg(self):
        a = poisson_2d(8, dtype=np.float64)
        b = a @ jnp.ones(64, jnp.float64)
        res = smm.deflated_cg(
            a, b, epsilon=1e-10,
            deflation_basis=jnp.zeros((64, 0), jnp.float64),
        )
        ref = smm.cg(a, b, epsilon=1e-10)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) == int(ref.iterations)

    def test_rejects_bad_basis_shape(self):
        a = poisson_2d(6, dtype=np.float64)
        b = jnp.ones(36, jnp.float64)
        with pytest.raises(ValueError):
            smm.deflated_cg(
                a, b, deflation_basis=jnp.ones((7, 2), jnp.float64)
            )


class TestDeflatedCGEdges:
    def test_small_system_default_steps_clamped(self):
        """n < 4*n_deflate must clamp the default Lanczos steps, not
        reject the documented defaults."""
        a = poisson_2d(5, dtype=np.float64)  # n = 25 < 32
        b = a @ jnp.ones(25, jnp.float64)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = smm.deflated_cg(a, b, epsilon=1e-10)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)

    def test_reordered_matrix_permutes_basis(self):
        """Over a ReorderedMatrix the user's deflation basis must be
        permuted with b/x0 — the solve must match the raw-CSR run."""
        from sparse_matrix_math_tpu.formats.reorder import (
            ReorderedMatrix, permute_csr, rcm_permutation,
        )

        n = 96
        a = ring_laplacian(n, shift=1e-5)
        rng = np.random.default_rng(3)
        p2 = rcm_permutation(a)
        inner = permute_csr(a, p2)
        ro = ReorderedMatrix(
            inner=inner, inner_csr=inner,
            perm=jnp.asarray(p2.astype(np.int32)),
            iperm=jnp.asarray(np.argsort(p2).astype(np.int32)),
            shape=a.shape, nnz=a.nnz,
        )
        # basis in the OPERATOR'S (original) row order, as a user would
        # build it; deflated_cg must permute it alongside b/x0
        w = smm.lanczos_deflation_basis(a, n_vectors=1, steps=72)
        b = jnp.asarray(rng.standard_normal(n))
        ref = smm.deflated_cg(a, b, epsilon=1e-8,
                              deflation_basis=w, max_iterations=5000)
        got = smm.deflated_cg(ro, b, epsilon=1e-8,
                              deflation_basis=w, max_iterations=5000)
        assert int(got.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(
            np.asarray(got.x), np.asarray(ref.x), rtol=1e-5, atol=1e-6
        )
