"""RCM reordering pipeline (formats/reorder.py): scattered patterns are
renumbered to a narrow band; solvers hoist the permutation out of their
loops."""

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.csr import CSRMatrix, csr_from_dense
from sparse_matrix_math_tpu.formats.reorder import (
    ReorderedMatrix,
    _rcm_numpy,
    permute_csr,
    rcm_permutation,
    reorder_rcm,
)
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import poisson_2d


def _bandwidth(csr: CSRMatrix) -> int:
    r = np.asarray(csr.row_ids, np.int64)
    c = np.asarray(csr.indices, np.int64)
    return int(np.abs(r - c).max()) if r.size else 0


def _shuffle(csr: CSRMatrix, seed: int = 0) -> CSRMatrix:
    """Destroy locality with a random symmetric renumbering."""
    rng = np.random.default_rng(seed)
    return permute_csr(csr, rng.permutation(csr.shape[0]))


class TestPermutation:
    def test_permute_csr_matches_dense(self):
        a = poisson_2d(7, dtype=np.float64)
        perm = np.random.default_rng(1).permutation(49)
        ap = permute_csr(a, perm)
        dense = np.asarray(a.to_dense())
        np.testing.assert_array_equal(
            np.asarray(ap.to_dense()), dense[perm][:, perm]
        )

    def test_rcm_recovers_bandwidth(self):
        a = poisson_2d(24, dtype=np.float32)  # bandwidth 24
        shuffled = _shuffle(a, seed=2)  # bandwidth ~ n
        assert _bandwidth(shuffled) > 5 * _bandwidth(a)
        perm = rcm_permutation(shuffled)
        recovered = permute_csr(shuffled, perm)
        # RCM gets within a small factor of the grid bandwidth
        assert _bandwidth(recovered) <= 3 * _bandwidth(a)

    def test_numpy_fallback_rcm_quality(self):
        """The pure-NumPy BFS fallback must deliver comparable bandwidth
        to SciPy's implementation (it runs when SciPy is absent)."""
        a = _shuffle(poisson_2d(20, dtype=np.float32), seed=3)
        r = np.asarray(a.row_ids, np.int64)
        c = np.asarray(a.indices, np.int64)
        n = a.shape[0]
        keep = r != c
        key = np.unique(r[keep] * n + c[keep])
        rs, cs = key // n, key % n
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rs, minlength=n), out=indptr[1:])
        perm = _rcm_numpy(indptr, cs, n)
        assert sorted(perm) == list(range(n))
        assert _bandwidth(permute_csr(a, perm)) <= 4 * 20

    def test_rcm_disconnected_graph(self):
        """Components must all be visited (block-diagonal pattern)."""
        d = np.zeros((12, 12), np.float32)
        for b in range(3):  # 3 disconnected 4x4 tridiagonal blocks
            for i in range(4):
                d[4 * b + i, 4 * b + i] = 2.0
                if i:
                    d[4 * b + i, 4 * b + i - 1] = -1.0
                    d[4 * b + i - 1, 4 * b + i] = -1.0
        a = _shuffle(csr_from_dense(d), seed=4)
        perm = rcm_permutation(a)
        assert sorted(perm) == list(range(12))

    def test_rcm_rejects_rectangular(self):
        d = np.ones((4, 6), np.float32)
        with pytest.raises(ValueError):
            rcm_permutation(csr_from_dense(d))


class TestReorderedMatrix:
    def test_rmult_acts_as_original(self):
        a = _shuffle(poisson_2d(16, dtype=np.float32), seed=5)
        ro = reorder_rcm(a)
        assert isinstance(ro.inner, CSRMatrix)
        assert _bandwidth(ro.inner) < _bandwidth(a)
        x = jnp.asarray(
            np.random.default_rng(6).standard_normal(256).astype(np.float32)
        )
        np.testing.assert_allclose(
            np.asarray(ro @ x), np.asarray(a @ x), rtol=2e-5, atol=2e-5
        )

    def test_solver_hoisting_matches_direct(self):
        """cg on the ReorderedMatrix solves the ORIGINAL system — same
        solution and iteration count as cg on the raw CSR (the whole
        Krylov loop runs in the permuted domain)."""
        a = _shuffle(poisson_2d(16, dtype=np.float64), seed=7)
        ro = reorder_rcm(a)
        b = a @ jnp.ones(256)
        r1 = smm.cg(ro, b, epsilon=1e-10)
        r2 = smm.cg(a, b, epsilon=1e-10)
        assert int(r1.status) == SolverStatus.SUCCESS
        assert int(r1.iterations) == int(r2.iterations)
        np.testing.assert_allclose(np.asarray(r1.x), 1.0, atol=1e-8)

    def test_bicgstab_and_multi_rhs(self):
        a = _shuffle(poisson_2d(12, dtype=np.float64), seed=8)
        ro = reorder_rcm(a)
        b = a @ jnp.ones(144)
        rb = smm.bicgstab(ro, b, epsilon=1e-10)
        assert int(rb.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(rb.x), 1.0, atol=1e-7)
        bs = jnp.stack([b, 2.0 * b], axis=1)
        rm = smm.cg_multi(ro, bs, epsilon=1e-10)
        np.testing.assert_allclose(np.asarray(rm.x[:, 1]), 2.0, atol=1e-7)

    def test_best_format_keeps_csr_for_shuffled_pattern(self):
        # a shuffled stencil has no diagonal structure left: best_format
        # keeps it on CSR (reordering is an explicit choice, reorder_rcm)
        a = _shuffle(poisson_2d(30, dtype=np.float32), seed=9)
        assert smm.best_format(a) is a

    def test_solve_api_with_reordered(self):
        a = _shuffle(poisson_2d(16, dtype=np.float64), seed=10)
        ro = reorder_rcm(a)
        b = a @ jnp.ones(256)
        res = smm.solve(ro, b, method="cg", epsilon=1e-10)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)
        # named preconditioner: factored from the PERMUTED CSR so it acts
        # in the same domain the hoisted solver iterates in
        rp = smm.solve(ro, b, method="cg", preconditioner="jacobi", epsilon=1e-10)
        assert int(rp.status) == SolverStatus.SUCCESS
        assert int(rp.iterations) <= int(res.iterations) + 1
        np.testing.assert_allclose(np.asarray(rp.x), 1.0, atol=1e-8)
