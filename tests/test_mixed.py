"""Mixed-precision (bf16-matrix) CG — solvers/mixed.py.

The contract under test: convergence is judged on the TRUE f32 residual,
so a SUCCESS from mixed_cg means the same thing as a SUCCESS from cg.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_matrix_math_tpu import SolverStatus, cg, mixed_cg, rmult, solve
from sparse_matrix_math_tpu.formats.dia import try_dia_from_csr
from sparse_matrix_math_tpu.utils.generate import poisson_2d


@pytest.fixture(scope="module")
def poisson_dia():
    csr = poisson_2d(24, dtype=np.float32)
    dia = try_dia_from_csr(csr)
    assert dia is not None
    return csr, dia


class TestMixedCG:
    def test_exactly_representable_matches_cg(self, poisson_dia):
        """Poisson values (4, -1) are exact in bf16: the inner operator
        equals the f32 operator and mixed_cg reproduces cg's solution."""
        csr, dia = poisson_dia
        b = rmult(csr, jnp.ones(csr.shape[0], jnp.float32))
        ref = cg(dia, b, epsilon=1e-5)
        res = mixed_cg(dia, b, epsilon=1e-5)
        assert int(res.status) == int(SolverStatus.SUCCESS)
        assert float(res.residual_norm) <= 1e-5
        np.testing.assert_allclose(
            np.asarray(res.x), np.asarray(ref.x), atol=5e-4, rtol=1e-3
        )

    def test_true_residual_reported(self, poisson_dia):
        """residual_norm must be the f32-operator residual, recomputed —
        not the inner (low-precision) solver's claim."""
        csr, dia = poisson_dia
        b = rmult(csr, jnp.ones(csr.shape[0], jnp.float32))
        res = mixed_cg(dia, b, epsilon=1e-5)
        r = np.asarray(b - rmult(csr, res.x))
        assert abs(np.linalg.norm(r) - float(res.residual_norm)) <= 2e-5

    def test_general_values_refine_past_bf16_floor(self):
        """Values with full f32 mantissas: one bf16 solve alone stalls at
        the ~2^-8 perturbation floor; the IR outer loop must still reach
        the f32 tolerance."""
        rng = np.random.default_rng(7)
        n = 24 * 24
        csr = poisson_2d(24, dtype=np.float32)
        # scale rows+cols symmetrically by irrational-ish factors: SPD is
        # preserved (D A D), every value picks up full mantissa bits
        d = (1.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
        dense = np.asarray(csr.to_dense()) * np.outer(d, d)
        from sparse_matrix_math_tpu import csr_from_dense

        dia = try_dia_from_csr(csr_from_dense(dense.astype(np.float32)))
        assert dia is not None
        x_true = rng.standard_normal(n).astype(np.float32)
        b = jnp.asarray(dense @ x_true)
        eps = 1e-4 * float(np.linalg.norm(np.asarray(b)))
        res = mixed_cg(dia, b, epsilon=eps, max_iterations=5000)
        assert int(res.status) == int(SolverStatus.SUCCESS)
        r = np.asarray(b) - dense @ np.asarray(res.x)
        assert np.linalg.norm(r) <= eps * 1.1

    def test_budget_exhaustion_reports_maxiter(self, poisson_dia):
        csr, dia = poisson_dia
        b = rmult(csr, jnp.ones(csr.shape[0], jnp.float32))
        res = mixed_cg(dia, b, epsilon=1e-6, max_iterations=3)
        assert int(res.status) == int(SolverStatus.MAX_ITERATIONS_REACHED)

    def test_rejects_csr(self, poisson_dia):
        csr, _ = poisson_dia
        b = jnp.ones(csr.shape[0], jnp.float32)
        with pytest.raises(ValueError, match="DIA"):
            mixed_cg(csr, b)

    def test_solve_config_routing(self, poisson_dia):
        csr, dia = poisson_dia
        b = rmult(csr, jnp.ones(csr.shape[0], jnp.float32))
        res = solve(dia, b, method="cg", matrix_dtype="bfloat16", epsilon=1e-5)
        assert int(res.status) == int(SolverStatus.SUCCESS)
        with pytest.raises(ValueError, match="cg"):
            solve(dia, b, method="bicgstab", matrix_dtype="bfloat16")
        with pytest.raises(ValueError, match="preconditioner"):
            solve(dia, b, matrix_dtype="bfloat16", preconditioner="jacobi")


def test_solve_bf16_narrow_stencil_no_warning(poisson_dia):
    """solve(matrix_dtype='bfloat16') on a narrow stencil runs the bf16
    diagonal stream silently: whether it pays on a given card is a
    benchmark question, not a front-door warning."""
    import warnings

    _, dia = poisson_dia
    b = rmult(dia, jnp.ones((dia.shape[0],), jnp.float32))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = solve(
            dia, b, method="cg", epsilon=1e-3, matrix_dtype="bfloat16",
            auto_escalate=False,
        )
    assert not [w for w in caught if "matrix_dtype" in str(w.message)]
    assert int(res.status) == SolverStatus.SUCCESS
