"""SpMV kernel family across formats and operand combinations.

Mirrors the reference rMult/rMultAdd/rMultSub tests (test/cpp/csr.cpp:
258-523): the zero/nonzero operand combinations, empty-row handling, and
format-equivalence checks (CSR vs ELL vs DIA vs dense).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_matrix_math_tpu import (
    csr_from_dense,
    dia_from_csr,
    ell_from_csr,
    rmult,
    rmult_add,
    rmult_sub,
)
from sparse_matrix_math_tpu.utils import poisson_2d, random_spd_csr


@pytest.fixture
def dense_and_csr(dtype):
    rng = np.random.default_rng(42)
    dense = rng.normal(size=(6, 6)).astype(dtype)
    dense[dense < 0.3] = 0.0  # sparsify, leaves some empty rows/cols chance
    dense[2, :] = 0.0  # force an empty row
    return dense, csr_from_dense(dense)


def test_rmult_matches_dense(dense_and_csr, dtype):
    dense, m = dense_and_csr
    x = np.arange(6, dtype=dtype)
    np.testing.assert_allclose(
        np.asarray(rmult(m, jnp.asarray(x))), dense @ x, rtol=1e-5
    )


def test_rmult_add_sub(dense_and_csr, dtype):
    dense, m = dense_and_csr
    x = np.linspace(-1, 1, 6).astype(dtype)
    lhs = np.ones(6, dtype=dtype)
    np.testing.assert_allclose(
        np.asarray(rmult_add(m, jnp.asarray(lhs), jnp.asarray(x))),
        lhs + dense @ x,
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(rmult_sub(m, jnp.asarray(lhs), jnp.asarray(x))),
        lhs - dense @ x,
        rtol=1e-5,
    )


def test_zero_operand_combinations(dense_and_csr, dtype):
    # reference csr.cpp:258-523 cycles zero/non-zero lhs/mult combos
    dense, m = dense_and_csr
    zeros = jnp.zeros(6, dtype=dtype)
    ones = jnp.ones(6, dtype=dtype)
    np.testing.assert_allclose(np.asarray(rmult(m, zeros)), np.zeros(6))
    np.testing.assert_allclose(
        np.asarray(rmult_add(m, zeros, zeros)), np.zeros(6)
    )
    np.testing.assert_allclose(
        np.asarray(rmult_add(m, ones, zeros)), np.ones(6)
    )
    np.testing.assert_allclose(
        np.asarray(rmult_sub(m, zeros, ones)), -(dense @ np.ones(6)), rtol=1e-5
    )


def test_empty_rows_produce_lhs(dense_and_csr, dtype):
    # empty rows contribute op(lhs, 0) exactly (reference h:1479-1483)
    dense, m = dense_and_csr
    lhs = jnp.full((6,), 5.0, dtype=dtype)
    x = jnp.ones(6, dtype=dtype)
    out = np.asarray(rmult_add(m, lhs, x))
    assert out[2] == pytest.approx(5.0)


def test_ell_dia_equivalence(dtype):
    a = poisson_2d(7, 5, dtype=dtype)
    x = jnp.asarray(np.random.default_rng(1).normal(size=35).astype(dtype))
    y_csr = np.asarray(rmult(a, x))
    ell = ell_from_csr(a)
    dia = dia_from_csr(a)
    np.testing.assert_allclose(np.asarray(rmult(ell, x)), y_csr, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rmult(dia, x)), y_csr, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ell.to_dense()), np.asarray(a.to_dense()))
    np.testing.assert_allclose(np.asarray(dia.to_dense()), np.asarray(a.to_dense()))


def test_random_matrix_ell_equivalence(dtype):
    a = random_spd_csr(50, density=0.1, seed=3, dtype=dtype)
    x = jnp.asarray(np.random.default_rng(2).normal(size=50).astype(dtype))
    np.testing.assert_allclose(
        np.asarray(rmult(ell_from_csr(a), x)),
        np.asarray(rmult(a, x)),
        rtol=1e-4,
    )


def test_rmult_dense_and_callable():
    dense = jnp.asarray(np.eye(3) * 2.0)
    x = jnp.asarray([1.0, 2.0, 3.0])
    np.testing.assert_allclose(np.asarray(rmult(dense, x)), [2, 4, 6])
    np.testing.assert_allclose(np.asarray(rmult(lambda v: 3 * v, x)), [3, 6, 9])


def test_rmult_under_jit_and_grad():
    import jax

    a = poisson_2d(4, 4)
    x = jnp.ones(16)

    def loss(v):
        return jnp.sum(rmult(a, v) ** 2)

    g = jax.grad(loss)(x)
    ad = np.asarray(a.to_dense())
    expected = 2 * ad.T @ (ad @ np.ones(16))
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-6)


class TestSpMM:
    """Multi-column SpMM (y = A @ X, X (n, k)) across all formats — an
    extension (block-Krylov building block)."""

    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_all_formats(self, k, dtype):
        from sparse_matrix_math_tpu.formats.dia import dia_from_csr
        from sparse_matrix_math_tpu.formats.ell import ell_from_csr
        from sparse_matrix_math_tpu.formats.hyb import hyb_from_csr
        from sparse_matrix_math_tpu.ops.spmv import rmult
        from sparse_matrix_math_tpu.utils.generate import poisson_2d

        a = poisson_2d(9, dtype=dtype)
        X = np.random.default_rng(0).standard_normal((81, k)).astype(dtype)
        ref = np.asarray(a.to_dense()) @ X
        tol = 1e-4 if dtype == np.float32 else 1e-11
        for m in (a, ell_from_csr(a), dia_from_csr(a), hyb_from_csr(a)):
            np.testing.assert_allclose(
                np.asarray(rmult(m, jnp.asarray(X))), ref, atol=tol,
                err_msg=type(m).__name__,
            )
