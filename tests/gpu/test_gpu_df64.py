"""Card tests for the double-word (df64) arithmetic and solvers.

    SMM_GPU_TESTS=1 python -m pytest -m gpu tests/gpu -q

The suite runs with x64 enabled, so the error-free transforms route
through one native float64 operation and an exact re-split
(ops/df32.py ``_via_f64``); these tests check that route on the card,
inside fused loop bodies included.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("require_gpu")]


def test_eft_exactness():
    """two_sum/two_prod are EXACT: f32 +- f32 and f32 * f32 are exactly
    representable in host f64, so s + e == a + b and p + e == a * b
    bit-for-bit."""
    from sparse_matrix_math_tpu.ops.df32 import two_prod, two_sum

    rng = np.random.default_rng(0)
    a = (rng.standard_normal(8192) * 10.0 ** rng.integers(-6, 7, 8192)).astype(
        np.float32
    )
    b = (rng.standard_normal(8192) * 10.0 ** rng.integers(-6, 7, 8192)).astype(
        np.float32
    )
    s, e = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, a.astype(np.float64) + b.astype(np.float64))
    p, e = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, a.astype(np.float64) * b.astype(np.float64))


def test_eft_exactness_inside_loop_fusion():
    """The same exactness INSIDE a fused loop body, where an LLVM-based
    backend may contract mul+add pairs into FMAs."""
    from sparse_matrix_math_tpu.ops.df32 import df_add, two_prod

    rng = np.random.default_rng(1)
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)

    @jax.jit
    def accumulate(a, b):
        def body(i, acc):
            p, e = two_prod(a * (1.0 + 0.0 * i), b)
            return df_add(acc, (p, e))

        z = jnp.zeros_like(a)
        return jax.lax.fori_loop(0, 7, body, (z, z))

    hi, lo = accumulate(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    want = 7.0 * a.astype(np.float64) * b.astype(np.float64)
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)) < 1e-13


def test_cg_df64_poisson_1e10():
    """eps=1e-10 — far past plain f32's reach — verified on the host in
    f64 against the original operator."""
    from sparse_matrix_math_tpu import SolverStatus, cg_df64
    from sparse_matrix_math_tpu.ops.df32 import DfEllMatrix
    from sparse_matrix_math_tpu.utils import poisson_2d

    a = poisson_2d(48, dtype=np.float32)
    data = np.asarray(a.data, np.float64)
    indices = np.asarray(a.indices, np.int64)
    indptr = np.asarray(a.indptr, np.int64)
    n = a.shape[0]
    x_true = np.random.default_rng(0).standard_normal(n)
    b = np.add.reduceat(data * x_true[indices], indptr[:-1])
    dfa = DfEllMatrix.from_host_csr(data, indices, indptr, a.shape)
    res = cg_df64(dfa, b, epsilon=1e-10)
    assert res.status_enum() == SolverStatus.SUCCESS, res
    x = res.x_f64()
    tr = b - np.add.reduceat(data * x[indices], indptr[:-1])
    assert np.linalg.norm(tr) < 1e-9, np.linalg.norm(tr)
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-10


def test_df_dia_matvec():
    """DfDiaMatrix (gather-free shifted reads) vs host f64 oracle."""
    from sparse_matrix_math_tpu.ops.df32 import (
        DfDiaMatrix, df_from_host, df_operator_from_host_csr, df_to_host,
    )
    from sparse_matrix_math_tpu.utils import poisson_2d

    a = poisson_2d(64, dtype=np.float32)
    data = np.asarray(a.data, np.float64) * (1.0 + 1e-9)
    indices = np.asarray(a.indices, np.int64)
    indptr = np.asarray(a.indptr, np.int64)
    op = df_operator_from_host_csr(data, indices, indptr, a.shape)
    assert isinstance(op, DfDiaMatrix)
    n = a.shape[0]
    x64 = np.random.default_rng(3).standard_normal(n)
    got = df_to_host(jax.jit(op.rmult_df)(df_from_host(x64)))
    want = np.add.reduceat(data * x64[indices], indptr[:-1])
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-12


def test_escalated_stencil_solve_to_1e8():
    """The f64 contract through solve(): f32 data, epsilon 1e-8,
    multigrid, escalated to the double-word refinement."""
    import sparse_matrix_math_tpu as smm
    from sparse_matrix_math_tpu.utils.generate import poisson_3d

    a = poisson_3d(24, dtype=np.float32)
    st = smm.try_grid_stencil_from_csr(a)
    b = st @ jnp.ones(st.shape[0], jnp.float32)
    res = smm.solve(st, b, epsilon=1e-8, preconditioner="multigrid")
    assert isinstance(res, smm.DfSolveResult) and res.success
    data = np.asarray(a.data, np.float64)
    indices = np.asarray(a.indices, np.int64)
    indptr = np.asarray(a.indptr, np.int64)
    x = res.x_f64()
    r = np.asarray(b, np.float64) - np.add.reduceat(
        data * x[indices], indptr[:-1]
    )
    assert np.linalg.norm(r) <= 1e-8
