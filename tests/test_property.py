"""Property-based tests (hypothesis): format round-trips and solver
correctness against dense linear algebra on arbitrary random inputs —
fuzz coverage the reference never had (SURVEY §4: no fuzzing)."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_dense
from sparse_matrix_math_tpu.formats.dia import dia_from_csr
from sparse_matrix_math_tpu.formats.ell import ell_from_csr
from sparse_matrix_math_tpu.formats.hyb import hyb_from_csr
from sparse_matrix_math_tpu.ops.spmv import rmult


@st.composite
def sparse_dense_pair(draw, max_n=24):
    n = draw(st.integers(2, max_n))
    m = draw(st.integers(2, max_n))
    seed = draw(st.integers(0, 2**31 - 1))
    density = draw(st.floats(0.05, 0.6))
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, m))
    dense[rng.random((n, m)) > density] = 0.0
    return dense


@pytest.mark.slow
@settings(max_examples=25, deadline=None)
@given(sparse_dense_pair())
def test_formats_roundtrip_and_spmv(dense):
    a = csr_from_dense(dense)
    x = np.random.default_rng(1).standard_normal(dense.shape[1])
    y_ref = dense @ x

    import jax.numpy as jnp

    xj = jnp.asarray(x)
    np.testing.assert_allclose(np.asarray(a.to_dense()), dense, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rmult(a, xj)), y_ref, atol=1e-10)

    e = ell_from_csr(a)
    np.testing.assert_allclose(np.asarray(rmult(e, xj)), y_ref, atol=1e-10)
    np.testing.assert_allclose(np.asarray(e.to_dense()), dense, atol=1e-12)

    h = hyb_from_csr(a)
    np.testing.assert_allclose(np.asarray(rmult(h, xj)), y_ref, atol=1e-10)

    try:
        d = dia_from_csr(a)
    except ValueError:
        d = None  # too many diagonals — fine
    if d is not None:
        np.testing.assert_allclose(np.asarray(rmult(d, xj)), y_ref, atol=1e-10)
        np.testing.assert_allclose(np.asarray(d.to_dense()), dense, atol=1e-12)


@st.composite
def spd_system(draw, max_n=20):
    n = draw(st.integers(2, max_n))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    m[rng.random((n, n)) > 0.4] = 0.0
    dense = m @ m.T + n * np.eye(n)  # SPD, reasonably conditioned
    x_true = rng.standard_normal(n)
    return dense, x_true


@pytest.mark.slow
@settings(max_examples=15, deadline=None)
@given(spd_system())
def test_solvers_recover_solution(sys_pair):
    dense, x_true = sys_pair
    a = csr_from_dense(dense)

    import jax.numpy as jnp

    b = jnp.asarray(dense @ x_true)
    for solver in (smm.cg, smm.bicg_symmetric, smm.cgs, smm.bicgstab):
        res = solver(a, b, epsilon=1e-10, max_iterations=10 * dense.shape[0])
        assert int(res.status) == 0, solver.__name__
        np.testing.assert_allclose(
            np.asarray(res.x), x_true, atol=1e-6, err_msg=solver.__name__
        )


@pytest.mark.slow
@settings(max_examples=10, deadline=None)
@given(spd_system(max_n=14))
def test_preconditioners_preserve_solution(sys_pair):
    dense, x_true = sys_pair
    a = csr_from_dense(dense)

    import jax.numpy as jnp

    b = jnp.asarray(dense @ x_true)
    for kind, solver in (
        ("jacobi", smm.cg),
        ("sgs", smm.bicgstab),
        ("ic0", smm.cg),
        ("ilu0", smm.bicgstab),
    ):
        pre = smm.get_preconditioner(a, kind)
        res = solver(
            a, b, epsilon=1e-10, max_iterations=10 * dense.shape[0],
            preconditioner=pre,
        )
        assert int(res.status) == 0, kind
        np.testing.assert_allclose(
            np.asarray(res.x), x_true, atol=1e-6, err_msg=kind
        )


@settings(max_examples=10, deadline=None)
@given(
    st.integers(min_value=2, max_value=30),
    st.integers(min_value=0, max_value=2 ** 31 - 1),
    st.floats(min_value=0.005, max_value=0.2),
)
@pytest.mark.slow
def test_ell_hyb_match_csr_spmv(n_scale, seed, density):
    """ELL and HYB must reproduce the CSR SpMV for random patterns of
    any density."""
    import jax.numpy as jnp

    from sparse_matrix_math_tpu.formats.ell import ell_from_csr
    from sparse_matrix_math_tpu.formats.hyb import hyb_from_csr
    from sparse_matrix_math_tpu.ops.spmv import rmult

    n = 40 * n_scale  # 80 .. 2400 (crosses slab/window boundaries)
    rng = np.random.default_rng(seed)
    nnz_target = max(int(n * n * density), n)
    r = rng.integers(0, n, nnz_target)
    c = rng.integers(0, n, nnz_target)
    v = rng.standard_normal(nnz_target)
    key = r.astype(np.int64) * n + c
    order = np.argsort(key, kind="stable")
    key, r, c, v = key[order], r[order], c[order], v[order]
    uniq = np.ones(key.shape[0], bool)
    uniq[1:] = key[1:] != key[:-1]
    from sparse_matrix_math_tpu.formats.csr import _csr_from_sorted_host

    csr = _csr_from_sorted_host(r[uniq], c[uniq], v[uniq], (n, n))
    x = jnp.asarray(rng.standard_normal(n))
    for op in (ell_from_csr(csr), hyb_from_csr(csr)):
        np.testing.assert_allclose(
            np.asarray(rmult(op, x)), np.asarray(rmult(csr, x)),
            rtol=1e-9, atol=1e-9,
        )
