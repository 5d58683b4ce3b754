"""Double-word f32 ("df64") arithmetic and solver tests.

The reference is templated over ``double`` with a 1e-8 residual
contract (test/include/test_common.h:30-38); with f32 storage the
package carries that contract through double-word f32
(ops/df32.py, solvers/df64.py).  These tests check the emulation
against host float64 oracles.

Tolerance note: the double-word algorithms have ~2^-47 unit roundoff.
XLA:CPU's LLVM pipeline contracts mul+add into FMA inside fusions,
which perturbs two_prod's error word; measured effect is ~1e-14
relative on composed ops (docs/DESIGN.md §13).  Bounds
below use 1e-12 — loose for both backends, still 4+ orders past f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_matrix_math_tpu import (
    SolverStatus,
    cg,
    cg_df64,
    load_matrix_csr,
    load_matrix_df,
)
from sparse_matrix_math_tpu.ops import df32 as D
from sparse_matrix_math_tpu.solvers.df64 import DfSolveResult
from sparse_matrix_math_tpu.utils import poisson_2d
from conftest import MESH_MATRICES, asset_path

RNG = np.random.default_rng(42)


def _df_pair(n, scale=1.0, seed=0):
    """Random double-word vectors with a genuine lo word."""
    rng = np.random.default_rng(seed)
    v64 = rng.standard_normal(n) * scale
    return D.df_from_host(v64), v64


def _host(x):
    return D.df_to_host(x)


# ---------------------------------------------------------------- primitives


def test_df_from_to_host_split_48bit():
    v64 = RNG.standard_normal(1000) * 1e3
    hi, lo = D.df_from_host(v64)
    # hi is v rounded to f32 (exact); lo rounds the remainder to f32, so
    # the pair carries ~48 significand bits: recombination is accurate
    # to ~2^-49 relative, not bit-for-bit
    back = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    rel = np.max(np.abs(back - v64) / np.abs(v64))
    assert rel <= 2.0**-48, rel
    # the words nest: |lo| <= ulp(hi)/2
    assert np.all(np.abs(lo) <= np.spacing(np.abs(np.asarray(hi))) * 0.5 + 1e-300)


@pytest.mark.parametrize(
    "op,oracle",
    [
        (D.df_add, np.add),
        (D.df_sub, np.subtract),
        (D.df_mul, np.multiply),
        (D.df_div, np.divide),
    ],
    ids=["add", "sub", "mul", "div"],
)
def test_df_elementwise_vs_f64(op, oracle):
    a, a64 = _df_pair(4096, seed=1)
    b, b64 = _df_pair(4096, scale=3.0, seed=2)
    got = _host(op(a, b))
    # oracle on the values the pairs actually hold (the 48-bit split of
    # the f64 inputs), so the bound tests the ARITHMETIC, not the split
    a48 = np.asarray(a[0], np.float64) + np.asarray(a[1], np.float64)
    b48 = np.asarray(b[0], np.float64) + np.asarray(b[1], np.float64)
    want = oracle(a48, b48)
    # error relative to the op's natural scale: |a|+|b| for add/sub
    # (a+b near zero is cancellation of the INPUTS, not an arithmetic
    # defect); |result| for mul/div (no cancellation possible there)
    if oracle in (np.add, np.subtract):
        scale = np.maximum(np.abs(a48) + np.abs(b48), 1e-300)
    else:
        scale = np.maximum(np.abs(want), 1e-300)
    rel = np.max(np.abs(got - want) / scale)
    assert rel < 1e-12, rel


def test_df_dot_vs_f64():
    x, x64 = _df_pair(65536, seed=3)
    y, y64 = _df_pair(65536, seed=4)
    got = float(_host(D.df_dot(x, y)))
    want = float(np.dot(x64, y64))
    assert abs(got - want) / abs(want) < 1e-12


def test_df_dot_cancellation_beats_f32():
    """An ill-conditioned dot where plain f32 loses most digits.

    Inputs are EXACT double-words (hi = ±3e4, lo ~ 1, both f32) so the
    oracle measures the arithmetic, not input-representation rounding:
    x·1 = Σ lo after the big hi terms cancel pairwise."""
    n = 4096
    rng = np.random.default_rng(11)
    hi = np.empty(2 * n, np.float32)
    hi[0::2] = np.float32(3e4)
    hi[1::2] = np.float32(-3e4)
    lo = (1.0 + 0.1 * rng.standard_normal(2 * n)).astype(np.float32)
    x64 = hi.astype(np.float64) + lo.astype(np.float64)  # exact
    y64 = np.ones(2 * n)
    want = float(np.dot(x64, y64))  # = Σ lo ≈ 2n, after cancellation
    got = float(_host(D.df_dot((jnp.asarray(hi), jnp.asarray(lo)),
                               D.df_from_host(y64))))
    assert abs(got - want) / abs(want) < 1e-10
    # f32 comparison point: x rounds to the ulp(3e4) ≈ 2^-2 grid, so a
    # plain f32 dot is wrong in the 4th digit
    f32 = float(np.sum(x64.astype(np.float32), dtype=np.float32))
    assert abs(f32 - want) / abs(want) > 1e-5
    assert abs(f32 - want) > 1e3 * abs(got - want)


def test_df_norm2_nonnegative_and_accurate():
    x, x64 = _df_pair(10000, scale=1e-3, seed=5)
    got = float(_host(D.df_norm2(x)))
    want = float(np.dot(x64, x64))
    assert got >= 0.0
    assert abs(got - want) / want < 1e-12


# ---------------------------------------------------------------- operator


def _poisson_host(nx):
    a = poisson_2d(nx, dtype=np.float64)
    data = np.asarray(a.data, np.float64)
    indices = np.asarray(a.indices, np.int64)
    indptr = np.asarray(a.indptr, np.int64)
    return a, data, indices, indptr


def test_df_ell_spmv_vs_f64():
    a, data, indices, indptr = _poisson_host(24)
    n = a.shape[0]
    # perturb values so lo planes are non-trivial
    data = data * (1.0 + 1e-9 * np.arange(data.size))
    dfa = D.DfEllMatrix.from_host_csr(data, indices, indptr, a.shape)
    x64 = np.random.default_rng(7).standard_normal(n)
    x = D.df_from_host(x64)
    got = _host(dfa.rmult_df(x))
    # host f64 CSR SpMV oracle
    want = np.zeros(n)
    for r in range(n):
        s, e = indptr[r], indptr[r + 1]
        want[r] = np.dot(data[s:e], x64[indices[s:e]])
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 1e-12, rel


def test_df_ell_empty_rows():
    # rows 1 and 3 empty: padding slots must be exact no-ops
    data = np.array([2.0, 5.0], np.float64)
    indices = np.array([0, 2], np.int64)
    indptr = np.array([0, 1, 1, 2, 2], np.int64)
    dfa = D.DfEllMatrix.from_host_csr(data, indices, indptr, (4, 4))
    x = D.df_from_host(np.array([1.0, 10.0, 100.0, 1000.0]))
    got = _host(dfa.rmult_df(x))
    np.testing.assert_allclose(got, [2.0, 0.0, 500.0, 0.0], rtol=0, atol=0)


def test_df_dia_matches_ell_and_oracle():
    """DfDiaMatrix (gather-free fast path) must agree with the ELL
    path bit-for-bit-ish and with the f64 oracle."""
    a, data, indices, indptr = _poisson_host(24)
    n = a.shape[0]
    data = data * (1.0 + 1e-9 * np.arange(data.size))
    ell = D.DfEllMatrix.from_host_csr(data, indices, indptr, a.shape)
    dia = D.DfDiaMatrix.from_host_csr(data, indices, indptr, a.shape)
    assert dia.nnz == ell.nnz
    x64 = np.random.default_rng(9).standard_normal(n)
    x = D.df_from_host(x64)
    got_dia = _host(dia.rmult_df(x))
    got_ell = _host(ell.rmult_df(x))
    # accumulation order differs (per-diagonal vs per-slot), so allow
    # double-word-level noise
    np.testing.assert_allclose(got_dia, got_ell, rtol=1e-13, atol=1e-12)
    want = np.zeros(n)
    for r in range(n):
        s, e = indptr[r], indptr[r + 1]
        want[r] = np.dot(data[s:e], x64[indices[s:e]])
    rel = np.max(np.abs(got_dia - want)) / np.max(np.abs(want))
    assert rel < 1e-12, rel


def test_df_operator_selection():
    """Stencil → DIA; scattered pattern → ELL."""
    a, data, indices, indptr = _poisson_host(16)
    op = D.df_operator_from_host_csr(data, indices, indptr, a.shape)
    assert isinstance(op, D.DfDiaMatrix)
    # a random scattered pattern has ~nnz distinct diagonals → ELL
    rng = np.random.default_rng(3)
    n = 256
    cols = np.sort(rng.choice(n, (n, 4), replace=True), axis=1)
    vals = rng.standard_normal(n * 4)
    indptr2 = np.arange(0, 4 * (n + 1), 4)
    op2 = D.df_operator_from_host_csr(vals, cols.ravel(), indptr2, (n, n))
    assert isinstance(op2, D.DfEllMatrix)


# ---------------------------------------------------------------- solver


def test_cg_df64_poisson_1e10():
    """Past f32's representable resolution: eps=1e-10 on a 2-D Poisson."""
    a, data, indices, indptr = _poisson_host(48)
    n = a.shape[0]
    x_true = np.random.default_rng(0).standard_normal(n)
    # b = A @ x_true in f64
    b = np.zeros(n)
    for r in range(n):
        s, e = indptr[r], indptr[r + 1]
        b[r] = np.dot(data[s:e], x_true[indices[s:e]])
    dfa = D.DfEllMatrix.from_host_csr(data, indices, indptr, a.shape)
    res = cg_df64(dfa, b, epsilon=1e-10)
    assert isinstance(res, DfSolveResult)
    assert res.status_enum() == SolverStatus.SUCCESS, res
    x = res.x_f64()
    true_res = np.zeros(n)
    for r in range(n):
        s, e = indptr[r], indptr[r + 1]
        true_res[r] = b[r] - np.dot(data[s:e], x[indices[s:e]])
    assert np.linalg.norm(true_res) < 1e-9
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-10


@pytest.mark.parametrize("matrix", MESH_MATRICES)
def test_cg_df64_reference_assets_1e8(matrix):
    """The reference's f64 contract (test_common.h:30-38) on its own
    assets, all-ones oracle, via the load_matrix_df chain."""
    path = asset_path(matrix)
    dfa = load_matrix_df(path)
    n = dfa.shape[0]
    # rhs = row sums in exact f64 (all-ones oracle, test_common.h:13-21)
    b64 = np.asarray(dfa.vals_hi, np.float64).sum(axis=1)[:n] + np.asarray(
        dfa.vals_lo, np.float64
    ).sum(axis=1)[:n]
    res = cg_df64(dfa, b64, epsilon=1e-8)
    assert res.status_enum() == SolverStatus.SUCCESS, res
    x = res.x_f64()
    # true residual in host f64 against the double-word operator
    hi = np.asarray(dfa.vals_hi, np.float64)
    lo = np.asarray(dfa.vals_lo, np.float64)
    cols = np.asarray(dfa.cols)
    ax = ((hi + lo) * x[cols]).sum(axis=1)[:n]
    assert np.linalg.norm(b64 - ax) <= 2e-8
    # the f64 contract's solution quality (1e-8 residual; x error scales
    # with the asset's conditioning — mesh1em6 is the worst of the three)
    assert np.max(np.abs(x - 1.0)) < 1e-5


def test_load_matrix_df_values_48bit():
    """hi + lo must reproduce the parsed f64 values to double-word
    precision (the split itself carries ~48 significand bits)."""
    path = asset_path(MESH_MATRICES[0])
    dfa = load_matrix_df(path)
    csr = load_matrix_csr(path, dtype=np.float64)  # f64 on CPU backend
    want = np.asarray(csr.to_dense(), np.float64)
    hi = np.asarray(dfa.vals_hi, np.float64)
    lo = np.asarray(dfa.vals_lo, np.float64)
    cols = np.asarray(dfa.cols)
    n = dfa.shape[0]
    got = np.zeros_like(want)
    for r in range(n):
        for k in range(cols.shape[1]):
            got[r, cols[r, k]] += hi[r, k] + lo[r, k]
    np.testing.assert_allclose(got, want, rtol=2.0**-48, atol=0.0)
    assert dfa.nnz == csr.nnz


def test_cg_df64_accepts_csr_and_plain_b():
    a = poisson_2d(12, dtype=np.float64)
    n = a.shape[0]
    b = np.ones(n, np.float32)
    res = cg_df64(a, b, epsilon=1e-8)  # CSRMatrix → rounded operator
    assert res.status_enum() == SolverStatus.SUCCESS
    assert res.x.shape == (n,)


def test_cg_df64_status_paths():
    a = poisson_2d(8, dtype=np.float64)
    n = a.shape[0]
    b = np.ones(n, np.float64)
    res = cg_df64(a, b, max_iterations=1, epsilon=1e-12)
    assert res.status_enum() == SolverStatus.MAX_ITERATIONS_REACHED
    # zero rhs with zero guess: converged at iteration 0
    res0 = cg_df64(a, np.zeros(n), epsilon=1e-12)
    assert res0.status_enum() == SolverStatus.SUCCESS
    assert int(res0.iterations) == 0


def test_cg_df64_rejects_bad_operator():
    with pytest.raises(TypeError):
        cg_df64(np.eye(4), np.ones(4))


# ------------------------------------------------------------- bicgstab_df64


def test_bicgstab_df64_poisson_1e10():
    from sparse_matrix_math_tpu import bicgstab_df64

    a, data, indices, indptr = _poisson_host(32)
    n = a.shape[0]
    x_true = np.random.default_rng(1).standard_normal(n)
    b = np.add.reduceat(data * x_true[indices], indptr[:-1])
    dfa = D.DfDiaMatrix.from_host_csr(data, indices, indptr, a.shape)
    res = bicgstab_df64(dfa, b, epsilon=1e-10)
    assert res.status_enum() == SolverStatus.SUCCESS, res
    x = res.x_f64()
    tr = b - np.add.reduceat(data * x[indices], indptr[:-1])
    assert np.linalg.norm(tr) < 1e-9


def test_bicgstab_df64_sherman1_reference_contract():
    """The reference's nonsymmetric f64 case (test/cpp/bicgstab.cpp:
    sherman1 at 1e-8, ~415 iterations in double) through the df chain."""
    from sparse_matrix_math_tpu import bicgstab_df64
    from conftest import SHERMAN1

    path = asset_path(SHERMAN1)
    dfa = load_matrix_df(path)
    n = dfa.shape[0]
    # all-ones oracle in exact f64 from the split planes
    if isinstance(dfa, D.DfDiaMatrix):
        hi = np.asarray(dfa.diags_hi, np.float64)
        lo = np.asarray(dfa.diags_lo, np.float64)
        b64 = np.zeros(n)
        for d, off in enumerate(dfa.offsets):
            rows = np.arange(n)
            cols = rows + off
            valid = (cols >= 0) & (cols < n)
            b64[rows[valid]] += (hi + lo)[d, rows[valid]]
    else:
        b64 = (
            np.asarray(dfa.vals_hi, np.float64).sum(axis=1)[:n]
            + np.asarray(dfa.vals_lo, np.float64).sum(axis=1)[:n]
        )
    res = bicgstab_df64(dfa, b64, epsilon=1e-8)
    assert res.status_enum() == SolverStatus.SUCCESS, res
    x = res.x_f64()
    assert np.max(np.abs(x - 1.0)) < 1e-5
    assert float(res.residual_norm2) ** 0.5 <= 1e-8 * (1 + 1e-6)


def test_bicgstab_df64_status_paths():
    from sparse_matrix_math_tpu import bicgstab_df64

    a, data, indices, indptr = _poisson_host(8)
    n = a.shape[0]
    res = bicgstab_df64(a, np.ones(n), max_iterations=1, epsilon=1e-14)
    assert res.status_enum() == SolverStatus.MAX_ITERATIONS_REACHED
    res0 = bicgstab_df64(a, np.zeros(n), epsilon=1e-12)
    assert res0.status_enum() == SolverStatus.SUCCESS
    assert int(res0.iterations) == 0


def test_solve_front_door_df64():
    """solve(method='cg_df64'/'bicgstab_df64') through the config API."""
    from sparse_matrix_math_tpu import SolverConfig, solve

    a, data, indices, indptr = _poisson_host(16)
    n = a.shape[0]
    b = np.add.reduceat(data * np.ones(n)[indices], indptr[:-1])
    for method in ("cg_df64", "bicgstab_df64"):
        res = solve(a, b, config=SolverConfig(method=method, epsilon=1e-10))
        assert res.status_enum() == SolverStatus.SUCCESS, (method, res)
        assert np.max(np.abs(res.x_f64() - 1.0)) < 1e-9
    with pytest.raises(ValueError):
        solve(a, b, method="cg_df64", preconditioner="jacobi")
    with pytest.raises(ValueError):
        solve(a, b, method="cg_df64", record_residuals=True)
