"""Multi-RHS (batched) solves: solvers/block.py.

The reference has no multi-RHS capability (one RHS per call,
include/sparse_matrix_math.h:2316-2320) — this is an addition: one
SpMM per iteration feeds every column.  Correctness bar: column j of
cg_multi must match an independent cg run on (a, B[:, j]).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_dense
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import poisson_2d


class TestCGMulti:
    def test_matches_per_column_cg(self, dtype):
        a = poisson_2d(12, dtype=dtype)
        n = a.shape[0]
        rng = np.random.default_rng(0)
        B = jnp.asarray(rng.standard_normal((n, 4)).astype(dtype))
        res = smm.cg_multi(a, B, epsilon=1e-5)  # above the f32 floor (~1.2e-6 here)
        assert res.x.shape == (n, 4)
        for j in range(4):
            single = smm.cg(a, B[:, j], epsilon=1e-5)
            assert int(res.status[j]) == int(single.status) == SolverStatus.SUCCESS
            np.testing.assert_allclose(
                np.asarray(res.x[:, j]), np.asarray(single.x),
                rtol=5e-4, atol=5e-5,
            )
            # identical recurrences => identical iteration counts
            assert int(res.iterations[j]) == int(single.iterations)

    def test_mixed_convergence_freezes_columns(self):
        """A zero column converges at iteration 0 and must freeze there
        while the other columns keep iterating."""
        a = poisson_2d(10, dtype=np.float64)
        n = a.shape[0]
        B = jnp.stack(
            [jnp.zeros(n, jnp.float64), a @ jnp.ones(n, jnp.float64)], axis=1
        )
        res = smm.cg_multi(a, B, epsilon=1e-10)
        assert int(res.status[0]) == SolverStatus.SUCCESS
        assert int(res.iterations[0]) == 0
        np.testing.assert_array_equal(np.asarray(res.x[:, 0]), np.zeros(n))
        assert int(res.status[1]) == SolverStatus.SUCCESS
        assert int(res.iterations[1]) > 0
        np.testing.assert_allclose(np.asarray(res.x[:, 1]), 1.0, atol=1e-8)

    def test_per_column_divergence_isolated(self):
        """An indefinite system: the breakdown column reports DIVERGED
        without poisoning the healthy column."""
        a = csr_from_dense(np.diag([1.0, -1.0]))
        # column 0 hits p.A.p = 0 (see test_robustness); column 1 is
        # solvable in one step (b = e_0 lives in the +1 eigenspace)
        B = jnp.asarray([[1.0, 1.0], [1.0, 0.0]], jnp.float64)
        res = smm.cg_multi(a, B, max_iterations=50, epsilon=1e-12)
        assert int(res.status[0]) == SolverStatus.DIVERGED
        assert int(res.status[1]) == SolverStatus.SUCCESS
        np.testing.assert_allclose(
            np.asarray(res.x[:, 1]), [1.0, 0.0], atol=1e-12
        )

    def test_getitem_view(self):
        a = poisson_2d(6, dtype=np.float64)
        n = a.shape[0]
        B = a @ jnp.ones((n, 3), jnp.float64)
        res = smm.cg_multi(a, B, epsilon=1e-10)
        one = res[1]
        assert isinstance(one, smm.SolveResult)
        assert int(one.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(one.x), 1.0, atol=1e-8)

    def test_solve_api_routes_2d_b(self):
        a = poisson_2d(6, dtype=np.float64)
        n = a.shape[0]
        B = a @ jnp.ones((n, 2), jnp.float64)
        res = smm.solve(a, B, method="cg", epsilon=1e-10)
        assert res.x.shape == (n, 2)
        with pytest.raises(ValueError):
            smm.solve(a, B, method="bicgstab")

    def test_rejects_1d(self):
        a = poisson_2d(4, dtype=np.float64)
        with pytest.raises(ValueError):
            smm.cg_multi(a, jnp.ones(16, jnp.float64))


class TestCGMultiOverFormats:
    @pytest.mark.parametrize("fmt", ["ell", "hyb", "reordered"])
    def test_general_operator_matches_csr(self, fmt):
        """Multi-RHS CG over the general-pattern operators (one SpMM
        feeds all columns) must match the CSR run column-for-column."""
        a = poisson_2d(16, dtype=np.float32)
        op = {
            "ell": lambda: smm.ell_from_csr(a),
            "hyb": lambda: smm.hyb_from_csr(a),
            "reordered": lambda: smm.reorder_rcm(a),
        }[fmt]()
        n = a.shape[0]
        B = jnp.asarray(
            np.random.default_rng(3).standard_normal((n, 3)).astype(
                np.float32
            )
        )
        ref = smm.cg_multi(a, B, epsilon=1e-4)
        got = smm.cg_multi(op, B, epsilon=1e-4)
        for j in range(3):
            assert int(got.status[j]) == int(ref.status[j])
            np.testing.assert_allclose(
                np.asarray(got.x[:, j]), np.asarray(ref.x[:, j]),
                rtol=1e-3, atol=1e-4,
            )


class TestCGMultiPreconditioned:
    """Preconditioned multi-RHS: column j of cg_multi(..., M) must match
    an independent preconditioned_conjugate_gradient run on (a, B[:, j])
    — the applies broadcast over panels (trisolve.py axis-0 kernels)."""

    @pytest.mark.parametrize("kind", ["jacobi", "sgs", "ic0"])
    def test_matches_per_column_pcg(self, kind):
        from sparse_matrix_math_tpu.precond.preconditioners import (
            get_preconditioner,
        )

        a = poisson_2d(12, dtype=np.float64)
        n = a.shape[0]
        rng = np.random.default_rng(1)
        B = jnp.asarray(rng.standard_normal((n, 3)))
        m = get_preconditioner(a, kind)
        res = smm.cg_multi(a, B, epsilon=1e-8, preconditioner=m)
        for j in range(3):
            single = smm.cg(
                a, B[:, j], preconditioner=m, epsilon=1e-8
            )
            assert (
                int(res.status[j])
                == int(single.status)
                == SolverStatus.SUCCESS
            )
            np.testing.assert_allclose(
                np.asarray(res.x[:, j]), np.asarray(single.x),
                rtol=5e-6, atol=5e-8,
            )

    def test_preconditioning_reduces_iterations(self):
        a = poisson_2d(24, dtype=np.float64)
        n = a.shape[0]
        B = a @ jnp.ones((n, 2), jnp.float64)
        plain = smm.cg_multi(a, B, epsilon=1e-10)
        pre = smm.solve(a, B, method="cg", preconditioner="sgs",
                        epsilon=1e-10)
        assert all(int(s) == SolverStatus.SUCCESS for s in pre.status)
        assert int(pre.iterations.max()) < int(plain.iterations.max())
        np.testing.assert_allclose(np.asarray(pre.x), 1.0, atol=1e-7)

    @pytest.mark.slow
    @pytest.mark.parametrize("trisolve_method", ["dense", "jacobi"])
    def test_panel_apply_equals_columnwise_apply(self, trisolve_method):
        """The panel-capable preconditioner applies must equal per-column
        applies exactly (same kernels, axis-0 reductions) — on BOTH
        triangular-solve strategies (the jacobi-sweep path is what
        method='auto' picks at n > 4096)."""
        from sparse_matrix_math_tpu.precond.preconditioners import (
            get_preconditioner,
        )

        a = poisson_2d(9, dtype=np.float64)
        n = a.shape[0]
        rng = np.random.default_rng(2)
        R = jnp.asarray(rng.standard_normal((n, 4)))
        for kind in ("jacobi", "sgs", "ilu0", "ic0", "chebyshev"):
            if kind in ("jacobi", "chebyshev"):
                kwargs = {}
            else:
                kwargs = dict(method=trisolve_method, sweeps="exact")
            m = get_preconditioner(a, kind, **kwargs)
            panel = np.asarray(m.apply(R))
            for j in range(4):
                np.testing.assert_allclose(
                    panel[:, j], np.asarray(m.apply(R[:, j])),
                    rtol=1e-12, atol=1e-13, err_msg=kind,
                )


class TestCGMultiTraces:
    def test_per_column_trace_matches_single(self):
        """record_residuals: column j's trace equals the single-RHS cg
        trace (same recurrences), nan beyond the column's freeze."""
        a = poisson_2d(10, dtype=np.float64)
        n = a.shape[0]
        B = jnp.stack(
            [a @ jnp.ones(n, jnp.float64), jnp.zeros(n, jnp.float64)],
            axis=1,
        )
        res = smm.solve(a, B, method="cg", epsilon=1e-10,
                        record_residuals=True)
        assert res.residual_trace.shape == (n + 1, 2)
        single = smm.cg(a, B[:, 0], epsilon=1e-10, record_residuals=True)
        k = int(single.iterations)
        # (atol floor: the two loops reduce dots in different orders —
        # vdot vs axis-0 sum — so fully-converged entries differ at the
        # f64 rounding level)
        np.testing.assert_allclose(
            np.asarray(res.residual_trace[: k + 1, 0]),
            np.asarray(single.residual_trace[: k + 1]),
            rtol=1e-10, atol=5e-14,
        )
        # frozen-at-0 column: trace is [0, nan, nan, ...]
        col1 = np.asarray(res.residual_trace[:, 1])
        assert col1[0] == 0.0 and np.isnan(col1[1:]).all()
        # __getitem__ carries the column trace through
        one = res[0]
        np.testing.assert_array_equal(
            np.asarray(one.residual_trace), np.asarray(res.residual_trace[:, 0])
        )

    def test_off_by_default(self):
        a = poisson_2d(6, dtype=np.float64)
        B = a @ jnp.ones((a.shape[0], 2), jnp.float64)
        assert smm.cg_multi(a, B).residual_trace is None


def test_broken_column_keeps_last_finite_iterate():
    """Round-4 regression (review find): a column that breaks down
    (p.A.p = 0 on an indefinite system) must come back DIVERGED with a
    FINITE iterate, not NaN, while other columns keep solving."""
    import numpy as np

    from sparse_matrix_math_tpu.formats.csr import csr_from_dense

    d = np.diag(np.array([1.0, -1.0, 2, 3, 4, 5, 6, 7]))
    a = csr_from_dense(d.astype(np.float64))
    n = 8
    B = np.zeros((n, 2))
    B[0, 0] = 1.0
    B[1, 0] = 1.0  # indefinite column -> breakdown
    B[:, 1] = d @ np.ones(n)
    from sparse_matrix_math_tpu import cg_multi as _cgm

    res = _cgm(a, jnp.asarray(B), epsilon=1e-8)
    assert int(res.status[0]) == SolverStatus.DIVERGED
    assert bool(jnp.isfinite(res.x[:, 0]).all()), res.x[:, 0]
    assert bool(jnp.isfinite(res.residual_norm[0]))
    assert int(res.status[1]) == SolverStatus.SUCCESS
    np.testing.assert_allclose(np.asarray(res.x[:, 1]), 1.0, atol=1e-7)


def test_cg_multi_stencil_preconditioned_matches_csr():
    """Stencil-layout panels + a preconditioner: the apply crosses
    through the user-facing (n, m) layout (solvers/block.py mapply
    lift/drop) — must match the CSR panel route column-for-column."""
    import numpy as np

    from sparse_matrix_math_tpu.formats.stencil import (
        try_grid_stencil_from_csr,
    )
    from sparse_matrix_math_tpu.precond.preconditioners import (
        get_preconditioner,
    )
    from sparse_matrix_math_tpu.utils.generate import poisson_2d

    a = poisson_2d(24, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    assert st is not None
    rng = np.random.default_rng(3)
    B = jnp.asarray(a @ jnp.asarray(rng.standard_normal((a.shape[0], 3))))
    m = get_preconditioner(a, "jacobi")
    ref = smm.cg_multi(a, B, epsilon=1e-10, preconditioner=m)
    got = smm.cg_multi(st, B, epsilon=1e-10, preconditioner=m)
    assert all(int(v) == 0 for v in np.asarray(got.status))
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), atol=1e-8
    )
