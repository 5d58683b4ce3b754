"""Preconditioner correctness + preconditioned-solver convergence.

Mirrors the reference tests: IC0 apply on a hand-computed 5x5 SPD system
(test/cpp/cg.cpp:28-60), PCG+IC0 on the mesh suite (cg.cpp:62-84), and
SGS-preconditioned BiCGStab (bicgstab.cpp:145-167).  Adds coverage the
reference lacks (SURVEY §4 holes): ILU0 (reference's is broken), Jacobi,
non-SPD rejection, approximate (Jacobi-sweep) triangular solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_matrix_math_tpu import (
    FactorizationError,
    SolverStatus,
    bicgstab,
    cg,
    csr_from_dense,
    get_preconditioner,
    load_matrix_csr,
)
from sparse_matrix_math_tpu.precond import (
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
)
from sparse_matrix_math_tpu.utils import poisson_2d
from conftest import MESH_MATRICES, SHERMAN1, asset_path, inf_eps, l2_eps


@pytest.fixture
def spd5():
    # small SPD system in the spirit of the reference's hand-computed 5x5
    # IC0 check (test/cpp/cg.cpp:28-60)
    dense = np.array(
        [
            [4.0, 1.0, 0.0, 0.0, 1.0],
            [1.0, 5.0, 2.0, 0.0, 0.0],
            [0.0, 2.0, 6.0, 1.0, 0.0],
            [0.0, 0.0, 1.0, 4.0, 1.0],
            [1.0, 0.0, 0.0, 1.0, 3.0],
        ]
    )
    return dense, csr_from_dense(dense)


def test_identity_apply():
    m = IdentityPreconditioner()
    r = jnp.asarray([1.0, -2.0, 3.0])
    np.testing.assert_array_equal(np.asarray(m.apply(r)), np.asarray(r))


def test_jacobi_apply(spd5):
    dense, a = spd5
    m = JacobiPreconditioner.from_matrix(a)
    r = jnp.asarray(np.arange(1.0, 6.0))
    np.testing.assert_allclose(
        np.asarray(m.apply(r)), np.arange(1.0, 6.0) / np.diag(dense)
    )


def test_sgs_apply_matches_dense_formula(spd5):
    dense, a = spd5
    m = SGSPreconditioner.from_matrix(a)
    d = np.diag(np.diag(dense))
    msgs = (np.tril(dense)) @ np.linalg.inv(d) @ (np.triu(dense))
    r = np.linspace(-1, 1, 5)
    np.testing.assert_allclose(
        np.asarray(m.apply(jnp.asarray(r))), np.linalg.solve(msgs, r), rtol=1e-10
    )


def test_ic0_apply_is_exact_cholesky_solve_when_pattern_full(spd5):
    dense, a = spd5
    m = IC0Preconditioner.from_matrix(a)
    ld = np.asarray(m.lower.dense)
    r = np.arange(1.0, 6.0)
    np.testing.assert_allclose(
        np.asarray(m.apply(jnp.asarray(r))),
        np.linalg.solve(ld @ ld.T, r),
        rtol=1e-10,
    )
    # IC0 identity: L L^T == A on the pattern of A
    prod = ld @ ld.T
    mask = dense != 0
    np.testing.assert_allclose(prod[mask], dense[mask], rtol=1e-10)


def test_ilu0_factor_matches_pattern(spd5):
    dense, a = spd5
    m = ILU0Preconditioner.from_matrix(a)
    lu = np.asarray(m.lower.dense) @ np.asarray(m.upper.dense)
    mask = dense != 0
    np.testing.assert_allclose(lu[mask], dense[mask], rtol=1e-10)


def test_ic0_rejects_non_spd():
    # reference silently NaNs on non-SPD under NDEBUG (h:1879); we raise
    dense = np.array([[1.0, 4.0], [4.0, 1.0]])  # indefinite
    with pytest.raises(FactorizationError):
        IC0Preconditioner.from_matrix(csr_from_dense(dense))


def test_ic0_rejects_sherman1():
    a = load_matrix_csr(asset_path(SHERMAN1))
    with pytest.raises(FactorizationError):
        IC0Preconditioner.from_matrix(a)


def test_sgs_rejects_tiny_diagonal():
    dense = np.array([[1e-7, 1.0], [1.0, 2.0]])
    with pytest.raises(FactorizationError):
        SGSPreconditioner.from_matrix(csr_from_dense(dense))


@pytest.mark.parametrize("kind", ["jacobi", "sgs", "ilu0", "ic0"])
def test_pcg_converges_mesh_suite(kind, dtype):
    a = load_matrix_csr(asset_path(MESH_MATRICES[0]), dtype=dtype)
    ones = jnp.ones(a.shape[0], dtype=dtype)
    b = a @ ones
    m = get_preconditioner(a, kind)
    res = cg(a, b, epsilon=l2_eps(dtype), preconditioner=m)
    assert res.status_enum() == SolverStatus.SUCCESS
    assert float(jnp.max(jnp.abs(res.x - 1.0))) <= inf_eps(dtype) * 10


def test_pcg_ic0_iteration_parity_mesh1e1():
    # BASELINE.md: PCG+IC0 on mesh1e1 = 8 iterations (vs CG's 21)
    a = load_matrix_csr(asset_path(MESH_MATRICES[0]))
    b = a @ jnp.ones(a.shape[0], dtype=jnp.float64)
    m = get_preconditioner(a, "ic0")
    res = cg(a, b, epsilon=1e-8, preconditioner=m)
    assert abs(int(res.iterations) - 8) <= 2


def test_bicgstab_sgs_parity_mesh1e1():
    # BASELINE.md: BiCGStab+SGS on mesh1e1 = 5 iterations
    a = load_matrix_csr(asset_path(MESH_MATRICES[0]))
    b = a @ jnp.ones(a.shape[0], dtype=jnp.float64)
    m = get_preconditioner(a, "sgs")
    res = bicgstab(a, b, epsilon=1e-8, preconditioner=m)
    assert res.status_enum() == SolverStatus.SUCCESS
    assert abs(int(res.iterations) - 5) <= 2


def test_bicgstab_sgs_sherman1():
    # BASELINE.md: BiCGStab+SGS on sherman1 = 83 iterations
    a = load_matrix_csr(asset_path(SHERMAN1))
    b = a @ jnp.ones(a.shape[0], dtype=jnp.float64)
    m = get_preconditioner(a, "sgs")
    res = bicgstab(a, b, epsilon=1e-8, preconditioner=m)
    assert res.status_enum() == SolverStatus.SUCCESS
    assert int(res.iterations) <= 120


def test_jacobi_sweep_trisolve_exact():
    # sweeps="exact" must reproduce the dense solve exactly (nilpotency)
    a = poisson_2d(6, 6)
    for kind in ("sgs", "ic0", "ilu0"):
        md = get_preconditioner(a, kind, method="dense")
        mj = get_preconditioner(a, kind, method="jacobi", sweeps="exact")
        r = jnp.asarray(np.random.default_rng(0).normal(size=36))
        np.testing.assert_allclose(
            np.asarray(mj.apply(r)), np.asarray(md.apply(r)), rtol=1e-10
        )


def test_approximate_trisolve_still_preconditions():
    # few-sweep approximate triangular solve: PCG must still converge
    a = poisson_2d(10, 10)
    b = a @ jnp.ones(100, dtype=jnp.float64)
    m = get_preconditioner(a, "ic0", method="jacobi", sweeps=4)
    res = cg(a, b, epsilon=1e-8, preconditioner=m)
    assert res.status_enum() == SolverStatus.SUCCESS


def test_factory_parity_spellings():
    a = poisson_2d(4, 4)
    # the reference enum misspells SYMMETRIC_GAUS_SEIDEL (h:1002-1006)
    m1 = get_preconditioner(a, "symmetric_gaus_seidel")
    m2 = get_preconditioner(a, "symmetric_gauss_seidel")
    assert type(m1) is type(m2) is SGSPreconditioner
    assert isinstance(get_preconditioner(a, "none"), IdentityPreconditioner)


class TestDiaSGS:
    """SGSPreconditioner.from_dia: SGS on DIA factors, whose
    truncated-sweep apply must match the CSR-built SGSPreconditioner
    with the same sweep count (same math, other storage)."""

    def _dia(self, nx=12, dtype=np.float64):
        from sparse_matrix_math_tpu.formats.dia import dia_from_csr

        a = poisson_2d(nx, dtype=dtype)
        return a, dia_from_csr(a)

    @pytest.mark.parametrize("sweeps", [1, 2, 4])
    def test_apply_matches_generic_sgs(self, sweeps):

        a, dia = self._dia()
        generic = get_preconditioner(a, "sgs", method="jacobi", sweeps=sweeps)
        p = SGSPreconditioner.from_dia(dia, sweeps=sweeps)
        r = jnp.asarray(
            np.random.default_rng(1).normal(size=a.shape[0])
        )
        np.testing.assert_allclose(
            np.asarray(p.apply(r)),
            np.asarray(generic.apply(r)),
            rtol=1e-12, atol=1e-12,
        )

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_apply_matches_generic_sgs_nonsymmetric_panel(self, dtype):
        from sparse_matrix_math_tpu.formats.dia import dia_from_csr
        from sparse_matrix_math_tpu.utils.generate import (
            convection_diffusion_2d,
        )

        a = convection_diffusion_2d(10, dtype=dtype)
        generic = get_preconditioner(a, "sgs", method="jacobi", sweeps=3)
        p = SGSPreconditioner.from_dia(dia_from_csr(a), sweeps=3)
        r = jnp.asarray(
            np.random.default_rng(4).normal(size=(a.shape[0], 3)).astype(dtype)
        )
        tol = 1e-5 if dtype == np.float32 else 1e-12
        np.testing.assert_allclose(
            np.asarray(p.apply(r)), np.asarray(generic.apply(r)),
            rtol=tol, atol=tol,
        )

    def test_requires_diagonal(self):
        from sparse_matrix_math_tpu.formats.dia import DIAMatrix

        off_diag = DIAMatrix(
            diags=jnp.ones((1, 8)), offsets=(1,), shape=(8, 8), nnz=7
        )
        with pytest.raises(FactorizationError):
            SGSPreconditioner.from_dia(off_diag, sweeps=2)

    def test_rejects_tiny_diagonal_and_zero_sweeps(self):
        from sparse_matrix_math_tpu.formats.dia import DIAMatrix

        tiny = DIAMatrix(
            diags=jnp.full((1, 8), 1e-7), offsets=(0,), shape=(8, 8), nnz=8
        )
        with pytest.raises(FactorizationError):
            SGSPreconditioner.from_dia(tiny)
        _, dia = self._dia(4)
        with pytest.raises(ValueError):
            SGSPreconditioner.from_dia(dia, sweeps=0)

    def test_pure_diagonal_matrix(self):
        from sparse_matrix_math_tpu.formats.dia import DIAMatrix

        d = jnp.asarray(np.linspace(1.0, 2.0, 8))
        a = DIAMatrix(diags=d[None, :], offsets=(0,), shape=(8, 8), nnz=8)
        p = SGSPreconditioner.from_dia(a, sweeps=3)
        r = jnp.asarray(np.random.default_rng(3).normal(size=8))
        np.testing.assert_allclose(
            np.asarray(p.apply(r)), np.asarray(r / d), rtol=1e-12
        )


def test_exact_deep_sweeps_warns():
    # a 200-deep bidiagonal chain: sweeps="exact" must warn that the
    # apply costs depth SpMVs (VERDICT weak #8: silent exactness trap)
    import warnings

    n = 200
    d = np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), -1)
    a = csr_from_dense(d)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_preconditioner(a, "sgs", method="jacobi", sweeps="exact")
    assert any("practically unusable" in str(x.message) for x in w)
    # explicit sweep counts stay silent (and skip the depth scan)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = get_preconditioner(a, "sgs", method="jacobi", sweeps=4)
    assert not any("practically unusable" in str(x.message) for x in w)
    assert m.fwd.depth == -1  # not computed


class TestChebyshevPreconditioner:
    """Polynomial preconditioning (precond/cheby_poly.py): the apply is
    k SpMVs with A itself."""

    def test_apply_approximates_inverse(self):
        a = poisson_2d(12)
        m = get_preconditioner(a, "chebyshev", degree=24)
        r = jnp.asarray(np.random.default_rng(0).normal(size=a.shape[0]))
        z = m.apply(r)
        # p_k(A) r ~= A^{-1} r: the preconditioned residual must shrink a lot
        res = np.linalg.norm(np.asarray(a @ z - r)) / np.linalg.norm(
            np.asarray(r)
        )
        assert res < 0.15

    def test_pcg_converges_faster(self):
        a = poisson_2d(24)
        n = a.shape[0]
        b = a @ jnp.ones(n, jnp.float64)
        plain = cg(a, b, epsilon=1e-10)
        m = get_preconditioner(a, "cheby", degree=8)
        pre = cg(a, b, epsilon=1e-10, preconditioner=m)
        assert pre.status_enum() == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(pre.x), 1.0, atol=1e-7)
        # polynomial preconditioning trades matvecs for iterations (and
        # hence dots/axpys); a degree-8 polynomial roughly halves the
        # outer iteration count at this conditioning
        assert int(pre.iterations) < int(plain.iterations)

    def test_linear_operator(self):
        # the fixed-step apply must be LINEAR (required for CG theory)
        a = poisson_2d(8)
        m = get_preconditioner(a, "cheby", degree=5)
        rng = np.random.default_rng(1)
        u = jnp.asarray(rng.normal(size=a.shape[0]))
        v = jnp.asarray(rng.normal(size=a.shape[0]))
        lhs = np.asarray(m.apply(2.5 * u - 1.25 * v))
        rhs = 2.5 * np.asarray(m.apply(u)) - 1.25 * np.asarray(m.apply(v))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10, atol=1e-12)


class TestIlu0PivotShift:
    """Data-dependent zero pivots (VERDICT r4 #6): ILU(0) elimination can
    hit an exact or near-zero pivot on a perfectly nonsingular matrix.
    from_matrix escalates through diagonal shifts (A + alpha*I,
    Manteuffel-style) and reports the applied shift; pivot_shift='never'
    restores the strict raise."""

    # u22 = 4 - (2/1)*2 = 0 during elimination, but det(A) = -1
    ZERO_PIVOT = np.array([
        [1.0, 2.0, 0.0],
        [2.0, 4.0, 1.0],
        [0.0, 1.0, 3.0],
    ])

    def test_shifted_factorization_and_convergence(self):
        a = csr_from_dense(self.ZERO_PIVOT)
        pre = ILU0Preconditioner.from_matrix(a)
        assert pre.shift > 0.0
        b = jnp.asarray(self.ZERO_PIVOT @ np.ones(3))
        res = bicgstab(
            a, b, epsilon=1e-10, max_iterations=100, preconditioner=pre
        )
        assert res.status_enum() == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)

    def test_never_mode_raises(self):
        a = csr_from_dense(self.ZERO_PIVOT)
        with pytest.raises(FactorizationError, match="pivot"):
            ILU0Preconditioner.from_matrix(a, pivot_shift="never")

    def test_healthy_matrix_unshifted(self):
        pre = ILU0Preconditioner.from_matrix(poisson_2d(16, dtype=np.float64))
        assert pre.shift == 0.0

    def test_jittered_tiled_sherman1_factors(self):
        """A jittered reservoir-class system (values moved off the
        pattern they were computed for, the class where unshifted ILU0
        can meet data-dependent zero pivots): the factorization ends
        with a finite shift and a finite apply."""
        from sparse_matrix_math_tpu.utils.generate import reservoir_3d

        a = reservoir_3d(16, jitter=True, sigma=2.0)
        pre = ILU0Preconditioner.from_matrix(a, method="jacobi", sweeps=6)
        assert np.isfinite(pre.shift)
        # the factor the apply uses is finite everywhere
        r = jnp.asarray(np.random.default_rng(0).standard_normal(a.shape[0]))
        assert bool(jnp.all(jnp.isfinite(pre.apply(r))))
