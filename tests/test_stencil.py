"""GridStencilMatrix: matrix-free constant-coefficient grid stencils.

Detection is by entry-for-entry reconstruction (formats/stencil.py), so
a routed operator is exactly the CSR's data; the solver fast path keeps
carries in the grid layout (solvers/_stencil.py).  Measured 25.2 us per
CG iteration at n=2M vs 44.6 us through the padded-DIA kernel.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.stencil import (
    GridStencilMatrix,
    try_grid_stencil_from_csr,
)
from sparse_matrix_math_tpu.utils.generate import (
    convection_diffusion_2d,
    laplace_3d_jittered,
    poisson_2d,
    poisson_3d,
)


@pytest.mark.parametrize("maker,kwargs,dims", [
    (poisson_2d, dict(nx=20), None),
    (poisson_2d, dict(nx=12, ny=17), (17, 12)),
    (poisson_3d, dict(nx=7), None),
    (convection_diffusion_2d, dict(nx=15), None),
])
def test_detection_and_apply_parity(maker, kwargs, dims):
    a = maker(dtype=np.float64, **kwargs)
    st = try_grid_stencil_from_csr(a, dims)
    assert st is not None
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(a.shape[0]))
    y_ref = smm.rmult(a, x)
    y = st @ x
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-12)
    # panel apply
    X = jnp.asarray(rng.standard_normal((a.shape[0], 3)))
    np.testing.assert_allclose(
        np.asarray(st @ X), np.asarray(smm.rmult(a, X)), atol=1e-12
    )


def test_detection_rejects_non_stencils():
    # jittered pattern: not a tensor-product stencil
    assert try_grid_stencil_from_csr(
        laplace_3d_jittered(9, dtype=np.float64)
    ) is None
    # constant pattern but non-constant values
    a = poisson_2d(10, dtype=np.float64)
    data = np.asarray(a.data).copy()
    data[len(data) // 2] *= 1.5
    from sparse_matrix_math_tpu.formats.csr import CSRMatrix

    a2 = a.with_data(jnp.asarray(data))
    assert try_grid_stencil_from_csr(a2) is None


def test_best_format_routes_stencils():
    a = poisson_2d(16, dtype=np.float64)
    assert isinstance(smm.best_format(a), GridStencilMatrix)
    assert not isinstance(
        smm.best_format(laplace_3d_jittered(9, dtype=np.float64)),
        GridStencilMatrix,
    )


@pytest.mark.parametrize("solver", ["cg", "bicg_symmetric", "cgs", "bicgstab"])
def test_solvers_on_stencil_operator(solver):
    a = poisson_2d(24, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    b = st @ jnp.ones(a.shape[0])
    res = getattr(smm, solver)(st, b, epsilon=1e-10)
    assert res.status_enum() == smm.SolverStatus.SUCCESS, (solver, res)
    assert float(jnp.abs(res.x - 1.0).max()) < 1e-8


def test_stencil_preconditioned_and_traced():
    a = poisson_2d(24, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    n = a.shape[0]
    b = st @ jnp.ones(n)
    from sparse_matrix_math_tpu.precond.preconditioners import (
        JacobiPreconditioner,
    )

    pre = JacobiPreconditioner(inv_diag=1.0 / st.diagonal())
    res = smm.cg(st, b, epsilon=1e-10, preconditioner=pre,
                 record_residuals=True)
    assert res.status_enum() == smm.SolverStatus.SUCCESS
    assert res.residual_trace is not None
    assert float(jnp.abs(res.x - 1.0).max()) < 1e-8


def test_stencil_nonsymmetric_solve():
    a = convection_diffusion_2d(20, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    assert st is not None
    b = st @ jnp.ones(a.shape[0])
    res = smm.bicgstab(st, b, epsilon=1e-10)
    assert res.status_enum() == smm.SolverStatus.SUCCESS
    assert float(jnp.abs(res.x - 1.0).max()) < 1e-7


def test_df_stencil_refinement_and_escalation():
    """DfGridStencil: the double-word matrix-free twin — cg_ir_df64 runs
    its true residual matrix-free, and solve() escalates a floored f32
    stencil solve through it."""
    from sparse_matrix_math_tpu import cg_ir_df64, solve
    from sparse_matrix_math_tpu.ops.df32 import DfGridStencil
    from sparse_matrix_math_tpu.solvers.df64 import DfSolveResult

    a = poisson_2d(32, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    b64 = np.asarray(a.to_dense()).sum(axis=1)
    dfst = DfGridStencil.from_stencil(
        st, coeffs64=np.asarray(st.coeffs, np.float64)
    )
    res = cg_ir_df64(dfst, b64, epsilon=1e-10)
    assert res.status_enum() == smm.SolverStatus.SUCCESS
    assert np.abs(res.x_f64() - 1.0).max() < 1e-9

    st32 = try_grid_stencil_from_csr(poisson_2d(32, dtype=np.float32))
    res = solve(st32, jnp.asarray(b64, jnp.float32), method="cg",
                epsilon=1e-8)
    assert isinstance(res, DfSolveResult)
    assert res.status_enum() == smm.SolverStatus.SUCCESS


def test_auto_format_keeps_dia_for_dia_features():
    """solve(auto_format=True) must not route a stencil-detectable
    matrix onto the matrix-free path when the requested feature rides
    the DIA machinery (bf16 matrix stream, padded SGS factors)."""
    a = poisson_2d(16, dtype=np.float32)
    b = jnp.asarray(np.asarray(a.to_dense()).sum(axis=1), jnp.float32)
    res = smm.solve(
        a, b, method="cg", matrix_dtype="bfloat16", auto_format=True,
        epsilon=1e-3,
    )
    assert res.status_enum() == smm.SolverStatus.SUCCESS
    res = smm.solve(
        a, b, method="bicgstab", preconditioner="sgs", auto_format=True,
        epsilon=1e-3,
    )
    assert res.status_enum() == smm.SolverStatus.SUCCESS
