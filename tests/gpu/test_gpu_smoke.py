"""Card tests: the library's main paths compiled for an NVIDIA GPU.

Run on a machine with the card:

    SMM_GPU_TESTS=1 python -m pytest -m gpu tests/gpu -q

Elsewhere every test here skips (the ``require_gpu`` fixture).  The
parity tests run the same small solve on the card and on the host's CPU
backend in one process and compare iteration counts: the two compile
the same algorithm, so a count that drifts points at a reduction that
runs in reduced precision on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.utils.generate import (
    convection_diffusion_2d,
    poisson_2d,
    poisson_3d,
    random_spd_csr,
)

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("require_gpu")]


def _on_cpu(fn):
    with jax.default_device(jax.devices("cpu")[0]):
        return fn()


def _within(a: int, b: int, frac: float) -> bool:
    return abs(a - b) <= max(1, frac * max(a, b))


def test_dia_spmv_matches_host():
    a = poisson_2d(128, dtype=np.float32)
    d = smm.dia_from_csr(a)
    x = np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32)
    y = np.asarray(jax.jit(smm.rmult)(d, jnp.asarray(x)), np.float64)
    y_ref = np.asarray(a.to_dense(), np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["csr", "ell", "hyb"])
def test_general_formats_spmv(fmt):
    a = random_spd_csr(2000, density=0.01, seed=1, dtype=np.float32)
    op = {"csr": lambda: a, "ell": lambda: smm.ell_from_csr(a),
          "hyb": lambda: smm.hyb_from_csr(a)}[fmt]()
    x = np.random.default_rng(2).standard_normal(2000).astype(np.float32)
    y = np.asarray(jax.jit(smm.rmult)(op, jnp.asarray(x)), np.float64)
    y_ref = np.asarray(a.to_dense(), np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


def test_all_solvers_on_dia():
    a = smm.dia_from_csr(poisson_2d(32, dtype=np.float32))
    b = a @ jnp.ones(1024, jnp.float32)
    for solver in (smm.cg, smm.bicg_symmetric, smm.cgs, smm.bicgstab):
        res = solver(a, b, epsilon=1e-4)
        assert int(res.status) == 0, solver.__name__
        assert float(jnp.abs(res.x - 1).max()) < 1e-2, solver.__name__


def test_preconditioned_solves():
    a = random_spd_csr(300, density=0.02, seed=3, dtype=np.float32)
    b = a @ jnp.ones(300, jnp.float32)
    res = smm.cg(a, b, epsilon=1e-4,
                 preconditioner=smm.get_preconditioner(a, "ic0"))
    assert int(res.status) == 0
    res = smm.bicgstab(a, b, epsilon=1e-4,
                       preconditioner=smm.get_preconditioner(a, "sgs"))
    assert int(res.status) == 0


def test_single_device_dist_solve():
    from sparse_matrix_math_tpu.parallel import (
        collect, dist_solve, distribute_csr, make_mesh,
    )

    a = poisson_2d(16, dtype=np.float32)
    mesh = make_mesh(1)
    da = distribute_csr(a, mesh)
    b = np.asarray(a.to_dense()).sum(axis=1)
    res = dist_solve(da, b, solver="cg", epsilon=1e-4, mesh=mesh)
    assert int(res.status) == 0
    assert np.abs(collect(res.x, da) - 1).max() < 1e-3


def test_multigrid_pcg():
    a = poisson_2d(128, dtype=np.float32)
    b = a @ jnp.ones(a.shape[0], jnp.float32)
    mg = smm.PoissonMultigrid.for_grid(128)
    res = smm.cg(a, b, epsilon=1e-4, preconditioner=mg)
    assert int(res.status) == 0
    assert int(res.iterations) <= 15


def test_grid_stencil_solve_matches_dia():
    a = poisson_2d(160, dtype=np.float32)
    dia = smm.try_dia_from_csr(a)
    st = smm.try_grid_stencil_from_csr(a, dia=dia)
    assert st is not None
    b = st @ jnp.ones((a.shape[0],), jnp.float32)
    res = smm.cg(st, b, epsilon=1e-4)
    ref = smm.cg(dia, b, epsilon=1e-4)
    assert int(res.status) == int(ref.status) == 0
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-4
    )


def test_sstep_gmres():
    a = convection_diffusion_2d(96, dtype=np.float32)
    b = a @ jnp.ones((a.shape[0],), jnp.float32)
    res = smm.gmres(a, b, epsilon=1e-3, restart=32, s_step=4)
    assert int(res.status) == 0
    assert float(jnp.linalg.norm(b - a @ res.x)) <= 1e-3 * 1.01


def test_gmres_basis_orthogonal_with_pinned_precision():
    """The Arnoldi basis keeps the orthogonality the CPU's f32 gets on
    the same input: TF32 products would lose about three digits."""
    from sparse_matrix_math_tpu.solvers.gmres import arnoldi_basis

    a = smm.dia_from_csr(convection_diffusion_2d(128, dtype=np.float32))
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32)

    def loss():
        V = np.asarray(arnoldi_basis(a, jnp.asarray(b), 32), np.float64)
        return np.linalg.norm(V @ V.T - np.eye(33), 2)

    gpu, cpu = loss(), _on_cpu(loss)
    assert gpu <= max(10 * cpu, 1e-5), (gpu, cpu)


def test_panel_solve():
    st = smm.try_grid_stencil_from_csr(poisson_2d(96, dtype=np.float32))
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((st.shape[0], 4)), jnp.float32)
    B = st @ X
    eps = 1e-3 * float(jnp.linalg.norm(B, axis=0).min())
    res = smm.cg_multi(st, B, epsilon=eps, max_iterations=2000)
    assert all(int(v) == 0 for v in np.asarray(res.status))


def test_cg_iteration_parity_with_cpu():
    """Phase A's system at 32^3: the card and the CPU count the same
    CG iterations (within 2 %)."""
    st = smm.try_grid_stencil_from_csr(poisson_3d(32, dtype=np.float32))
    b64 = np.random.default_rng(1).standard_normal(st.shape[0])
    b32 = (b64 / np.linalg.norm(b64)).astype(np.float32)

    def run():
        return int(smm.solve(st, jnp.asarray(b32), method="cg",
                             epsilon=1e-5).iterations)

    gpu = run()
    cpu = _on_cpu(run)
    assert _within(gpu, cpu, 0.02), (gpu, cpu)


def test_bicgstab_sgs_iteration_parity_with_cpu():
    """Phase D's system at 64^2: BiCGStab + SGS on DIA input counts the
    same iterations on the card and the CPU (within 2 %)."""
    dia = smm.dia_from_csr(convection_diffusion_2d(64, dtype=np.float32))
    b64 = np.random.default_rng(3).standard_normal(dia.shape[0])
    b32 = (b64 / np.linalg.norm(b64)).astype(np.float32)

    def run():
        return int(smm.solve(dia, jnp.asarray(b32), method="bicgstab",
                             preconditioner="sgs", epsilon=1e-5).iterations)

    gpu = run()
    cpu = _on_cpu(run)
    assert _within(gpu, cpu, 0.02), (gpu, cpu)
