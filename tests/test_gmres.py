"""GMRES(m) (solvers/gmres.py): restarted minimal-residual solves.

Correctness bars: converges on SPD systems and on nonsymmetric systems (where it is the minimal-residual complement to
BiCGStab); the Givens residual estimate matches the true residual at
exit; restarts and in-cycle freezing keep fixed shapes without changing
results; preconditioning cuts iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import (
    convection_diffusion_2d,
    poisson_2d,
    random_spd_csr,
    reservoir_3d,
)


class TestGMRES:
    def test_spd_mesh_matrix(self):
        a = random_spd_csr(48, density=0.2, seed=11)
        b = a @ jnp.ones(48, jnp.float64)
        res = smm.gmres(a, b, epsilon=1e-10)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)

    def test_nonsymmetric_convection_diffusion(self):
        a = convection_diffusion_2d(24, cx=0.8, cy=0.3, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        res = smm.gmres(a, b, epsilon=1e-10, restart=30)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)

    def test_reported_residual_matches_true(self):
        a = convection_diffusion_2d(16, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        res = smm.gmres(a, b, epsilon=1e-8, restart=25)
        true = float(jnp.linalg.norm(b - a @ res.x))
        assert abs(true - float(res.residual_norm)) < 1e-7

    def test_sherman1_ilu0(self):
        """A generated oil-reservoir-class nonsymmetric system
        (1000x1000, heterogeneous upwinded coefficients) in the realistic
        configuration: GMRES(50)+ILU0 solves it in 32 matvecs, where
        unpreconditioned GMRES(50) needs 175."""
        from sparse_matrix_math_tpu.precond.preconditioners import (
            get_preconditioner,
        )

        a = reservoir_3d(10)
        b = a @ jnp.ones(1000, jnp.float64)
        m = get_preconditioner(a, "ilu0")
        res = smm.gmres(a, b, epsilon=1e-8, restart=50, preconditioner=m)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) < 60
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-6)

    def test_restart_cycles_continue(self):
        """A restart size far below the needed Krylov dimension must
        still converge (more cycles), proving cross-cycle correctness."""
        a = poisson_2d(12, dtype=np.float64)
        b = a @ jnp.ones(144, jnp.float64)
        big = smm.gmres(a, b, epsilon=1e-10, restart=144)
        small = smm.gmres(a, b, epsilon=1e-10, restart=8,
                          max_iterations=5000)
        assert int(big.status) == int(small.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(small.x), 1.0, atol=1e-8)
        assert int(small.iterations) >= int(big.iterations)

    def test_preconditioned_fewer_iterations(self):
        from sparse_matrix_math_tpu.precond.preconditioners import (
            get_preconditioner,
        )

        a = convection_diffusion_2d(24, cx=0.5, cy=0.2, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        plain = smm.gmres(a, b, epsilon=1e-10, restart=30)
        m = get_preconditioner(a, "ilu0")
        pre = smm.gmres(a, b, epsilon=1e-10, restart=30, preconditioner=m)
        assert int(pre.status) == SolverStatus.SUCCESS
        assert int(pre.iterations) < int(plain.iterations)
        np.testing.assert_allclose(np.asarray(pre.x), 1.0, atol=1e-7)

    def test_solve_api_route(self):
        a = convection_diffusion_2d(12, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        res = smm.solve(a, b, method="gmres", preconditioner="ilu0",
                        epsilon=1e-10)
        assert int(res.status) == SolverStatus.SUCCESS

    def test_residual_trace(self):
        a = poisson_2d(10, dtype=np.float64)
        b = a @ jnp.ones(100, jnp.float64)
        res = smm.gmres(a, b, epsilon=1e-10, restart=20,
                        record_residuals=True)
        tr = np.asarray(res.residual_trace)
        k = int(res.iterations)
        assert np.isfinite(tr[: k + 1]).all()
        assert np.isnan(tr[k + 1:]).all()
        # estimates decrease monotonically within GMRES
        assert np.all(np.diff(tr[: k + 1]) <= 1e-12)
        assert abs(tr[k] - float(res.residual_norm)) < 1e-10

    def test_max_iterations_zero(self):
        a = poisson_2d(6, dtype=np.float64)
        b = a @ jnp.ones(36, jnp.float64)
        res = smm.gmres(a, b, max_iterations=0)
        assert int(res.status) == SolverStatus.MAX_ITERATIONS_REACHED
        assert int(res.iterations) == 0

    def test_zero_rhs_immediate_success(self):
        a = poisson_2d(6, dtype=np.float64)
        res = smm.gmres(a, jnp.zeros(36, jnp.float64))
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) == 0

    def test_rejects_bad_restart(self):
        a = poisson_2d(4, dtype=np.float64)
        with pytest.raises(ValueError):
            smm.gmres(a, jnp.ones(16, jnp.float64), restart=0)

    def test_f32(self):
        a = convection_diffusion_2d(16, dtype=np.float32)
        b = a @ jnp.ones(a.shape[0], jnp.float32)
        res = smm.gmres(a, b, epsilon=1e-4, restart=30)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-3)

    def test_max_iterations_honored_mid_cycle(self):
        """The cap counts matvecs and is respected INSIDE a restart
        cycle (steps past it freeze), and the trace buffer is never
        overrun."""
        a = poisson_2d(10, dtype=np.float64)
        b = a @ jnp.ones(100, jnp.float64)
        res = smm.gmres(a, b, max_iterations=10, restart=32,
                        epsilon=1e-14, record_residuals=True)
        assert int(res.status) == SolverStatus.MAX_ITERATIONS_REACHED
        assert int(res.iterations) == 10
        tr = np.asarray(res.residual_trace)
        assert tr.shape == (11,)
        assert np.isfinite(tr).all()

    def test_checkpointed_gmres(self, tmp_path):
        """checkpointed_solve chunks compose with gmres (chunk restarts
        are just GMRES restarts from the checkpointed iterate)."""
        from sparse_matrix_math_tpu.utils.checkpoint import (
            checkpointed_solve,
        )

        a = convection_diffusion_2d(16, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        res = checkpointed_solve(
            smm.gmres, a, b,
            checkpoint_path=str(tmp_path / "gm.npz"),
            chunk_iterations=40, epsilon=1e-10, restart=20,
        )
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)


class TestCaGmres:
    """s-step (communication-avoiding) GMRES: blocks of locally-
    orthogonalized matrix powers, BCGS2 block orthogonalization, and
    Hessenberg reconstruction — the basis panel is read twice per BLOCK
    instead of four times per step.  Must match the per-step algorithm's trajectories."""

    @pytest.mark.parametrize("s", [2, 4, 8])
    def test_matches_exact_gmres(self, s):
        a = convection_diffusion_2d(24, cx=0.5, cy=0.2, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        ref = smm.gmres(a, b, epsilon=1e-10, restart=32)
        res = smm.gmres(a, b, epsilon=1e-10, restart=32, s_step=s)
        assert int(res.status) == SolverStatus.SUCCESS
        # same convergence class: within one block of the exact count
        assert abs(int(res.iterations) - int(ref.iterations)) <= 2 * s
        assert float(jnp.linalg.norm(b - a @ res.x)) <= 2e-10

    def test_f32_and_verified_residual(self):
        """residual_norm is the VERIFIED true ||b - A x|| (the
        reconstructed-H estimate drifts in f32 — measured 3.6x at
        n=2M)."""
        a = convection_diffusion_2d(32, dtype=np.float32)
        b = a @ jnp.ones(a.shape[0], jnp.float32)
        res = smm.gmres(a, b, epsilon=1e-4, restart=32, s_step=4)
        assert int(res.status) == SolverStatus.SUCCESS
        true = float(jnp.linalg.norm(b - a @ res.x))
        assert true <= 1e-4 * 1.01
        assert abs(true - float(res.residual_norm)) <= 1e-6

    def test_preconditioned(self):
        from sparse_matrix_math_tpu.precond.preconditioners import (
            get_preconditioner,
        )

        a = convection_diffusion_2d(24, cx=0.5, cy=0.2, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        m = get_preconditioner(a, "ilu0")
        res = smm.gmres(a, b, epsilon=1e-10, restart=32, s_step=4,
                        preconditioner=m)
        assert int(res.status) == SolverStatus.SUCCESS
        assert float(jnp.linalg.norm(b - a @ res.x)) <= 2e-10

    def test_cap_block_granularity(self):
        """The matvec cap is never exceeded; s-step may stop up to s-1
        matvecs short of it."""
        a = poisson_2d(10, dtype=np.float64)
        b = a @ jnp.ones(100, jnp.float64)
        res = smm.gmres(a, b, max_iterations=10, restart=32, s_step=4,
                        epsilon=1e-14)
        assert int(res.status) == SolverStatus.MAX_ITERATIONS_REACHED
        assert int(res.iterations) <= 10
        zero = smm.gmres(a, b, max_iterations=0, s_step=4)
        assert int(zero.iterations) == 0

    def test_trace_block_boundaries(self):
        a = poisson_2d(10, dtype=np.float64)
        b = a @ jnp.ones(100, jnp.float64)
        res = smm.gmres(a, b, epsilon=1e-10, restart=16, s_step=4,
                        record_residuals=True)
        tr = np.asarray(res.residual_trace)
        assert np.isfinite(tr[0])
        finite = np.isfinite(tr).nonzero()[0]
        # estimates land on block boundaries only
        assert all(i % 4 == 0 for i in finite)

    def test_sherman1_ilu0_sstep(self):
        """The generated reservoir-class nonsymmetric system through the
        s-step path with right ILU0."""
        from sparse_matrix_math_tpu.precond.preconditioners import (
            get_preconditioner,
        )

        a = reservoir_3d(10)
        b = a @ jnp.ones(1000, jnp.float64)
        m = get_preconditioner(a, "ilu0")
        res = smm.gmres(a, b, epsilon=1e-8, restart=48, s_step=4,
                        preconditioner=m)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-6)
