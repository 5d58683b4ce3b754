"""Geometric multigrid (solvers/multigrid.py).

The reference has no multigrid (its strongest preconditioner is IC(0));
this is the operator-aware solver for the Poisson-class
benchmark family.  Contract: PCG + one-V-cycle preconditioning converges
in O(10) iterations INDEPENDENT of mesh size.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.solvers.multigrid import PoissonMultigrid
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import poisson_2d


class TestVCycleSolve:
    def test_textbook_convergence_odd_grid(self):
        # 63 = 2^6 - 1: the classical vertex-centred hierarchy — a V-cycle
        # contracts the residual ~10x, so 1e-4 needs only a handful
        nx = 63
        a = poisson_2d(nx, dtype=np.float32)
        b = a @ jnp.ones(a.shape[0], jnp.float32)
        mg = PoissonMultigrid.for_grid(nx)
        res = mg.solve(b, epsilon=1e-4, max_iterations=20)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) <= 8
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-4)

    def test_solution_matches_cg(self):
        nx = 63
        a = poisson_2d(nx, dtype=np.float64)
        rng = np.random.default_rng(0)
        b = jnp.asarray(rng.standard_normal(a.shape[0]))
        mg = PoissonMultigrid.for_grid(nx, dtype=jnp.float64)
        r1 = mg.solve(b, epsilon=1e-10, max_iterations=60)
        r2 = smm.cg(a, b, epsilon=1e-10)
        assert int(r1.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(
            np.asarray(r1.x), np.asarray(r2.x), rtol=1e-6, atol=1e-8
        )


class TestMGPreconditionedCG:
    @pytest.mark.slow
    @pytest.mark.parametrize("nx", [100, 250])
    def test_mesh_independent_iterations(self, nx):
        """PCG + V-cycle: O(10) iterations regardless of mesh size (plain
        CG needs O(nx)); even grid dims (the bench's 1414) are covered —
        the coarse-level geometry is slightly inconsistent there, which
        CG absorbs."""
        a = poisson_2d(nx, dtype=np.float32)
        b = a @ jnp.ones(a.shape[0], jnp.float32)
        mg = PoissonMultigrid.for_grid(nx)
        res = smm.cg(a, b, epsilon=1e-4, preconditioner=mg)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) <= 15
        plain = smm.cg(a, b, epsilon=1e-4)
        assert int(res.iterations) * 5 < int(plain.iterations)
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-3)

    def test_apply_is_symmetric_linear(self):
        """The V-cycle operator must be symmetric (R = P^T, symmetric
        smoothing) and linear — the PCG-safety requirements."""
        nx = 40
        mg = PoissonMultigrid.for_grid(nx, dtype=jnp.float64)
        rng = np.random.default_rng(1)
        u = jnp.asarray(rng.standard_normal(nx * nx))
        v = jnp.asarray(rng.standard_normal(nx * nx))
        mu, mv = mg.apply(u), mg.apply(v)
        # symmetry: <u, M v> == <M u, v>
        np.testing.assert_allclose(
            float(jnp.vdot(u, mv)), float(jnp.vdot(mu, v)), rtol=1e-10
        )
        # linearity
        np.testing.assert_allclose(
            np.asarray(mg.apply(2.0 * u - 0.5 * v)),
            np.asarray(2.0 * mu - 0.5 * mv),
            rtol=1e-10, atol=1e-12,
        )

    def test_rectangular_grid(self):
        a = poisson_2d(48, 36, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        mg = PoissonMultigrid.for_grid(48, 36, dtype=jnp.float64)
        res = smm.cg(a, b, epsilon=1e-8, preconditioner=mg)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) <= 15


class TestMultigrid3D:
    def test_pcg_3d(self):
        """3-D hierarchy (7-point Laplacian, poisson_3d ordering)."""
        from sparse_matrix_math_tpu.utils.generate import poisson_3d

        m = 24
        a = poisson_3d(m, dtype=np.float32)
        b = a @ jnp.ones(a.shape[0], jnp.float32)
        mg = PoissonMultigrid.for_grid(m, m, m)
        res = smm.cg(a, b, epsilon=1e-4, preconditioner=mg)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) <= 15
        plain = smm.cg(a, b, epsilon=1e-4)
        assert int(res.iterations) * 3 < int(plain.iterations)
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-3)

    def test_3d_solve_odd_grid(self):
        from sparse_matrix_math_tpu.utils.generate import poisson_3d

        m = 31  # odd: textbook vertex-centred hierarchy (31 -> 15 -> 7)
        a = poisson_3d(m, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        mg = PoissonMultigrid.for_grid(m, m, m, dtype=jnp.float64)
        res = mg.solve(b, epsilon=1e-8, max_iterations=30)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)

    @pytest.mark.parametrize("nx,ny", [(128, 128), (64, 48), (34, 34)])
    def test_even_grid_stationary_converges(self, nx, ny):
        """Galerkin coarse operators are geometry-exact for ANY side
        length: the STATIONARY V-cycle iteration must converge on even
        and rectangular grids too (rediscretised hierarchies amplified
        here — the round-2 limitation this replaced)."""
        a = poisson_2d(nx, ny, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        mg = PoissonMultigrid.for_grid(nx, ny, dtype=jnp.float64)
        res = mg.solve(b, epsilon=1e-8, max_iterations=30)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) <= 15  # ~4-10x contraction per cycle
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)

    def test_anisotropic_grid_coarsening_bounded(self):
        """A 512 x 8 grid must not leave a huge dense coarsest level
        (round-2 review finding: min-side-only stopping)."""
        mg = PoissonMultigrid.for_grid(512, 8, dtype=jnp.float64)
        assert mg.coarse_inv.shape[0] <= 2048
        a = poisson_2d(512, 8, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        res = smm.cg(a, b, epsilon=1e-8, preconditioner=mg)
        assert int(res.status) == SolverStatus.SUCCESS
