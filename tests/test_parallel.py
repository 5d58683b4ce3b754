"""Distributed-layer tests on a simulated 8-device CPU mesh (SURVEY §4:
multi-chip logic must be testable without a pod)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.parallel import (
    collect,
    dist_solve,
    dist_spmv,
    distribute_csr,
    distribute_preconditioner,
    distribute_vector,
    make_mesh,
)
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import poisson_2d, random_spd_csr

from conftest import inf_eps, l2_eps

@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _ones_system(a):
    """rhs = row sums => exact solution all-ones (reference oracle,
    test/include/test_common.h:13-21)."""
    return np.asarray(a.to_dense()).sum(axis=1)


class TestDistSpMV:
    def test_matches_single_chip(self, mesh, dtype):
        a = poisson_2d(13, dtype=dtype)  # 169 rows: uneven over 8 shards
        da = distribute_csr(a, mesh)
        x = np.random.default_rng(3).standard_normal(a.shape[0]).astype(dtype)
        xp = distribute_vector(x, da, mesh)
        y = collect(dist_spmv(da, xp, mesh), da)
        y_ref = np.asarray(a.rmult(jnp.asarray(x)))
        np.testing.assert_allclose(y, y_ref, rtol=1e-5 if dtype == np.float32 else 1e-12)

    def test_unstructured_matrix(self, mesh, dtype):
        a = random_spd_csr(97, density=0.2, seed=5, dtype=dtype)
        da = distribute_csr(a, mesh)
        x = np.random.default_rng(7).standard_normal(97).astype(dtype)
        xp = distribute_vector(x, da, mesh)
        y = collect(dist_spmv(da, xp, mesh), da)
        y_ref = np.asarray(a.rmult(jnp.asarray(x)))
        np.testing.assert_allclose(
            y, y_ref, rtol=2e-4 if dtype == np.float32 else 1e-11
        )


class TestHaloExchange:
    def test_auto_mode_detection(self, mesh):
        # Poisson offsets (±1, ±nx) fit the neighbor window when B >= nx
        a = poisson_2d(16)  # n=256, B=32 >= 16
        assert distribute_csr(a, mesh).mode == "halo"
        # random pattern spans the full width -> allgather
        r = random_spd_csr(97, density=0.2, seed=5)
        assert distribute_csr(r, mesh).mode == "allgather"

    def test_halo_matches_allgather(self, mesh, dtype):
        a = poisson_2d(16, dtype=dtype)
        x = np.random.default_rng(1).standard_normal(a.shape[0]).astype(dtype)
        ys = {}
        for mode in ("halo", "allgather"):
            da = distribute_csr(a, mesh, mode=mode)
            assert da.mode == mode
            xp = distribute_vector(x, da, mesh)
            ys[mode] = collect(dist_spmv(da, xp, mesh), da)
        # halo mode splits interior/boundary terms for collective overlap
        # (dist.py:_local_spmv) so the summation ORDER differs from the
        # allgather mode — equality holds to reduction-reorder epsilon,
        # not bitwise.  (Bitwise determinism across REPEATED runs of the
        # same mode is covered by test_robustness.py.)
        tol = 1e-5 if dtype == np.float32 else 1e-13
        np.testing.assert_allclose(
            ys["halo"], ys["allgather"], rtol=tol, atol=tol
        )

    def test_halo_rejects_wide_pattern(self, mesh):
        r = random_spd_csr(97, density=0.2, seed=5)
        with pytest.raises(ValueError, match="neighbor window"):
            distribute_csr(r, mesh, mode="halo")

    def test_halo_preconditioned_solve(self, mesh):
        a = poisson_2d(16)
        da = distribute_csr(a, mesh, mode="halo")
        b = _ones_system(a)
        p = smm.get_preconditioner(a, "sgs", method="jacobi", sweeps="exact")
        dp = distribute_preconditioner(p, da, mesh)
        res = dist_solve(
            da, b, solver="bicgstab", preconditioner=dp, epsilon=1e-9, mesh=mesh
        )
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-6)


class TestDistSolve:
    @pytest.mark.parametrize("solver", ["cg", "bicg_symmetric", "cgs", "bicgstab"])
    def test_all_solvers_converge(self, mesh, solver):
        a = poisson_2d(16)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        res = dist_solve(da, b, solver=solver, epsilon=1e-8, mesh=mesh)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-7)

    def test_gmres_distributed(self, mesh):
        """Distributed GMRES: the Arnoldi panel contraction psums over
        the row axis; iterates must MATCH the single-chip gmres (same
        algorithm, deterministic collectives) on a nonsymmetric system."""
        from sparse_matrix_math_tpu.utils.generate import (
            convection_diffusion_2d,
        )

        a = convection_diffusion_2d(16, cx=0.6, cy=0.2, dtype=np.float64)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        res = dist_solve(da, b, solver="gmres", epsilon=1e-10, mesh=mesh,
                         restart=20)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-7)
        single = smm.gmres(a, jnp.asarray(b), epsilon=1e-10, restart=20)
        assert int(res.iterations) == int(single.iterations)

    def test_gmres_distributed_preconditioned(self, mesh):
        a = poisson_2d(16)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        p = smm.get_preconditioner(a, "jacobi")
        dp = distribute_preconditioner(p, da, mesh)
        plain = dist_solve(da, b, solver="gmres", epsilon=1e-9, mesh=mesh)
        res = dist_solve(da, b, solver="gmres", preconditioner=dp,
                         epsilon=1e-9, mesh=mesh)
        assert int(res.status) == SolverStatus.SUCCESS
        assert int(res.iterations) <= int(plain.iterations)
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-6)

    def test_pipelined_cg_distributed(self, mesh):
        """Communication-avoiding CG: one fused psum per iteration."""
        a = poisson_2d(16)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        res = dist_solve(da, b, solver="cg_pipelined", epsilon=1e-10, mesh=mesh)
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-9)

    def test_chebyshev_distributed(self, mesh):
        """Dot-free distributed solver: one psum per check_every steps."""
        a = poisson_2d(16)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        res = dist_solve(
            da, b, solver="chebyshev", epsilon=1e-9, max_iterations=3000,
            mesh=mesh,
        )
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-8)

    def test_matches_single_chip_iterates(self, mesh):
        """Distributed CG must take the same iteration count as single-chip
        (identical algorithm; sums differ only by reduction order)."""
        a = poisson_2d(16)
        b = _ones_system(a)
        single = smm.cg(a, jnp.asarray(b), epsilon=1e-10)
        da = distribute_csr(a, mesh)
        res = dist_solve(da, b, solver="cg", epsilon=1e-10, mesh=mesh)
        assert abs(int(res.iterations) - int(single.iterations)) <= 1

    @pytest.mark.parametrize("kind", ["jacobi", "sgs", "ic0", "ilu0"])
    def test_preconditioned(self, mesh, kind):
        a = poisson_2d(12)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        p = smm.get_preconditioner(a, kind, method="jacobi", sweeps="exact") \
            if kind != "jacobi" else smm.get_preconditioner(a, kind)
        dp = distribute_preconditioner(p, da, mesh)
        solver = "cg" if kind in ("jacobi", "ic0") else "bicgstab"
        res = dist_solve(
            da, b, solver=solver, preconditioner=dp, epsilon=1e-9, mesh=mesh
        )
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-6)

    def test_max_iterations_reached(self, mesh):
        a = poisson_2d(16)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        res = dist_solve(da, b, solver="cg", max_iterations=2, epsilon=1e-12, mesh=mesh)
        assert int(res.status) == SolverStatus.MAX_ITERATIONS_REACHED
        assert int(res.iterations) == 2

    def test_record_residuals(self, mesh):
        a = poisson_2d(10)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        res = dist_solve(
            da, b, solver="cg", epsilon=1e-9, mesh=mesh, record_residuals=True
        )
        trace = np.asarray(res.residual_trace)
        k = int(res.iterations)
        assert np.isfinite(trace[: k + 1]).all()
        assert trace[k] <= 1e-9


class TestDistCheckpoint:
    def test_checkpointed_dist_solve(self, mesh, tmp_path):
        """checkpointed_solve composes with dist_solve: restart chunks
        snapshot the sharded (padded) x and resume it (SURVEY §5)."""
        import functools

        from sparse_matrix_math_tpu.utils.checkpoint import (
            checkpointed_solve,
            load_checkpoint,
        )

        a = poisson_2d(16)
        da = distribute_csr(a, mesh)
        b = _ones_system(a)
        solver = functools.partial(dist_solve, solver="cg", mesh=mesh)
        path = str(tmp_path / "ck.npz")
        res = checkpointed_solve(
            solver, da, b,
            checkpoint_path=path, chunk_iterations=25, epsilon=1e-10,
        )
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=1e-8)
        assert load_checkpoint(path).iterations_done == int(res.iterations)


class TestDistVsReferenceSuite:
    """Same .mtx assets + oracle + tolerances as the reference suite,
    through the distributed path."""

    def test_mesh_matrices(self, mesh, dtype):
        from conftest import MESH_MATRICES, asset_path

        for name in MESH_MATRICES:
            a = smm.load_matrix_csr(asset_path(name), dtype=dtype)
            da = distribute_csr(a, mesh)
            b = _ones_system(a).astype(dtype)
            res = dist_solve(
                da, b, solver="cg", epsilon=l2_eps(dtype), mesh=mesh
            )
            assert int(res.status) == SolverStatus.SUCCESS, name
            assert np.abs(collect(res.x, da) - 1.0).max() <= inf_eps(dtype)


class TestDistDIA:
    """Distributed DIA fast path (parallel/dist_dia.py): the Pallas-class
    stencil SpMV runs inside shard_map with the O(B) neighbor halo and
    interior/boundary overlap — parity vs the single-chip DIA path."""

    def _dia(self, nx=40, dtype=np.float64):
        from sparse_matrix_math_tpu.formats.dia import dia_from_csr

        a = poisson_2d(nx, dtype=dtype)
        return a, dia_from_csr(a)

    def test_spmv_parity(self, mesh):
        from sparse_matrix_math_tpu.parallel import (
            dist_dia_spmv,
            distribute_dia,
        )

        csr, dia = self._dia()
        d = distribute_dia(dia, mesh)
        rng = np.random.default_rng(0)
        x = rng.standard_normal(csr.shape[0])
        xs = distribute_vector(x, d, mesh)
        y = collect(dist_dia_spmv(d, xs, mesh), d)
        want = np.asarray(dia @ jnp.asarray(x))
        np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("solver", ["cg", "bicgstab"])
    def test_solve_parity(self, mesh, solver):
        from sparse_matrix_math_tpu.parallel import (
            dist_dia_solve,
            distribute_dia,
        )

        csr, dia = self._dia()
        n = csr.shape[0]
        b = np.asarray(csr @ jnp.ones(n, jnp.float64))
        d = distribute_dia(dia, mesh)
        res = dist_dia_solve(d, b, solver=solver, epsilon=1e-10, mesh=mesh)
        assert int(res.status) == SolverStatus.SUCCESS
        x = collect(res.x, d)
        np.testing.assert_allclose(x, 1.0, atol=1e-7)
        # same algorithm, same reductions: iteration count must match the
        # single-chip solver on the same matrix
        single = getattr(smm, solver)(csr, jnp.asarray(b), epsilon=1e-10)
        assert int(res.iterations) == int(single.iterations)

    def test_offset_span_rejected(self, mesh):
        from sparse_matrix_math_tpu.formats.dia import DIAMatrix
        from sparse_matrix_math_tpu.parallel import distribute_dia

        n = 256
        far = DIAMatrix(
            diags=jnp.ones((2, n)), offsets=(0, 200), shape=(n, n), nnz=2 * n
        )
        with pytest.raises(ValueError):
            distribute_dia(far, mesh)  # block is 32 rows < offset 200


class TestMeshResolution:
    """Solve-time entry points derive their default mesh from the
    OPERAND's sharding, not from jax.devices() (parallel/mesh.py:
    resolve_mesh).  A process whose default device list differs from the
    build mesh — e.g. an accelerator plugin registered alongside the
    virtual-CPU mesh — used to shard_map an 8-shard operand over a
    1-device axis and die with a broadcast error inside the local SpMV."""

    def test_solve_defaults_to_operand_mesh(self):
        # 4-device submesh: make_mesh() would default to all 8 devices
        # and mis-shard; deriving from the operand must find the 4
        sub = make_mesh(4)
        a = poisson_2d(12, dtype=np.float32)
        da = distribute_csr(a, sub)
        b = _ones_system(a)
        res = dist_solve(da, b, solver="cg", epsilon=l2_eps(np.float32))
        assert int(res.status) == SolverStatus.SUCCESS
        np.testing.assert_allclose(collect(res.x, da), 1.0, atol=5e-3)

    def test_dia_and_df64_default_mesh(self):
        from sparse_matrix_math_tpu.formats.dia import dia_from_csr
        from sparse_matrix_math_tpu.ops.df32 import DfDiaMatrix
        from sparse_matrix_math_tpu.parallel import (
            dist_cg_ir_df64,
            dist_dia_solve,
            distribute_df_dia,
            distribute_dia,
        )

        sub = make_mesh(4)
        a = poisson_2d(8, dtype=np.float32)
        b = _ones_system(a)
        dd = distribute_dia(dia_from_csr(a), sub)
        res = dist_dia_solve(dd, b, solver="cg", epsilon=l2_eps(np.float32))
        assert int(res.status) == SolverStatus.SUCCESS

        a64 = poisson_2d(8, dtype=np.float64)
        dfa = DfDiaMatrix.from_host_csr(
            np.asarray(a64.data, np.float64),
            np.asarray(a64.indices, np.int64),
            np.asarray(a64.indptr, np.int64),
            a64.shape,
        )
        ddf = distribute_df_dia(dfa, sub)
        res7 = dist_cg_ir_df64(ddf, b.astype(np.float64), max_iterations=64)
        assert np.isfinite(res7.x_f64()).all()
        np.testing.assert_allclose(res7.x_f64(), 1.0, atol=1e-7)

    def test_mismatched_mesh_rejected(self):
        sub = make_mesh(4)
        a = poisson_2d(12, dtype=np.float32)
        da = distribute_csr(a, sub)
        with pytest.raises(ValueError, match="4 shards"):
            dist_solve(da, _ones_system(a), solver="cg", mesh=make_mesh(8))

    def test_stencil_default_mesh(self):
        from sparse_matrix_math_tpu.formats.stencil import (
            try_grid_stencil_from_csr,
        )
        from sparse_matrix_math_tpu.parallel import (
            dist_stencil_solve,
            distribute_stencil,
        )

        sub = make_mesh(4)
        a = poisson_2d(12, dtype=np.float32)
        st = try_grid_stencil_from_csr(a)
        assert st is not None
        dst = distribute_stencil(st, sub)
        res = dist_stencil_solve(
            dst, _ones_system(a), solver="cg", epsilon=l2_eps(np.float32)
        )
        assert int(res.status) == SolverStatus.SUCCESS
