"""Distributed matrix-free grid stencils (parallel/dist_stencil.py) on
the simulated 8-device mesh."""

import numpy as np
import pytest

import jax.numpy as jnp

from sparse_matrix_math_tpu import SolverStatus
from sparse_matrix_math_tpu.formats.stencil import try_grid_stencil_from_csr
from sparse_matrix_math_tpu.parallel import (
    collect,
    dist_stencil_solve,
    dist_stencil_spmv,
    distribute_stencil,
    make_mesh,
)
from sparse_matrix_math_tpu.parallel.dist import distribute_vector
from sparse_matrix_math_tpu.utils.generate import (
    convection_diffusion_2d,
    poisson_2d,
    poisson_3d,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.mark.parametrize("gen,nx", [
    (poisson_2d, 36),
    (poisson_3d, 11),          # n = 1331: uneven blocks + padded tail
    (convection_diffusion_2d, 30),
])
def test_spmv_matches_dense(gen, nx, mesh):
    a = gen(nx, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    assert st is not None
    ds = distribute_stencil(st, mesh)
    n = a.shape[0]
    x = np.random.default_rng(0).standard_normal(n)
    xv = distribute_vector(x, ds, mesh)
    y = np.asarray(collect(dist_stencil_spmv(ds, xv, mesh), ds))[:n]
    y_ref = np.asarray(a.to_dense()) @ x
    np.testing.assert_allclose(y, y_ref, atol=1e-12)


@pytest.mark.parametrize("gen,solver", [
    (poisson_2d, "cg"),
    (poisson_2d, "bicg_symmetric"),
    (convection_diffusion_2d, "bicgstab"),
    (convection_diffusion_2d, "cgs"),
])
def test_solve_all_ones_oracle(gen, solver, mesh):
    a = gen(30, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    ds = distribute_stencil(st, mesh)
    b = np.asarray(a.to_dense()).sum(axis=1)  # rhs = row sums -> x = 1
    res = dist_stencil_solve(ds, b, solver=solver, epsilon=1e-10)
    assert int(res.status) == SolverStatus.SUCCESS, (solver, res)
    x = np.asarray(collect(res.x, ds))[: a.shape[0]]
    assert np.abs(x - 1.0).max() < 1e-8


def test_solve_matches_single_chip(mesh):
    a = poisson_2d(24, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    ds = distribute_stencil(st, mesh)
    n = a.shape[0]
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n)
    import sparse_matrix_math_tpu as smm

    ref = smm.cg(st, jnp.asarray(b), epsilon=1e-11)
    res = dist_stencil_solve(ds, b, solver="cg", epsilon=1e-11)
    x = np.asarray(collect(res.x, ds))[:n]
    np.testing.assert_allclose(x, np.asarray(ref.x), atol=1e-9)


def test_dist_solve_dispatches_stencil(mesh):
    """dist_solve is the one distributed front door: a DistStencil
    operand runs the matrix-free path, and preconditioning it is
    refused."""
    from sparse_matrix_math_tpu.parallel import dist_solve

    a = poisson_3d(10, dtype=np.float64)
    ds = distribute_stencil(try_grid_stencil_from_csr(a), mesh)
    b = np.asarray(a.to_dense()).sum(axis=1)
    res = dist_solve(ds, b, epsilon=1e-10)
    assert int(res.status) == SolverStatus.SUCCESS
    assert res.x.shape == (ds.padded_rows,)
    assert len(res.x.addressable_shards) == mesh.size
    np.testing.assert_allclose(collect(res.x, ds), 1.0, atol=1e-8)
    with pytest.raises(ValueError):
        dist_solve(ds, b, preconditioner=object())
