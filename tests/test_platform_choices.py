"""Choices the library makes for the GPU, checked on the CPU: the
persistent compile cache location, the pinned precision of dense
products, format selection, and the DIA-factor SGS against its CSR
twin."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.utils import compile_cache
from sparse_matrix_math_tpu.utils.generate import (
    convection_diffusion_2d,
    poisson_2d,
    random_spd_csr,
    reservoir_3d,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- compile cache ------------------------------------------------------------


def test_default_cache_dir_is_fixed_inside_checkout():
    path = compile_cache.default_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert path == compile_cache.default_cache_dir()
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_var_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path))
    assert compile_cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_env_uses_default_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compilation_cache()
        assert path == compile_cache.default_cache_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# -- precision of dense products --------------------------------------------


def _dot_precisions(fn, *args):
    """Precision configs of every dot_general in fn's jaxpr (nested
    jaxprs included)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _all_highest(precs):
    hi = jax.lax.Precision.HIGHEST
    return bool(precs) and all(
        p is not None and all(q == hi for q in (p if isinstance(p, tuple) else (p,)))
        for p in precs
    )


def _nonsym():
    a = smm.dia_from_csr(convection_diffusion_2d(8, dtype=np.float32))
    return a, a @ jnp.ones(a.shape[0], jnp.float32)


@pytest.mark.parametrize("s_step", [1, 4])
def test_gmres_products_pinned_highest(s_step):
    a, b = _nonsym()
    precs = _dot_precisions(
        lambda b: smm.gmres(a, b, restart=8, s_step=s_step,
                            max_iterations=16).x, b,
    )
    assert _all_highest(precs), precs


def test_arnoldi_basis_products_pinned_highest():
    from sparse_matrix_math_tpu.solvers.gmres import arnoldi_basis

    a, b = _nonsym()
    assert _all_highest(_dot_precisions(lambda b: arnoldi_basis(a, b, 6), b))


def test_block_dense_operator_pinned_highest():
    dense = jnp.asarray(np.asarray(poisson_2d(4).to_dense(), np.float32))
    B = jnp.ones((16, 2), jnp.float32)
    precs = _dot_precisions(lambda B: smm.cg_multi(dense, B).x, B)
    assert _all_highest(precs), precs


def test_deflated_cg_pinned_highest():
    a = poisson_2d(8, dtype=np.float32)
    b = a @ jnp.ones(64, jnp.float32)
    w = jnp.asarray(np.linalg.eigh(np.asarray(a.to_dense()))[1][:, :3],
                    jnp.float32)
    precs = _dot_precisions(
        lambda b: smm.deflated_cg(a, b, deflation_basis=w).x, b
    )
    assert _all_highest(precs), precs


def test_vector_dot_pinned_highest():
    x = jnp.ones(8, jnp.float32)
    assert _all_highest(_dot_precisions(smm.dot, x, x))


# -- format selection -----------------------------------------------------------


def test_best_format_picks_stencil_first():
    assert isinstance(smm.best_format(poisson_2d(10)), smm.GridStencilMatrix)


def test_best_format_picks_dia_for_variable_diagonals():
    a = poisson_2d(10)
    rng = np.random.default_rng(0)
    a = a.with_data(jnp.asarray(np.asarray(a.data) * rng.uniform(1, 2, a.nnz)))
    assert isinstance(smm.best_format(a), smm.DIAMatrix)


def test_best_format_keeps_csr_for_general_patterns():
    a = random_spd_csr(200, density=0.05, seed=1)
    assert smm.best_format(a) is a


# -- DIA-factor SGS against the CSR SGS -----------------------------------------


@pytest.mark.parametrize("nx", [12, 20, 28])
def test_bicgstab_sgs_dia_matches_csr_iterations(nx):
    """solve(dia, ..., 'sgs') builds SGS on the DIA factors,
    solve(csr, ..., 'sgs', method='jacobi', sweeps=4) on the CSR factors:
    same arithmetic, same iteration count and solution."""
    a = convection_diffusion_2d(nx, dtype=np.float64)
    dia = smm.dia_from_csr(a)
    b = a @ jnp.ones(a.shape[0], jnp.float64)
    r_dia = smm.solve(dia, b, method="bicgstab", preconditioner="sgs",
                      epsilon=1e-9)
    r_csr = smm.solve(a, b, method="bicgstab", preconditioner="sgs",
                      preconditioner_options=dict(method="jacobi", sweeps=4),
                      epsilon=1e-9)
    assert int(r_dia.status) == int(r_csr.status) == 0
    assert int(r_dia.iterations) == int(r_csr.iterations)
    np.testing.assert_allclose(np.asarray(r_dia.x), np.asarray(r_csr.x),
                               rtol=1e-8, atol=1e-8)


# -- generated nonsymmetric reservoir-class matrices ---------------------------


def test_reservoir_3d_is_seeded_nonsymmetric_m_matrix():
    a = reservoir_3d(5, seed=3)
    d = np.asarray(a.to_dense())
    assert np.array_equal(d, np.asarray(reservoir_3d(5, seed=3).to_dense()))
    assert not np.allclose(d, d.T)
    off = d - np.diag(np.diag(d))
    assert np.all(off <= 0)
    # column diagonal dominance, strict through the accumulation term
    assert np.all(np.diag(d) > np.abs(off).sum(axis=0))


def test_reservoir_3d_jitter_keeps_diagonal():
    a = reservoir_3d(5, seed=3)
    j = reservoir_3d(5, seed=3, jitter=True)
    np.testing.assert_array_equal(
        np.diag(np.asarray(j.to_dense())), np.diag(np.asarray(a.to_dense()))
    )
