"""rmult for every remaining format against a float64 scipy CSR product.

The pattern classes are the ones the general-pattern layouts were built
for: a banded matrix with holes, the jittered 3-D Laplacian, a shuffled
mesh, uniform random, a matrix with empty rows, and a rectangular one;
the diagonal-structured formats (DIA, matrix-free stencil) run on the
stencil systems.  Each case runs in f32 and f64, on a vector and on a
(n, 3) panel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_coo
from sparse_matrix_math_tpu.formats.reorder import permute_csr
from sparse_matrix_math_tpu.formats.triplet import COOArrays
from sparse_matrix_math_tpu.utils.generate import (
    convection_diffusion_2d,
    laplace_3d_jittered,
    poisson_2d,
    poisson_3d,
    uniform_random_csr,
)


def _from_coo(r, c, v, shape, dtype):
    key = r.astype(np.int64) * shape[1] + c
    key, idx = np.unique(key, return_index=True)
    return csr_from_coo(COOArrays(
        rows=key // shape[1], cols=key % shape[1],
        vals=v[idx].astype(dtype), shape=shape,
    ))


def _banded_broken(dtype):
    rng = np.random.default_rng(0)
    n = 240
    r = np.repeat(np.arange(n), 9)
    c = np.clip(r + np.tile(np.arange(-4, 5), n), 0, n - 1)
    keep = rng.random(r.shape[0]) < 0.6
    return _from_coo(r[keep], c[keep], rng.standard_normal(r.shape[0])[keep],
                     (n, n), dtype)


def _mesh_like(dtype):
    a = poisson_2d(15, dtype=dtype)
    return permute_csr(a, np.random.default_rng(1).permutation(a.shape[0]))


def _empty_rows(dtype):
    rng = np.random.default_rng(2)
    n = 200
    r = rng.integers(0, n, 900)
    r = r[r % 7 != 0]  # every 7th row empty
    c = rng.integers(0, n, r.shape[0])
    return _from_coo(r, c, rng.standard_normal(r.shape[0]), (n, n), dtype)


def _rectangular(dtype):
    rng = np.random.default_rng(3)
    r = rng.integers(0, 150, 1000)
    c = rng.integers(0, 260, 1000)
    return _from_coo(r, c, rng.standard_normal(1000), (150, 260), dtype)


PATTERNS = {
    "banded_broken": _banded_broken,
    "laplace_3d_jittered": lambda dt: laplace_3d_jittered(6, dtype=dt),
    "mesh_like": _mesh_like,
    "uniform_random": lambda dt: uniform_random_csr(300, dtype=dt),
    "empty_rows": _empty_rows,
    "rectangular": _rectangular,
}

FORMATS = {
    "csr": lambda a: a,
    "ell": smm.ell_from_csr,
    "hyb": smm.hyb_from_csr,
    "reordered": smm.reorder_rcm,
}

STENCILS = {
    "poisson_2d": lambda dt: poisson_2d(14, dtype=dt),
    "poisson_3d": lambda dt: poisson_3d(7, dtype=dt),
    "convection_diffusion_2d": lambda dt: convection_diffusion_2d(13, dtype=dt),
}


def _scipy(a):
    return sp.csr_matrix(
        (np.asarray(a.data, np.float64), np.asarray(a.indices),
         np.asarray(a.indptr)), shape=a.shape,
    )


def _check(op, a, dtype, panel):
    rng = np.random.default_rng(7)
    shape = (a.shape[1], 3) if panel else (a.shape[1],)
    x = rng.standard_normal(shape).astype(dtype)
    y = np.asarray(smm.rmult(op, jnp.asarray(x)), np.float64)
    y_ref = _scipy(a) @ x.astype(np.float64)
    assert y.shape == y_ref.shape
    tol = 1e-5 if dtype == np.float32 else 1e-12
    scale = max(float(np.max(np.abs(y_ref))), 1.0)
    np.testing.assert_allclose(y, y_ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("panel", [False, True], ids=["vector", "panel"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_general_pattern_rmult(fmt, pattern, dtype, panel):
    a = PATTERNS[pattern](dtype)
    if fmt == "reordered" and a.shape[0] != a.shape[1]:
        with pytest.raises(ValueError):
            FORMATS[fmt](a)
        return
    _check(FORMATS[fmt](a), a, dtype, panel)


@pytest.mark.parametrize("panel", [False, True], ids=["vector", "panel"])
@pytest.mark.parametrize("system", sorted(STENCILS))
@pytest.mark.parametrize("fmt", ["dia", "stencil"])
def test_stencil_system_rmult(fmt, system, dtype, panel):
    a = STENCILS[system](dtype)
    op = smm.dia_from_csr(a)
    if fmt == "stencil":
        op = smm.try_grid_stencil_from_csr(a, dia=op)
        assert op is not None
    _check(op, a, dtype, panel)
