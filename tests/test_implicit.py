"""Differentiable-solve (implicit differentiation) and multi-RHS vmap
tests — JAX-native capabilities beyond the reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sparse_matrix_math_tpu as smm
from sparse_matrix_math_tpu.formats.dia import dia_from_csr
from sparse_matrix_math_tpu.solvers.implicit import cg_solve
from sparse_matrix_math_tpu.utils.generate import poisson_2d


@pytest.fixture(scope="module")
def system():
    a = poisson_2d(6)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(36))
    return a, b


class TestImplicitDiff:
    def test_forward_matches_cg(self, system):
        a, b = system
        x = cg_solve(a, b, 1e-12)
        ref = smm.cg(a, b, epsilon=1e-12).x
        np.testing.assert_allclose(np.asarray(x), np.asarray(ref), atol=1e-11)

    def test_grad_b_matches_fd(self, system):
        a, b = system

        def loss(b_):
            return jnp.sum(cg_solve(a, b_, 1e-12) ** 2)

        g = jax.grad(loss)(b)
        eps = 1e-6
        for k in (0, 17, 35):
            fd = (loss(b.at[k].add(eps)) - loss(b.at[k].add(-eps))) / (2 * eps)
            np.testing.assert_allclose(float(g[k]), float(fd), rtol=1e-5)

    def test_grad_csr_data_matches_fd(self, system):
        a, b = system

        def loss(data):
            return jnp.sum(cg_solve(dataclasses.replace(a, data=data), b, 1e-12) ** 2)

        g = jax.grad(loss)(a.data)
        eps = 1e-6
        for k in (0, 7, 50):
            fd = (
                loss(a.data.at[k].add(eps)) - loss(a.data.at[k].add(-eps))
            ) / (2 * eps)
            np.testing.assert_allclose(float(g[k]), float(fd), rtol=1e-5)

    def test_grad_dia_matches_fd(self, system):
        a, b = system
        d = dia_from_csr(a)

        def loss(diags):
            return jnp.sum(
                cg_solve(dataclasses.replace(d, diags=diags), b, 1e-12) ** 2
            )

        g = jax.grad(loss)(d.diags)
        eps = 1e-6
        for (i, j) in [(2, 5), (1, 10), (3, 20)]:
            fd = (
                loss(d.diags.at[i, j].add(eps))
                - loss(d.diags.at[i, j].add(-eps))
            ) / (2 * eps)
            np.testing.assert_allclose(float(g[i, j]), float(fd), rtol=1e-5)


class TestMultiRHS:
    def test_vmap_over_rhs(self):
        a = poisson_2d(10)
        targets = [
            jnp.ones(100),
            jnp.full(100, 2.0),
            jnp.arange(100.0),
        ]
        B = jnp.stack([a @ t for t in targets])
        sols = jax.vmap(lambda b: smm.cg(a, b, epsilon=1e-10).x)(B)
        for sol, t in zip(sols, targets):
            np.testing.assert_allclose(np.asarray(sol), np.asarray(t), atol=1e-8)
