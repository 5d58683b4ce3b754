"""Differentiable solves via implicit differentiation.

A JAX-native capability with no reference equivalent: the solution
``x = A^{-1} b`` of an SPD system is made differentiable with
``jax.custom_vjp`` using the implicit function theorem instead of
unrolling the Krylov loop (which ``lax.while_loop`` cannot reverse-
differentiate anyway):

    dL/db      = A^{-1} g          (one more CG solve, A symmetric)
    dL/dA_ij   = -(A^{-1} g)_i x_j  evaluated only at stored positions

This lets solves sit inside optimisation/ML pipelines (e.g. learning
stencil coefficients) at the cost of one extra solve per backward pass.
Supports CSR and DIA matrices.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..formats.csr import CSRMatrix
from ..formats.dia import DIAMatrix
from .cg import conjugate_gradient

__all__ = ["cg_solve"]


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def cg_solve(a, b, epsilon: float = 1e-8, max_iterations: int = -1):
    """Differentiable ``x = A^{-1} b`` for SPD ``a`` (CSR or DIA).

    Forward = ConjugateGradient; backward = implicit differentiation
    (one adjoint CG solve).  Returns only the solution vector ``x`` —
    use :func:`..cg` directly when status/iteration metadata is needed
    (metadata is not differentiable).
    """
    return conjugate_gradient(
        a, b, epsilon=epsilon, max_iterations=max_iterations
    ).x


def _fwd(a, b, epsilon, max_iterations):
    x = cg_solve(a, b, epsilon, max_iterations)
    return x, (a, x)


def _bwd(epsilon, max_iterations, residuals, g):
    a, x = residuals
    # adjoint solve: A lam = g  (A symmetric)
    lam = conjugate_gradient(
        a, g, epsilon=epsilon, max_iterations=max_iterations
    ).x
    grad_b = lam
    if isinstance(a, CSRMatrix):
        grad_data = -jnp.take(lam, a.row_ids) * jnp.take(x, a.indices)
        grad_a = dataclasses.replace(
            a,
            data=grad_data,
            indices=jnp.zeros_like(a.indices),
            indptr=jnp.zeros_like(a.indptr),
            row_ids=jnp.zeros_like(a.row_ids),
        )
    elif isinstance(a, DIAMatrix):
        n_rows, n_cols = a.shape
        idx = jnp.arange(n_rows)
        rows = []
        for off in a.offsets:
            cols = idx + off
            valid = (cols >= 0) & (cols < n_cols)
            xs = jnp.take(x, jnp.clip(cols, 0, n_cols - 1))
            rows.append(jnp.where(valid, -lam * xs, 0.0))
        grad_a = dataclasses.replace(a, diags=jnp.stack(rows))
    else:
        raise TypeError(
            f"cg_solve gradients support CSR/DIA, got {type(a).__name__}"
        )
    return grad_a, grad_b


cg_solve.defvjp(_fwd, _bwd)
