"""Dense-vector primitives: dot, norms, axpy.

Equivalents of the reference ``Vector<T>`` operations
(include/sparse_matrix_math.h:42-381).  The reference's dot product uses
a TBB ``parallel_deterministic_reduce`` with grain 8192 for reproducible
sums (h:305-328); XLA reductions have a fixed order per compiled
program, so results are deterministic run-to-run by construction —
determinism across *different* meshes is covered by the distributed layer
(parallel/).

There is deliberately no mutable Vector class: JAX arrays + pure
functions replace init/fill/+=/-= (h:226-285).  A thin :class:`Vector`
alias exists only for API-discovery parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "dot",
    "norm2",
    "norm2_squared",
    "axpy",
    "xpay",
    "fill",
    "Vector",
]


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Inner product (reference operator*, h:305-328)."""
    return jnp.dot(
        a, b, precision=jax.lax.Precision.HIGHEST, preferred_element_type=a.dtype
    )


def norm2_squared(a: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 norm (reference secondNormSquared, h:296-303)."""
    return dot(a, a)


def norm2(a: jnp.ndarray) -> jnp.ndarray:
    """L2 norm (reference secondNorm, h:287-294)."""
    return jnp.sqrt(norm2_squared(a))


def axpy(alpha, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """alpha * x + y — the fused update inside every solver iteration
    (e.g. h:2060-2072)."""
    return alpha * x + y


def xpay(x: jnp.ndarray, alpha, y: jnp.ndarray) -> jnp.ndarray:
    """x + alpha * y — the search-direction update p = r + beta*p
    (h:2384-2394)."""
    return x + alpha * y


def fill(n: int, value, dtype=jnp.float32) -> jnp.ndarray:
    """Constant vector (reference Vector::fill / init, h:226-232, 360-367)."""
    return jnp.full((n,), value, dtype=dtype)


# API-parity alias: the reference's Vector<T> is just a 1-D array here.
Vector = jnp.ndarray
