"""Chebyshev polynomial preconditioner — the fully parallel choice.

The reference's preconditioners are triangular-substitution based (SGS
h:1672-1711, IC0 h:1802-1837) — inherently sequential applies.  A
preconditioner whose apply is k APPLICATIONS OF A ITSELF — the one
operator whose kernel is already tuned — needs no triangular solve at
all: this is classical Chebyshev polynomial preconditioning (Saad, Iterative Methods §12.3):

    M^{-1} r  =  p_k(A) r  ~=  A^{-1} r   on the spectrum [lmin, lmax]

computed by k steps of the Chebyshev semi-iteration on ``A z = r`` from
``z0 = 0`` (solvers/chebyshev.py's recurrence, fixed step count, no
convergence checks).  A fixed-step Chebyshev run is a LINEAR, SYMMETRIC
(for SPD A) operator, so it is a legitimate PCG preconditioner; spectrum
bounds come from :func:`solvers.chebyshev.lanczos_extremal` with the
same sign-aware widening the solver uses.

Composability: ``apply`` is built from the same matvec the solver uses,
so the grid-stencil fast path can run the whole preconditioned
iteration in the grid layout with zero extra machinery
(solvers/_stencil.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["ChebyshevPreconditioner", "cheby_apply_fn"]


def cheby_apply_fn(
    matvec: Callable, lmin: float, lmax: float, degree: int
) -> Callable:
    """The k-step Chebyshev-semi-iteration apply as a closure over any
    matvec (1-D, padded-2-D, or shard-local — shape-agnostic)."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0

    def apply(r):
        dtype = r.dtype
        th = jnp.asarray(theta, dtype)
        de = jnp.asarray(delta, dtype)
        # z0 = 0; d0 = r / theta; z1 = d0
        d = r / th
        z = d
        rho = de / th

        def step(carry, _):
            z, d, rho = carry
            res = r - matvec(z)
            new_rho = 1.0 / (2.0 / (de / th) - rho)
            d = new_rho * rho * d + (2.0 * new_rho / de) * res
            return (z + d, d, new_rho), None

        if degree > 1:
            (z, _, _), _ = jax.lax.scan(
                step, (z, d, rho), None, length=degree - 1
            )
        return z

    return apply


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChebyshevPreconditioner:
    """Polynomial preconditioner M^{-1} = p_degree(A).

    Holds the operator it preconditions (any registered format / matvec
    source) plus static spectrum bounds and degree.  SPD ``a`` required
    for PCG use (the fixed-step operator is then symmetric positive
    definite).
    """

    a: object
    lmin: float = dataclasses.field(metadata=dict(static=True))
    lmax: float = dataclasses.field(metadata=dict(static=True))
    degree: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_matrix(
        cls,
        a,
        *,
        degree: int = 4,
        eig_bounds: Optional[Tuple[float, float]] = None,
    ) -> "ChebyshevPreconditioner":
        """Build with Lanczos-estimated (sign-aware widened) bounds when
        ``eig_bounds`` is not supplied."""
        if degree < 1:
            raise ValueError("degree must be >= 1")
        if eig_bounds is None:
            from ..solvers.chebyshev import lanczos_extremal, widen_eig_bounds

            lo, hi = lanczos_extremal(a)
            eig_bounds = widen_eig_bounds(lo, hi)
        return cls(
            a=a, lmin=float(eig_bounds[0]), lmax=float(eig_bounds[1]),
            degree=int(degree),
        )

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        from ..ops.spmv import matvec_fn

        return cheby_apply_fn(
            matvec_fn(self.a), self.lmin, self.lmax, self.degree
        )(r)
