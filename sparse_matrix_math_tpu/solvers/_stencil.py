"""Grid-resident solver fast path for matrix-free stencils.

For :class:`GridStencilMatrix` operators (formats/stencil.py) every
solver vector stays in the N-D grid layout across the whole
``lax.while_loop`` — reshape once before the loop, once after — so each
iteration is the bare fused stencil pass plus the vector ops, with no
per-call reshapes.  The algorithm cores are shape-agnostic (matvec +
dotfn parameterised); this module is plumbing only.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..formats.stencil import GridStencilMatrix
from .bicg_symmetric import bicg_symmetric_core
from .bicgstab import bicgstab_core
from .cg import cg_core, pcg_core
from .cgs import cgs_core
from .types import SolveResult

__all__ = ["eligible", "stencil_solve"]

_CORES = {
    "cg": cg_core,
    "bicg_symmetric": bicg_symmetric_core,
    "cgs": cgs_core,
    "bicgstab": bicgstab_core,
}


def eligible(a, preconditioner=None) -> bool:
    """Use the grid fast path?  (GridStencilMatrix operator and a
    preconditioner representable in the grid domain: None, Jacobi —
    whose inverse diagonal reshapes — or Chebyshev wrapping ``a``
    itself, whose apply is k stencil passes.)"""
    from ..precond.cheby_poly import ChebyshevPreconditioner
    from ..precond.preconditioners import JacobiPreconditioner

    if not isinstance(a, GridStencilMatrix):
        return False
    if preconditioner is None:
        return True
    if isinstance(preconditioner, JacobiPreconditioner):
        return True
    if isinstance(preconditioner, ChebyshevPreconditioner):
        return preconditioner.a is a
    return False


def stencil_solve(
    core_name: str,
    a: GridStencilMatrix,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    eps,
    maxiter: int,
    record: bool,
    preconditioner=None,
) -> SolveResult:
    """Run the solve with grid-resident carries (callers check
    :func:`eligible` first)."""
    from ..precond.cheby_poly import ChebyshevPreconditioner
    from ..precond.preconditioners import JacobiPreconditioner

    pre_kind, inv_diag, cheby = "none", None, None
    if isinstance(preconditioner, JacobiPreconditioner):
        pre_kind, inv_diag = "jacobi", preconditioner.inv_diag
    elif isinstance(preconditioner, ChebyshevPreconditioner):
        pre_kind = "cheby"
        cheby = (
            preconditioner.lmin, preconditioner.lmax, preconditioner.degree
        )
    return _stencil_solve_jit(
        core_name, a, b, x0, jnp.asarray(eps, b.dtype), inv_diag,
        pre_kind, cheby, maxiter, record,
    )


@partial(jax.jit, static_argnums=(0, 6, 7, 8, 9))
def _stencil_solve_jit(
    core_name: str, a, b, x0, eps, inv_diag, pre_kind: str, cheby,
    maxiter: int, record: bool,
) -> SolveResult:
    matvec = a.apply_grid

    def dotfn(u, v):
        return jnp.sum(u * v)

    bg = a.to_grid(b)
    x0g = a.to_grid(x0)

    if pre_kind == "jacobi":
        invg = a.to_grid(inv_diag)
        apply_ = lambda r: r * invg  # noqa: E731
    elif pre_kind == "cheby":
        from ..precond.cheby_poly import cheby_apply_fn

        apply_ = cheby_apply_fn(matvec, *cheby)
    else:
        apply_ = None

    if core_name == "cg" and apply_ is not None:
        res = pcg_core(matvec, apply_, dotfn, bg, x0g, eps, maxiter, record)
    elif core_name == "bicgstab":
        res = bicgstab_core(
            matvec, apply_ or (lambda v: v), dotfn, bg, x0g, eps, maxiter,
            record,
        )
    else:
        res = _CORES[core_name](matvec, dotfn, bg, x0g, eps, maxiter, record)
    return dataclasses.replace(res, x=a.from_grid(res.x))
