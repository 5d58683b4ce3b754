"""Unified solve front-end + solver configuration.

The reference's only "configuration" is compile-time defines plus bare
function arguments (SURVEY §5 config row).  Here a :class:`SolverConfig`
dataclass captures the whole runtime configuration (method, tolerance,
iteration cap, preconditioner choice + options, dtype) and
:func:`solve` dispatches to the right solver/preconditioner pair —
the one-call API for users coming from ``SolverStatus f(A, b, x, ...)``
reference call sites.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax.numpy as jnp

from ..formats.csr import CSRMatrix
from ..precond.preconditioners import SGSPreconditioner, get_preconditioner
from .bicg_symmetric import bicg_symmetric
from .bicgstab import bicgstab
from .cg import conjugate_gradient
from .cgs import conjugate_gradient_squared
from .chebyshev import chebyshev
from .gmres import gmres
from .pipelined import cg_pipelined
from .types import SolveResult

__all__ = ["SolverConfig", "solve", "SOLVERS"]

SOLVERS = {
    "cg": conjugate_gradient,
    "conjugate_gradient": conjugate_gradient,
    "bicg_symmetric": bicg_symmetric,
    "cgs": conjugate_gradient_squared,
    "conjugate_gradient_squared": conjugate_gradient_squared,
    "bicgstab": bicgstab,
    "chebyshev": chebyshev,
    "cg_pipelined": cg_pipelined,
    "gmres": gmres,
}

# emulated-f64 methods (solvers/df64.py, solvers/ir_df64.py): dispatched
# by a dedicated branch in solve() — different operator/result types
# (DfSolveResult)
_DF64_METHODS = (
    "cg_df64", "bicgstab_df64", "cg_ir_df64", "bicgstab_ir_df64"
)

# which solvers accept a preconditioner (mirrors the reference: CG has the
# IC0 overload h:2414-2505, BiCGStab the preconditioned form h:2191-2283)
_PRECONDITIONABLE = {"cg", "conjugate_gradient", "bicgstab", "gmres"}


def _build_preconditioner(a, kind: str, options):
    """Resolve a preconditioner spec for the matrix's format.

    CSR takes every kind (get_preconditioner); DIA takes the kinds whose
    factors are representable in the diagonal domain: 'sgs'
    (SGSPreconditioner.from_dia, sweeps over the strict DIA factors) and 'chebyshev'
    (format-agnostic).
    """
    from ..formats.dia import DIAMatrix
    from ..formats.reorder import ReorderedMatrix

    if hasattr(kind, "apply"):
        # preconditioner OBJECT passthrough: anything with apply(r) -> z
        # (PoissonMultigrid, a prebuilt SGS, a user operator) rides
        # solve() directly — the reference's template-parameter spirit
        # (h:2191-2212) without the factory round trip
        return kind
    if isinstance(kind, str) and kind.lower() in ("multigrid", "mg"):
        return _build_multigrid(a, options)
    if isinstance(a, ReorderedMatrix):
        # the hoisted solvers run entirely in the permuted domain
        # (formats/reorder.py:reorder_hoisted), so the preconditioner
        # must be factored from the PERMUTED matrix
        if a.inner_csr is None:
            raise ValueError(
                "ReorderedMatrix carries no permuted CSR; pass a "
                "preconditioner object built in the permuted domain"
            )
        return _build_preconditioner(a.inner_csr, kind, options)
    if isinstance(a, CSRMatrix):
        return get_preconditioner(a, kind, **options)
    k = kind.lower() if isinstance(kind, str) else kind
    if k in ("cheby", "chebyshev", "poly", "polynomial"):
        from ..precond.cheby_poly import ChebyshevPreconditioner

        return ChebyshevPreconditioner.from_matrix(a, **options)
    if isinstance(a, DIAMatrix) and k in (
        "sgs", "symmetric_gauss_seidel", "symmetric_gaus_seidel"
    ):
        return SGSPreconditioner.from_dia(a, **options)
    raise ValueError(
        f"preconditioner {kind!r} is not buildable for "
        f"{type(a).__name__}; construct from CSR (get_preconditioner) "
        "or pass a preconditioner object directly"
    )


def _build_multigrid(a, options):
    """``preconditioner="multigrid"``: geometric V-cycle for the
    Poisson stencil family (solvers/multigrid.py).  Accepts a
    GridStencilMatrix directly; CSR/DIA inputs are verified
    entry-for-entry by the stencil detector first — multigrid silently
    applied to a non-Laplacian operator would precondition the wrong
    system."""
    from ..formats.dia import DIAMatrix
    from ..formats.stencil import (
        GridStencilMatrix,
        try_grid_stencil_from_csr,
        try_grid_stencil_from_dia,
    )
    from .multigrid import PoissonMultigrid

    st = a if isinstance(a, GridStencilMatrix) else None
    if st is None and isinstance(a, CSRMatrix):
        st = try_grid_stencil_from_csr(a)
    if st is None and isinstance(a, DIAMatrix):
        st = try_grid_stencil_from_dia(a)
    if st is None:
        raise ValueError(
            "preconditioner='multigrid' needs a Poisson-family grid "
            "stencil operator (GridStencilMatrix, or a CSR that the "
            f"stencil detector verifies); got {type(a).__name__}"
        )
    return PoissonMultigrid.for_stencil(st, **options)


def _build_preconditioner_for(a, a_source, kind, options):
    """Build for the solve operator, falling back to the CSR source.

    With ``auto_format`` the operator may be a layout (stencil/DIA)
    whose kinds aren't directly buildable — but those layouts preserve
    row/column order, so factoring from the original CSR is exact.
    (ReorderedMatrix is NOT order-preserving; _build_preconditioner's
    own branch factors from its permuted CSR first.)"""
    from ..formats.reorder import ReorderedMatrix

    try:
        return _build_preconditioner(a, kind, options)
    except ValueError:
        # never fall back across a permutation: the hoisted solvers run
        # in the permuted domain, where an original-order factor is wrong
        if a_source is a or isinstance(a, ReorderedMatrix):
            raise
        return _build_preconditioner(a_source, kind, options)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Runtime solver configuration (SURVEY §5 config-system plan)."""

    method: str = "cg"
    epsilon: float = 1e-8
    max_iterations: int = -1          # -1 => n, reference convention
    # kind string (none/jacobi/sgs/ilu0/ic0/chebyshev/multigrid) or any
    # OBJECT with apply(r) -> z — both ride the f32 path AND the df64
    # escalation path
    preconditioner: str = "none"
    preconditioner_options: Dict[str, Any] = dataclasses.field(
        default_factory=dict
    )
    record_residuals: bool = False
    # stream the MATRIX in this dtype (e.g. "bfloat16") with f32 vectors
    # and true-residual iterative refinement — solvers/mixed.py; only
    # method='cg' on DIA matrices supports it
    matrix_dtype: str = None
    # convert a CSR input through formats.best_format before solving
    # (stencil / DIA / CSR by pattern).  Off by default: pattern
    # detection costs host time that only amortises over real solves.
    auto_format: bool = False
    # when an f32 solve stops at its PRECISION FLOOR (floor_hit — a
    # verified-convergence restart could not shrink the true residual)
    # above ``epsilon``, re-route through the double-word refinement
    # (cg_ir_df64 / bicgstab_ir_df64) warm-started from the floored
    # iterate, delivering the reference's f64-default accuracy contract
    # (test/include/test_common.h:30-38) with f32 storage.  The
    # escalated call returns a DfSolveResult.  Opt out to get the bare
    # floored SolveResult back.
    auto_escalate: bool = True

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


def solve(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    config: Optional[SolverConfig] = None,
    **overrides,
):
    """Solve ``a @ x = b`` according to ``config`` (plus keyword overrides).

    Returns a ``SolveResult`` normally; a ``MultiSolveResult`` for a 2-D
    ``b`` of shape (n, m) (a multi-RHS panel routed through
    :func:`solvers.block.cg_multi`, per-column statuses); and a
    ``DfSolveResult`` for the df64 methods or when ``auto_escalate``
    re-routes an f32 request below f32's precision floor
    through the double-word refinement (see :class:`SolverConfig`).

    >>> solve(a, b, method="bicgstab", preconditioner="sgs", epsilon=1e-8)
    """
    cfg = (config or SolverConfig()).replace(**overrides) if (
        config or overrides
    ) else SolverConfig()
    method = cfg.method.lower()
    if method not in SOLVERS and method not in _DF64_METHODS:
        raise ValueError(
            f"unknown method {cfg.method!r}; options: "
            f"{sorted(set(SOLVERS) | set(_DF64_METHODS))}"
        )
    if method in _DF64_METHODS:
        # emulated f64 (double-word f32, solvers/df64.py): takes the CSR
        # source directly (df_operator_from_host_csr picks DIA/ELL); the
        # fast-format/preconditioner/trace machinery is f32-path only
        from .df64 import bicgstab_df64, cg_df64
        from .ir_df64 import bicgstab_ir_df64, cg_ir_df64

        if cfg.record_residuals:
            raise ValueError(f"{method} does not record residual traces")
        if method in ("cg_ir_df64", "bicgstab_ir_df64"):
            # the refinement's inner f32 solve takes a preconditioner:
            # pass an OBJECT with apply(r) -> z (e.g. JacobiPreconditioner
            # or PoissonMultigrid); string factories need the f32-path
            # matrix plumbing and stay on the direct-call API
            pre = cfg.preconditioner
            if pre in (None, "none"):
                pre = None
            elif isinstance(pre, str):
                raise ValueError(
                    f"{method} via solve() takes a preconditioner "
                    "OBJECT (apply(r) -> z), not a string factory name; "
                    f"call {method}() directly or pass the object"
                )
            ir_fn = (
                cg_ir_df64 if method == "cg_ir_df64" else bicgstab_ir_df64
            )
            return ir_fn(
                a, b, x0,
                max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
                preconditioner=pre,
            )
        if cfg.preconditioner not in (None, "none"):
            raise ValueError(
                f"{method} does not take a preconditioner yet"
            )
        fn = cg_df64 if method == "cg_df64" else bicgstab_df64
        return fn(
            a, b, x0,
            max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
        )
    a_source = a  # preconditioners factor from the CSR source below
    if cfg.auto_format and isinstance(a, CSRMatrix):
        from ..formats import best_format
        from ..formats.dia import try_dia_from_csr
        from ..formats.stencil import GridStencilMatrix

        a = best_format(a)
        if isinstance(a, GridStencilMatrix) and (
            cfg.matrix_dtype is not None
            or str(cfg.preconditioner).lower() in (
                "sgs", "symmetric_gauss_seidel", "symmetric_gaus_seidel",
                "ilu0", "ic0",
            )
        ):
            # these features ride the DIA machinery (bf16 diagonal
            # stream / DIA-built SGS); the matrix-free stencil has no matrix
            # stream to retype and no stored factors — keep the DIA
            # layout for them
            dia = try_dia_from_csr(a_source)
            if dia is not None:
                a = dia
    if getattr(b, "ndim", 1) == 2:
        # multi-RHS panel: route through the blocked solver (one SpMM
        # feeds every column — solvers/block.py).  Returns a
        # MultiSolveResult (per-column statuses), not a SolveResult.
        from .block import cg_multi

        if method not in ("cg", "conjugate_gradient"):
            raise ValueError(
                "multi-RHS b (n, m) is supported for method='cg' "
                "(cg_multi); solve each column separately for other methods"
            )
        precond = None
        if cfg.preconditioner not in (None, "none"):
            # every precond apply is panel-capable (triangular solves
            # run take/segment_sum over axis 0) — one apply serves all
            # m columns, mirroring the SpMM
            precond = _build_preconditioner_for(
                a, a_source, cfg.preconditioner, cfg.preconditioner_options
            )
        return cg_multi(
            a, b, x0,
            max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
            preconditioner=precond,
            record_residuals=cfg.record_residuals,
        )
    if cfg.matrix_dtype is not None:
        # bf16-matrix / f32-vector mixed precision with true-residual IR
        from .mixed import mixed_cg

        if method not in ("cg", "conjugate_gradient"):
            raise ValueError(
                "matrix_dtype (mixed precision) is supported for "
                "method='cg' only"
            )
        if cfg.preconditioner not in (None, "none"):
            raise ValueError(
                "matrix_dtype does not compose with a preconditioner yet"
            )
        if cfg.record_residuals:
            raise ValueError(
                "mixed_cg does not record residual traces (the outer "
                "loop only tracks true-residual checkpoints)"
            )
        return mixed_cg(
            a, b, x0,
            max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
            matrix_dtype=cfg.matrix_dtype,
        )
    kwargs: Dict[str, Any] = dict(
        max_iterations=cfg.max_iterations,
        epsilon=cfg.epsilon,
        record_residuals=cfg.record_residuals,
    )
    if cfg.preconditioner not in (None, "none"):
        if method not in _PRECONDITIONABLE:
            raise ValueError(
                f"{method} does not take a preconditioner "
                "(cg, bicgstab, and gmres do)"
            )
        kwargs["preconditioner"] = _build_preconditioner_for(
            a, a_source, cfg.preconditioner, cfg.preconditioner_options
        )
    # escalation would return a DfSolveResult, which has no residual
    # trace — honor an explicit record_residuals request by staying on
    # the f32 path (the floored SolveResult carries the trace)
    escalatable = cfg.auto_escalate and not cfg.record_residuals
    if escalatable and method in _ESCALATION:
        # pre-route: epsilon below what the working dtype can even
        # represent relative to b (||r|| < eps_mach * ||b|| is not a
        # reachable f32 state) — skip the doomed n-iteration f32 pass
        # entirely instead of waiting for its floor_hit
        bdt = jnp.asarray(b).dtype
        if jnp.issubdtype(bdt, jnp.floating) and jnp.finfo(bdt).eps > 1e-10:
            floor_est = float(jnp.finfo(bdt).eps) * float(
                jnp.linalg.norm(jnp.asarray(b))
            )
            if cfg.epsilon < floor_est:
                esc = _escalated_solve(
                    a_source, b, x0, cfg, method, kwargs, a
                )
                if esc is not None:
                    return esc
    res = SOLVERS[method](a, b, x0, **kwargs)
    if escalatable:
        esc = _maybe_escalate(res, a_source, b, cfg, method, kwargs, a)
        if esc is not None:
            return esc
    return res


# floor_hit-aware methods and their double-word refinement counterparts
_ESCALATION = {
    "cg": "cg",
    "conjugate_gradient": "cg",
    "bicgstab": "bicgstab",
    # GMRES has no floor_hit machinery (its restart loop tracks a Givens
    # residual estimate, not a verified floor), so only the PRE-ROUTE
    # fires: solve(method="gmres", epsilon=1e-8) on f32 data goes
    # straight to the nonsymmetric double-word refinement instead of
    # burning the iteration cap below the f32 floor.
    # The refinement's inner correction solver is BiCGStab — each round
    # only needs a modest RELATIVE reduction, which it delivers with
    # best-iterate guards + outer verification on exactly the systems
    # GMRES would be chosen for.
    "gmres": "bicgstab",
}


def _escalated_solve(a_source, b, x0, cfg, method, kwargs, a_solve=None):
    """Run the double-word refinement directly (pre-routed or after a
    floored f32 pass).  Returns None when the operator has no df twin —
    the caller then keeps/returns the plain f32 behavior."""
    dfa = _df_operator_for(a_source)
    if dfa is None:
        return None
    from .ir_df64 import bicgstab_ir_df64, cg_ir_df64

    ir_fn = (
        cg_ir_df64 if _ESCALATION[method] == "cg" else bicgstab_ir_df64
    )
    pre = kwargs.get("preconditioner")
    if pre is not None and not hasattr(pre, "apply"):
        pre = None
    from ..formats.reorder import ReorderedMatrix

    if pre is not None and isinstance(a_solve, ReorderedMatrix):
        # auto_format factored the preconditioner in the PERMUTED
        # domain; the df refinement runs on the original-order operator,
        # so that apply would mix orderings — escalate unpreconditioned
        pre = None
    return ir_fn(
        dfa, b, x0=x0,
        max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
        preconditioner=pre,
    )


def _maybe_escalate(res, a_source, b, cfg, method, kwargs, a_solve=None):
    """Escalate a precision-floored f32 solve to the double-word
    refinement path: the solver itself measured that
    more iterations cannot help (``floor_hit``), and the floor sits
    above the requested ``epsilon`` — the request is only satisfiable
    with more precision, which ``*_ir_df64`` delivers at ~f32 cost
    (solvers/ir_df64.py).  Returns None when escalation doesn't apply.
    """
    from .types import SolveResult

    if method not in _ESCALATION or not isinstance(res, SolveResult):
        return None
    if res.floor_hit is None or not bool(res.floor_hit):
        return None
    if not float(res.residual_norm) > float(cfg.epsilon):
        return None
    # warm start from the floored iterate
    return _escalated_solve(
        a_source, b, res.x, cfg, method, kwargs, a_solve
    )


def _df_operator_for(a):
    """Double-word operator from the solve's source matrix, or None when
    the format has no df twin.  f32 device values mean zero lo planes —
    the refinement then solves the f32-rounded operator to ``epsilon``,
    which is exactly what the caller handed us."""
    from ..formats.dia import DIAMatrix
    from ..formats.stencil import GridStencilMatrix
    from ..ops.df32 import DfDiaMatrix, DfEllMatrix, DfGridStencil

    if isinstance(a, (CSRMatrix, GridStencilMatrix)):
        from .df64 import _as_df_operator

        return _as_df_operator(a)
    if isinstance(a, DIAMatrix):
        return DfDiaMatrix(
            diags_hi=a.diags,
            diags_lo=jnp.zeros_like(a.diags),
            offsets=a.offsets,
            shape=a.shape,
            nnz=a.nnz,
        )
    if isinstance(a, (DfDiaMatrix, DfEllMatrix, DfGridStencil)):
        return a
    return None
