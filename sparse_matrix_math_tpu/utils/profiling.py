"""Observability: timers, SpMV throughput, solver statistics, profiler hooks.

The reference has no tracing, metrics, or instrumentation of any kind
(SURVEY §5): solvers return a bare 3-value status enum
(reference include/sparse_matrix_math.h:2010-2014).  This module provides
an observability layer on top of the richer SolveResult:

* :func:`benchmark_op` — wall-clock a jitted op with device sync,
  reporting ms/op and derived throughput.
* :func:`spmv_throughput` — nnz/s for any matrix format's rmult.
* :func:`solve_with_stats` — run a solver and return a
  :class:`SolveStats` (time-to-solution, iterations, nnz/s, residual
  trace) for dashboards/benchmarks.
* :func:`trace` — context manager around ``jax.profiler`` emitting an
  XPlane trace directory for xprof/tensorboard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax
import numpy as np

__all__ = ["benchmark_op", "spmv_throughput", "SolveStats", "solve_with_stats", "trace"]


def _sync(out):
    """Wait until the device has finished computing ``out``."""
    jax.block_until_ready(out)
    return out


def benchmark_op(
    fn: Callable,
    *args,
    iters: int = 20,
    warmup: int = 2,
) -> float:
    """Median-free simple timing: seconds per op of ``fn(*args)`` with
    device synchronisation before/after the timed loop."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def spmv_throughput(a, x=None, *, iters: int = 20) -> dict:
    """SpMV throughput for any registered format: GNNZ/s and GFLOP/s
    (2 flops per stored entry — the reference's FMA count, h:1478-1491)."""
    import jax.numpy as jnp

    from ..ops.spmv import rmult

    if x is None:
        x = jnp.ones((a.shape[1],), a.dtype)
    # The matrix is a jit ARGUMENT, not a closure constant: the remote
    # compile path rejects large embedded constants (HTTP 413), and
    # bench.py relies on the same convention.
    f = jax.jit(rmult)
    sec = benchmark_op(f, a, x, iters=iters)
    return {
        "seconds_per_op": sec,
        "gnnz_per_s": a.nnz / sec / 1e9,
        "gflop_per_s": 2 * a.nnz / sec / 1e9,
    }


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Timing + convergence statistics for one solve."""

    status: int
    iterations: int
    residual_norm: float
    wall_seconds: float
    seconds_per_iteration: float
    spmv_gnnz_per_s: Optional[float]  # nnz/s through the solver's SpMVs
    residual_trace: Optional[np.ndarray]

    def __repr__(self) -> str:
        return (
            f"SolveStats(status={self.status}, iters={self.iterations}, "
            f"residual={self.residual_norm:.3e}, wall={self.wall_seconds:.4f}s, "
            f"s/iter={self.seconds_per_iteration:.6f})"
        )


# SpMVs per iteration for each solver family (CG/BiCGSym: 1; CGS/BiCGStab: 2
# — SURVEY §3.2/§3.3 call stacks).  Keys cover both the short aliases and
# the actual function __name__s so auto-detection works without an explicit
# solver_name argument.
_SPMVS_PER_ITER = {
    "cg": 1,
    "conjugate_gradient": 1,
    "bicg_symmetric": 1,
    "cgs": 2,
    "conjugate_gradient_squared": 2,
    "bicgstab": 2,
}


def solve_with_stats(
    solver: Callable,
    a,
    b,
    *args,
    solver_name: Optional[str] = None,
    warm: bool = True,
    **kwargs,
) -> SolveStats:
    """Run ``solver(a, b, *args, **kwargs)`` and collect SolveStats.

    With ``warm=True`` the solve runs twice and the second (compile-free)
    run is timed — steady-state numbers, the ones that matter for a
    resident solver loop.
    """
    if warm:
        _sync(solver(a, b, *args, **kwargs).x)
    t0 = time.perf_counter()
    res = solver(a, b, *args, **kwargs)
    _sync(res.x)
    wall = time.perf_counter() - t0

    iters = max(int(res.iterations), 1)
    name = solver_name or getattr(solver, "__name__", "")
    spmv_rate = None
    nnz = getattr(a, "nnz", None)
    if nnz is not None and name in _SPMVS_PER_ITER:
        spmv_rate = _SPMVS_PER_ITER[name] * iters * nnz / wall / 1e9
    trace_arr = (
        np.asarray(res.residual_trace) if res.residual_trace is not None else None
    )
    return SolveStats(
        status=int(res.status),
        iterations=int(res.iterations),
        residual_norm=float(res.residual_norm),
        wall_seconds=wall,
        seconds_per_iteration=wall / iters,
        spmv_gnnz_per_s=spmv_rate,
        residual_trace=trace_arr,
    )


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context — view with xprof/tensorboard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
