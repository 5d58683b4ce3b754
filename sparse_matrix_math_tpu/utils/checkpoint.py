"""Checkpoint / resume for long-running solves.

The reference's only "resume" capability is the initial-guess argument
``x0`` (Krylov restart — reference README.md:5, solver signature
include/sparse_matrix_math.h:2319-2320) and matrix persistence via
``saveDenseText`` (h:1930-1993).  Here checkpointing is first-class
(SURVEY §5): solver state (x, iteration count, residual) is an explicit
carry, so it can be snapshotted to disk at a fixed iteration cadence and
resumed after preemption — the standard shared-cluster failure model.

CSR matrices snapshot to .npz (:func:`save_csr_npz` /
:func:`load_csr_npz`) — a fast binary complement to the reference's
dense-text format (io/smmdt.py keeps the parity path).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

from ..formats.csr import CSRMatrix, _csr_from_sorted_host
from ..solvers.types import SolveResult, SolverStatus

__all__ = [
    "SolverCheckpoint",
    "save_checkpoint",
    "load_checkpoint",
    "checkpointed_solve",
    "save_csr_npz",
    "load_csr_npz",
]


@dataclasses.dataclass(frozen=True)
class SolverCheckpoint:
    """Resumable solver state."""

    x: np.ndarray
    iterations_done: int
    residual_norm: float


def save_checkpoint(path: str, ckpt: SolverCheckpoint) -> None:
    """Atomic snapshot (write-temp + rename, preemption-safe).

    The temp name is pid-unique so two processes checkpointing the same
    path cannot interleave savez/os.replace and corrupt each other's
    snapshot (same policy as native/__init__.py's build lock).
    """
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(
        tmp,
        x=np.asarray(ckpt.x),
        iterations_done=np.int64(ckpt.iterations_done),
        residual_norm=np.float64(ckpt.residual_norm),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[SolverCheckpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return SolverCheckpoint(
            x=z["x"],
            iterations_done=int(z["iterations_done"]),
            residual_norm=float(z["residual_norm"]),
        )


def checkpointed_solve(
    solver: Callable,
    a,
    b,
    *,
    checkpoint_path: str,
    chunk_iterations: int = 100,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    **solver_kwargs,
) -> SolveResult:
    """Run ``solver`` in restart chunks, checkpointing between chunks.

    Each chunk is a fresh Krylov solve warm-started from the checkpointed
    ``x`` (restarted-Krylov semantics — the subspace resets at chunk
    boundaries, so convergence can take somewhat more total iterations
    than a single uninterrupted run).  If ``checkpoint_path`` exists the
    solve resumes from it.
    """
    import jax.numpy as jnp

    n = b.shape[0]
    total_cap = int(n) if max_iterations in (-1, None) else int(max_iterations)

    ckpt = load_checkpoint(checkpoint_path)
    if ckpt is not None:
        x = jnp.asarray(ckpt.x)
        done = ckpt.iterations_done
        if ckpt.residual_norm <= epsilon:
            # The checkpointed run already converged — report it as such
            # rather than rerunning a 0-iteration solve (which would
            # mislabel the outcome MAX_ITERATIONS_REACHED).
            return SolveResult(
                x=x,
                status=jnp.int32(SolverStatus.SUCCESS),
                iterations=jnp.int32(done),
                residual_norm=jnp.asarray(ckpt.residual_norm, x.dtype),
                residual_trace=None,
            )
    else:
        x = None
        done = 0

    res = None
    while done < total_cap:
        chunk = min(chunk_iterations, total_cap - done)
        res = solver(
            a, b, x0=x, max_iterations=chunk, epsilon=epsilon, **solver_kwargs
        )
        done += int(res.iterations)
        x = res.x
        save_checkpoint(
            checkpoint_path,
            SolverCheckpoint(
                x=np.asarray(x),
                iterations_done=done,
                residual_norm=float(res.residual_norm),
            ),
        )
        if int(res.status) != SolverStatus.MAX_ITERATIONS_REACHED:
            break
    if res is None:  # checkpoint already past the cap
        res = solver(a, b, x0=x, max_iterations=0, epsilon=epsilon, **solver_kwargs)
    return dataclasses.replace(res, iterations=jnp.int32(done))


def save_csr_npz(path: str, a: CSRMatrix) -> None:
    """Binary CSR snapshot (complement of the reference's dense-text
    persistence, h:1930-1993)."""
    np.savez_compressed(
        path,
        data=np.asarray(a.data),
        indices=np.asarray(a.indices),
        indptr=np.asarray(a.indptr),
        shape=np.asarray(a.shape, dtype=np.int64),
    )


def load_csr_npz(path: str) -> CSRMatrix:
    with np.load(path) as z:
        indptr = z["indptr"].astype(np.int64)
        rows = np.repeat(
            np.arange(indptr.shape[0] - 1, dtype=np.int64), np.diff(indptr)
        )
        return _csr_from_sorted_host(
            rows, z["indices"].astype(np.int64), z["data"], tuple(z["shape"])
        )
