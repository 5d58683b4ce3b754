#!/usr/bin/env python3
"""End-to-end check of the solver library on one NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py              # phases A-G on one card
    python chip_smoke.py --four-gpus  # distributed stencil CG on four cards

The script drives the package through ``import sparse_matrix_math_tpu``
and ``smm.solve`` at sizes whose vectors are larger than the card's L2
cache, and checks every result against a float64 reference written here
(a NumPy stencil apply or a ``scipy.sparse`` CSR product), independent
of the package's own code.  Phases:

    A  7-point 3-D Poisson CG, matrix-free stencil, f32
    B  the same system, multigrid-preconditioned CG
    C  the float64 accuracy contract (epsilon 1e-8 on f32 data), with
       jax_enable_x64 off (JAX's default: pure-f32 error-free transforms)
       and on (the transforms run through native float64)
    D  nonsymmetric convection-diffusion, BiCGStab + SGS on DIA input
    E  general pattern (jittered 3-D Laplacian) CG on CSR, ELL SpMV
    F  kernel comparisons and timings at full width
    G  the card test suite, ``pytest -m gpu tests/gpu``

Each phase prints one JSON line; every line that carries a number also
carries the card's name and power limit.  A failed phase makes the
script exit non-zero.  The last line, printed only when every phase
passed, is ``{"ok": true, "device": {...}}``.  Without an NVIDIA GPU the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# sizes at which one f32 vector (>= 67 MB) is larger than the 50 MB L2
STENCIL_SIDE = 256        # phases A-C: 256^3 = 16.8M rows
CONV_DIFF_SIDE = 4096     # phase D: 4096^2 = 16.8M rows
JITTER_SIDE = 204         # phase E: 204^3 = 8.5M rows
FOUR_GPU_SIDE = 384       # --four-gpus: 384^3 = 56.6M rows, 14M per card
HBM_PEAK_BYTES_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def card_line():
    """``name, power.limit`` of the first GPU as nvidia-smi reports it,
    or None when there is no NVIDIA GPU."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        return None
    return lines[0]


def run_card_tests() -> int:
    """Phase G in a child process, started before this process touches
    JAX, so that two processes never hold the card at once."""
    env = dict(os.environ, SMM_GPU_TESTS="1")
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=HERE, env=env, timeout=900,
    ).returncode


# -- float64 references, independent of the package ---------------------------


def poisson3d_apply(x: np.ndarray, m: int) -> np.ndarray:
    """y = A x for the 7-point Laplacian on an m^3 grid (Dirichlet),
    as shifted slices of the grid."""
    g = np.asarray(x, np.float64).reshape(m, m, m)
    y = 6.0 * g
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax], hi[ax] = slice(1, None), slice(None, -1)
        y[tuple(lo)] -= g[tuple(hi)]
        y[tuple(hi)] -= g[tuple(lo)]
    return y.reshape(-1)


def conv_diff_diagonals(nx: int, cx: float = 0.5, cy: float = 0.25):
    """Offsets and DIA planes (``plane[i] = A[i, i + off]``, zero where
    the column leaves the grid) of the upwind convection-diffusion
    stencil on an nx^2 grid: diag 4+cx+cy, west -1-cx, east -1,
    north -1-cy, south -1."""
    n = nx * nx
    ix = np.arange(n) % nx
    i = np.arange(n)
    offsets = (-nx, -1, 0, 1, nx)
    planes = np.stack([
        np.where(i >= nx, -1.0 - cy, 0.0),
        np.where(ix > 0, -1.0 - cx, 0.0),
        np.full(n, 4.0 + cx + cy),
        np.where(ix < nx - 1, -1.0, 0.0),
        np.where(i < n - nx, -1.0, 0.0),
    ])
    return offsets, planes


def scipy_from_diagonals(offsets, planes):
    """float64 scipy CSR matrix from DIA planes in the row convention."""
    import scipy.sparse as sp

    n = planes.shape[1]
    # scipy's dia_matrix stores data[d, j] = A[j - off, j] (by column)
    data = np.stack([np.roll(p, off) for p, off in zip(planes, offsets)])
    return sp.dia_matrix((data, np.asarray(offsets)), shape=(n, n)).tocsr()


def rel_residual(apply_ref, b64, x) -> tuple:
    """(||b - A x|| / ||b||, ||b - A x||) in float64 on the host."""
    r = b64 - apply_ref(np.asarray(x, np.float64))
    rn = float(np.linalg.norm(r))
    return rn / float(np.linalg.norm(b64)), rn


def unit_rhs(n: int, seed: int) -> np.ndarray:
    """Seeded random right-hand side of unit norm (float64)."""
    b = np.random.default_rng(seed).standard_normal(n)
    return b / np.linalg.norm(b)


# -- harness --------------------------------------------------------------------


class Report:
    """Prints one JSON line per phase and remembers failures."""

    def __init__(self, card: str):
        self.card = card
        self.failed = []

    def line(self, phase: str, ok: bool, **fields):
        rec = {"phase": phase, "card": self.card, "pass": bool(ok)}
        rec.update(fields)
        print(json.dumps(rec), flush=True)
        if not ok:
            self.failed.append(phase)


def timed(fn):
    """(result, cold seconds, warm seconds): the first call includes
    compilation; both end in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, cold, time.perf_counter() - t0


def kernel_time(fn, *args, reps: int = 20) -> float:
    """Mean warm seconds per call of a jitted ``fn(*args)``."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def stencil_7pt(m: int, dtype=np.float32):
    import jax.numpy as jnp

    import sparse_matrix_math_tpu as smm

    doffs = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
             (0, 1, 0), (1, 0, 0))
    coeffs = np.array([-1, -1, -1, 6, -1, -1, -1], dtype)
    n = m ** 3
    return smm.GridStencilMatrix(
        coeffs=jnp.asarray(coeffs), doffs=doffs, dims=(m, m, m),
        shape=(n, n), nnz=7 * n - 6 * m * m,
    )


def solve_record(res) -> dict:
    from sparse_matrix_math_tpu.solvers.types import SolverStatus

    return {
        "status": SolverStatus(int(res.status)).name,
        "iterations": int(res.iterations),
    }


# -- phases -----------------------------------------------------------------


def phase_a(rep: Report, m: int = STENCIL_SIDE, eps: float = 1e-5):
    import jax.numpy as jnp

    import sparse_matrix_math_tpu as smm

    st = stencil_7pt(m)
    b64 = unit_rhs(m ** 3, seed=1)
    b = jnp.asarray(b64, jnp.float32)
    res, cold, warm = timed(
        lambda: smm.solve(st, b, method="cg", epsilon=eps, max_iterations=20000)
    )
    rel, absn = rel_residual(lambda x: poisson3d_apply(x, m), b64, res.x)
    rec = solve_record(res)
    ok = rec["status"] == "SUCCESS" and absn <= 10 * eps
    rep.line("A", ok, system=f"7-point Poisson {m}^3 stencil f32",
             call='solve(st, b, method="cg", epsilon=%g)' % eps,
             check="status SUCCESS and ||b-Ax|| <= 10*epsilon (||b|| = 1)",
             cold_s=cold, warm_s=warm, residual_rel=rel, residual_abs=absn,
             **rec)
    return st, b64


def phase_b(rep: Report, st, b64, eps: float = 1e-5, max_its: int = 50):
    import jax.numpy as jnp

    import sparse_matrix_math_tpu as smm

    m = st.dims[0]
    b = jnp.asarray(b64, jnp.float32)
    res, cold, warm = timed(
        lambda: smm.solve(st, b, method="cg", epsilon=eps,
                          preconditioner="multigrid")
    )
    rel, absn = rel_residual(lambda x: poisson3d_apply(x, m), b64, res.x)
    rec = solve_record(res)
    ok = (rec["status"] == "SUCCESS" and absn <= 10 * eps
          and rec["iterations"] <= max_its)
    rep.line("B", ok, system=f"7-point Poisson {m}^3 stencil f32",
             call='solve(st, b, method="cg", epsilon=%g, '
                  'preconditioner="multigrid")' % eps,
             check=f"status SUCCESS, ||b-Ax|| <= 10*epsilon, "
                   f"iterations <= {max_its}",
             cold_s=cold, warm_s=warm, residual_rel=rel, residual_abs=absn,
             **rec)


def phase_c(rep: Report, st, x64: bool, eps: float = 1e-8):
    """The 1e-8 contract with ``jax_enable_x64`` set to ``x64`` for the
    solve: off selects the pure-f32 error-free transforms, on routes
    them through native float64 (ops/df32.py)."""
    import jax
    import jax.numpy as jnp

    import sparse_matrix_math_tpu as smm

    m = st.dims[0]
    b32 = jnp.asarray(unit_rhs(m ** 3, seed=7), jnp.float32)
    b64 = np.asarray(b32, np.float64)  # the system handed to the solver
    with jax.enable_x64(x64):
        res, cold, warm = timed(
            lambda: smm.solve(st, b32, epsilon=eps, preconditioner="multigrid")
        )
    rel, absn = rel_residual(lambda v: poisson3d_apply(v, m), b64, res.x_f64())
    rec = solve_record(res)
    ok = rec["status"] == "SUCCESS" and absn <= eps
    rep.line("C", ok, system=f"7-point Poisson {m}^3 stencil, f32 b, ||b|| = 1",
             call='solve(st, b32, epsilon=%g, preconditioner="multigrid")'
                  % eps,
             jax_enable_x64=x64, result_type=type(res).__name__,
             check="status SUCCESS and host float64 ||b-Ax|| <= epsilon",
             cold_s=cold, warm_s=warm, residual_rel=rel, residual_abs=absn,
             **rec)


def phase_d(rep: Report, nx: int = CONV_DIFF_SIDE, eps: float = 1e-5):
    import jax.numpy as jnp

    import sparse_matrix_math_tpu as smm

    offsets, planes = conv_diff_diagonals(nx)
    n = nx * nx
    dia = smm.DIAMatrix(
        diags=jnp.asarray(planes, jnp.float32), offsets=offsets,
        shape=(n, n), nnz=int(np.count_nonzero(planes)),
    )
    a_ref = scipy_from_diagonals(offsets, planes)
    b64 = unit_rhs(n, seed=3)
    b = jnp.asarray(b64, jnp.float32)
    res, cold, warm = timed(
        lambda: smm.solve(dia, b, method="bicgstab", preconditioner="sgs",
                          epsilon=eps, max_iterations=20000)
    )
    rel, absn = rel_residual(lambda v: a_ref @ v, b64, res.x)
    rec = solve_record(res)
    ok = rec["status"] == "SUCCESS" and absn <= 10 * eps
    rep.line("D", ok, system=f"convection-diffusion {nx}^2 DIA f32",
             call='solve(dia, b, method="bicgstab", preconditioner="sgs", '
                  'epsilon=%g)' % eps,
             check="status SUCCESS (on ||M^-1 (b-Ax)||, the reference's "
                   "measure) and ||b-Ax|| <= 10*epsilon (||b|| = 1)",
             cold_s=cold, warm_s=warm, residual_rel=rel, residual_abs=absn,
             **rec)
    return dia, a_ref


def phase_e(rep: Report, m: int = JITTER_SIDE, eps: float = 1e-5):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import sparse_matrix_math_tpu as smm
    from sparse_matrix_math_tpu.utils.generate import laplace_3d_jittered

    csr = laplace_3d_jittered(m, symmetric=True, shift=1.0, dtype=np.float32)
    n = csr.shape[0]
    a_ref = sp.csr_matrix(
        (np.asarray(csr.data, np.float64), np.asarray(csr.indices),
         np.asarray(csr.indptr)), shape=csr.shape,
    )
    b64 = unit_rhs(n, seed=2)
    b = jnp.asarray(b64, jnp.float32)
    res, cold, warm = timed(
        lambda: smm.solve(csr, b, method="cg", epsilon=eps,
                          max_iterations=5000)
    )
    rel, absn = rel_residual(lambda v: a_ref @ v, b64, res.x)
    rec = solve_record(res)
    ok = rec["status"] == "SUCCESS" and absn <= 10 * eps
    rep.line("E", ok,
             system=f"jittered 3-D Laplacian {m}^3 CSR f32 "
                    f"({csr.nnz} nnz), symmetric, diagonal shift 1",
             call='solve(csr, b, method="cg", epsilon=%g)' % eps,
             check="status SUCCESS and ||b-Ax|| <= 10*epsilon (||b|| = 1)",
             cold_s=cold, warm_s=warm, residual_rel=rel, residual_abs=absn,
             **rec)

    ell = smm.ell_from_csr(csr)
    x64 = np.random.default_rng(3).standard_normal(n)
    x = jnp.asarray(x64, jnp.float32)
    y = np.asarray(jax.jit(smm.rmult)(ell, x), np.float64)
    ok, err = close(y, a_ref @ np.asarray(x, np.float64), 1e-5)
    rep.line("E", ok, check="ELL SpMV vs scipy float64 CSR, f32, "
                            "rtol=1e-5 (atol 1e-5*max|y|)",
             max_rel_err=err)
    return csr, ell, a_ref


def close(y, y_ref, rtol: float) -> tuple:
    """(allclose at ``rtol`` with atol = rtol * max|y_ref|, max error
    relative to max|y_ref|)."""
    scale = float(np.max(np.abs(y_ref)))
    err = float(np.max(np.abs(y - y_ref))) / scale
    return bool(np.allclose(y, y_ref, rtol=rtol, atol=rtol * scale)), err


def _gbs(nbytes: float, seconds: float) -> dict:
    return {"seconds": seconds, "bytes": int(nbytes),
            "gb_per_s": nbytes / seconds / 1e9,
            "hbm_peak_share": nbytes / seconds / HBM_PEAK_BYTES_S}


def phase_f(rep: Report, dia, a_ref, csr=None, ell=None, csr_ref=None,
            sgs_sweeps: int = 4, restart: int = 32):
    """Kernel checks at full width, each with its precision and
    tolerance, plus the time and bandwidth of the XLA kernels the solver
    paths run (bytes: the minimum traffic the format implies)."""
    import jax
    import jax.numpy as jnp

    import sparse_matrix_math_tpu as smm
    from sparse_matrix_math_tpu.ops.spmv import dia_rmult_xla
    from sparse_matrix_math_tpu.solvers.gmres import arnoldi_basis

    n = dia.shape[0]
    nd = len(dia.offsets)
    x64 = np.random.default_rng(4).standard_normal(n)
    x = jnp.asarray(x64, jnp.float32)
    xr = np.asarray(x, np.float64)

    spmv = jax.jit(dia_rmult_xla)
    ok, err = close(np.asarray(spmv(dia, x), np.float64), a_ref @ xr, 1e-5)
    t = kernel_time(spmv, dia, x)
    rep.line("F", ok, kernel="DIA SpMV dia_rmult_xla", rows=n, diagonals=nd,
             check="vs scipy float64 CSR, f32, rtol=1e-5 (atol 1e-5*max|y|)",
             max_rel_err=err, **_gbs((nd + 2) * n * 4, t))
    t_spmv = t

    sgs = smm.SGSPreconditioner.from_dia(dia, sweeps=sgs_sweeps)
    coo = a_ref.tocoo()
    csr32 = smm.csr_from_coo(smm.COOArrays(
        rows=coo.row.astype(np.int64), cols=coo.col.astype(np.int64),
        vals=coo.data.astype(np.float32), shape=coo.shape,
    ))
    sgs_ref = smm.SGSPreconditioner.from_matrix(
        csr32, method="jacobi", sweeps=sgs_sweeps
    )
    apply = jax.jit(lambda p, r: p.apply(r))
    ok, err = close(np.asarray(apply(sgs, x), np.float64),
                    np.asarray(apply(sgs_ref, x), np.float64), 1e-5)
    t = kernel_time(apply, sgs, x)
    t_csr = kernel_time(apply, sgs_ref, x)
    # per triangle: scale (2 reads, 1 write), then (sweeps-1) sweeps of
    # (2 strict diagonals + x + rhs + 1/d reads, 1 write); plus d*y
    tri = 3 + (sgs_sweeps - 1) * (2 + 4)
    rep.line("F", ok, kernel="DIA SGS apply (SGSPreconditioner.from_dia)",
             sweeps=sgs_sweeps,
             check="vs CSR SGSPreconditioner(method='jacobi') apply, f32, "
                   "rtol=1e-5 (atol 1e-5*max|z|)",
             max_rel_err=err, csr_sgs_apply_seconds=t_csr,
             apply_over_spmv=t / t_spmv, **_gbs((2 * tri + 3) * n * 4, t))

    dia16 = dia.astype(jnp.bfloat16)
    # the reference multiplies the bf16-rounded diagonals in float64
    planes16 = np.asarray(dia16.diags).astype(np.float64)
    ok, err = close(np.asarray(spmv(dia16, x), np.float64),
                    scipy_from_diagonals(dia.offsets, planes16) @ xr, 1e-5)
    t = kernel_time(spmv, dia16, x)
    rep.line("F", ok, kernel="DIA SpMV, bf16 diagonals (mixed_cg stream)",
             check="vs scipy float64 on the bf16-rounded diagonals, f32 "
                   "accumulation, rtol=1e-5 (atol 1e-5*max|y|)",
             max_rel_err=err, **_gbs(nd * n * 2 + 2 * n * 4, t))

    df_spmv_check(rep, dia)

    bunit = jnp.asarray(a_ref @ np.ones(n), jnp.float32)
    V = arnoldi_basis(dia, bunit, restart)
    V64 = np.asarray(V, np.float64)
    gram = V64 @ V64.T - np.eye(restart + 1)
    ortho = float(np.linalg.norm(gram, 2))
    rep.line("F", ortho <= 1e-5,
             kernel=f"GMRES({restart}) Arnoldi basis, precision HIGHEST",
             check="||Q^T Q - I||_2 <= 1e-5, f32 basis, float64 Gram on host",
             orthogonality=ortho,
             orthogonality_frobenius=float(np.linalg.norm(gram)))

    if csr is not None:
        m = csr.shape[0]
        xc = jnp.asarray(np.random.default_rng(5).standard_normal(m),
                         jnp.float32)
        yc_ref = csr_ref @ np.asarray(xc, np.float64)
        mv = jax.jit(smm.rmult)
        ok, err = close(np.asarray(mv(csr, xc), np.float64), yc_ref, 1e-5)
        t = kernel_time(mv, csr, xc)
        rep.line("F", ok, kernel="CSR SpMV (gather + segment_sum)",
                 rows=m, nnz=int(csr.nnz),
                 check="vs scipy float64 CSR, f32, rtol=1e-5 "
                       "(atol 1e-5*max|y|)",
                 max_rel_err=err, **_gbs(csr.nnz * 12 + 2 * m * 4, t))
        ok, err = close(np.asarray(mv(ell, xc), np.float64), yc_ref, 1e-5)
        t = kernel_time(mv, ell, xc)
        rep.line("F", ok, kernel="ELL SpMV (gather)", rows=m,
                 slots=int(ell.slots),
                 check="vs scipy float64 CSR, f32, rtol=1e-5 "
                       "(atol 1e-5*max|y|)",
                 max_rel_err=err,
                 **_gbs(ell.rows_padded * ell.slots * 8 + 2 * m * 4, t))


def df_spmv_check(rep: Report, dia, rtol: float = 1e-12):
    """The double-word DIA SpMV on float64 diagonals and a float64 x,
    both carried as (hi, lo) f32 pairs with non-zero lo words, against
    the scipy float64 product, with ``jax_enable_x64`` off and on.  An
    f32-only result (lo words lost) is off by ~1e-7; the double-word
    result by ~1e-15."""
    import jax
    import jax.numpy as jnp

    from sparse_matrix_math_tpu.ops.df32 import (
        DfDiaMatrix, df_from_host, df_to_host,
    )

    n = dia.shape[0]
    nd = len(dia.offsets)
    rng = np.random.default_rng(8)
    planes = np.asarray(dia.diags, np.float64)
    planes = planes * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, planes.shape))
    hi, lo = df_from_host(planes)
    dfa = DfDiaMatrix(diags_hi=hi, diags_lo=lo, offsets=dia.offsets,
                      shape=dia.shape, nnz=dia.nnz)
    xv = rng.standard_normal(n)
    xdf = df_from_host(xv)
    y_ref = scipy_from_diagonals(dia.offsets, planes) @ xv
    lo_nonzero = int(np.count_nonzero(np.asarray(lo)))
    for x64 in (False, True):
        with jax.enable_x64(x64):
            df_mv = jax.jit(lambda a, v: a.rmult_df(v))
            y = df_to_host(df_mv(dfa, xdf))
            t = kernel_time(df_mv, dfa, xdf)
        ok, err = close(y, y_ref, rtol)
        rep.line("F", ok, kernel="double-word DIA SpMV (DfDiaMatrix)",
                 jax_enable_x64=x64,
                 check="vs scipy float64 on float64 diagonals (non-zero "
                       f"lo words), rtol={rtol:g} (atol {rtol:g}*max|y|)",
                 max_rel_err=err, lo_words_nonzero=lo_nonzero,
                 **_gbs(2 * nd * n * 4 + 4 * n * 4, t))


def four_gpus(rep: Report, m: int = FOUR_GPU_SIDE, eps: float = 1e-5):
    """The distributed stencil CG on a 4-card mesh against the same
    system on one card and the host float64 residual."""
    import jax
    import jax.numpy as jnp

    import sparse_matrix_math_tpu as smm
    from sparse_matrix_math_tpu.parallel import (
        collect, dist_solve, distribute_stencil, make_mesh,
    )

    st = stencil_7pt(m)
    n = m ** 3
    b64 = unit_rhs(n, seed=6)
    b = jnp.asarray(b64, jnp.float32)
    one, cold1, warm1 = timed(
        lambda: smm.solve(st, b, method="cg", epsilon=eps, max_iterations=20000)
    )
    one_rec = solve_record(one)
    rel1, abs1 = rel_residual(lambda v: poisson3d_apply(v, m), b64, one.x)
    del one

    mesh = make_mesh(4)
    dst = distribute_stencil(st, mesh)
    res, cold, warm = timed(
        lambda: dist_solve(dst, b64.astype(np.float32), epsilon=eps,
                           max_iterations=20000)
    )
    rec = solve_record(res)
    shards = res.x.addressable_shards
    quarter = dst.padded_rows // 4
    per_card = sorted((str(s.device), int(s.data.shape[0])) for s in shards)
    sharded = (len({d for d, _ in per_card}) == 4
               and all(k == quarter for _, k in per_card))
    x = collect(res.x, dst)
    rel, absn = rel_residual(lambda v: poisson3d_apply(v, m), b64, x)
    ok = (rec["status"] == "SUCCESS" and one_rec["status"] == "SUCCESS"
          and abs(rec["iterations"] - one_rec["iterations"]) <= 1
          and sharded and absn <= 10 * eps)
    rep.line("4GPU", ok, system=f"7-point Poisson {m}^3 stencil f32, "
                                f"{n // 4} rows per card",
             call="dist_solve(distribute_stencil(st, make_mesh(4)), b)",
             check="SUCCESS, iterations within 1 of one card, a quarter "
                   "of x on each card, ||b-Ax|| <= 10*epsilon",
             sharding=str(res.x.sharding), shards=per_card,
             one_card={"cold_s": cold1, "warm_s": warm1,
                       "residual_abs": abs1, "residual_rel": rel1,
                       **one_rec},
             cold_s=cold, warm_s=warm, residual_rel=rel,
             residual_abs=absn, devices=len(jax.devices()), **rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the distributed stencil CG on 4 cards")
    args = ap.parse_args(argv)

    card = card_line()
    if card is None:
        print("chip_smoke: no NVIDIA GPU found (nvidia-smi)", file=sys.stderr)
        return 2
    print(card, flush=True)
    rep = Report(card)
    if not args.four_gpus:
        rc = run_card_tests()
        rep.line("G", rc == 0, check="pytest -m gpu tests/gpu exit code 0",
                 exit_code=rc)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              "not 'gpu'", file=sys.stderr)
        return 2
    from sparse_matrix_math_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    if args.four_gpus:
        if len(jax.devices()) < 4:
            print("chip_smoke: --four-gpus needs 4 GPUs", file=sys.stderr)
            return 2
        four_gpus(rep)
    else:
        st, b64 = phase_a(rep)
        phase_b(rep, st, b64)
        for x64 in (False, True):
            phase_c(rep, st, x64=x64)
        del st, b64
        dia, a_ref = phase_d(rep)
        csr, ell, csr_ref = phase_e(rep)
        phase_f(rep, dia, a_ref, csr, ell, csr_ref)
    if rep.failed:
        print(f"chip_smoke: failed phases {rep.failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
