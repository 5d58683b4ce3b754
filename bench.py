"""Benchmark harness — prints ONE COMPACT JSON line and writes the full
payload to ``bench_detail.json`` alongside.

Headline metric: in-solver SpMV throughput (GNNZ/s) on the ~10M-nnz 2-D
Poisson 5-point system (BASELINE.json config 4) on the available
accelerator.  ``vs_baseline`` is the ratio to the measured reference
baseline (BASELINE.md: single-core C++ rMult, dtype-matched).

Timing: every measured call ends in ``jax.block_until_ready``; SpMV
rates come from a jitted loop of back-to-back SpMVs, solve times are the
median wall of three warm runs.  ``time_to_tol_s`` is reported ONLY for
solves that reached the tolerance (status SUCCESS).

Run from the repository root: ``python bench.py``.
"""

from __future__ import annotations

import json
import time

import numpy as np

# Reference rMult on the same 10M-nnz Poisson system, 1 core Xeon 2.1 GHz,
# g++ -O3 -DNDEBUG (BASELINE.md), measured for BOTH dtypes so the f32
# headline compares dtype-for-dtype:
BASELINE_SPMV_GNNZ_F64 = 0.455
BASELINE_SPMV_GNNZ_F32 = 0.536
BASELINE_SPMV_GNNZ = BASELINE_SPMV_GNNZ_F32  # headline runs f32
# Reference rMult on the ZERO-locality pattern (diag + 5 uniform-random
# per row, n=2M): x misses cache per nnz on the CPU, collapsing it 3.8x
# below its banded rate.  Same host/harness (BASELINE.md).
BASELINE_RAND_GNNZ_F32 = 0.142


def _finite(x):
    """JSON-safe float (strict JSON has no Infinity/NaN)."""
    x = float(x)
    return x if np.isfinite(x) else None


def _solve_times(res, wall):
    """Timing fields with honest names: ``time_to_tol_s`` ONLY when the
    solve reached the tolerance; otherwise the device time is just that."""
    out = {"wall_s": round(wall, 4)}
    if int(res.status) == 0:
        out["time_to_tol_s"] = out["wall_s"]
    fh = getattr(res, "floor_hit", None)
    if fh is not None:
        out["floor_hit"] = bool(fh)
    return out


def _time_spmv_loop(mat, x, iters: int) -> float:
    """Seconds per SpMV: ``iters`` back-to-back SpMVs inside one jitted
    device loop, best of three warm runs.  ``mat`` is a jit argument, not
    a closure constant, so large matrices are not embedded in the
    compiled program."""
    import jax
    import jax.numpy as jnp

    from sparse_matrix_math_tpu.ops.spmv import rmult

    @jax.jit
    def loop(m, v):
        return jax.lax.fori_loop(
            0, iters, lambda i, y: rmult(m, y) * jnp.asarray(0.25, y.dtype), v
        )

    jax.block_until_ready(loop(mat, x))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(mat, x))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def main() -> None:
    import jax
    import jax.numpy as jnp

    from sparse_matrix_math_tpu import cg
    from sparse_matrix_math_tpu.formats.dia import try_dia_from_csr
    from sparse_matrix_math_tpu.formats.ell import ell_from_csr
    from sparse_matrix_math_tpu.ops.spmv import rmult
    from sparse_matrix_math_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )
    from sparse_matrix_math_tpu.utils.generate import poisson_2d

    enable_compilation_cache()
    dev = jax.devices()[0]
    nx = 1414  # n = 1,999,396 rows, nnz = 9,991,444 (~10M, config 4)
    a = poisson_2d(nx, dtype=np.float32)
    nnz = a.nnz
    x = jnp.ones((a.shape[0],), jnp.float32)

    candidates = {}
    dia = try_dia_from_csr(a)
    if dia is not None:
        candidates["dia"] = (dia, 300)
    # matrix-free grid stencil (formats/stencil.py): ZERO matrix
    # traffic — detection verifies the CSR entry-for-entry, reusing the
    # DIA build above
    from sparse_matrix_math_tpu.formats.stencil import (
        try_grid_stencil_from_csr,
    )

    stencil = try_grid_stencil_from_csr(a, dia=dia)
    if stencil is not None:
        candidates["stencil"] = (stencil, 300)
    candidates["ell"] = (ell_from_csr(a), 8)
    candidates["csr"] = (a, 2)

    results = {
        name: _time_spmv_loop(mat, x, iters)
        for name, (mat, iters) in candidates.items()
    }

    best = min(results, key=results.get)
    standalone_gnnz = nnz / results[best] / 1e9

    # Time-to-tolerance solves (f32, all-ones oracle) through the best
    # format.  The in-solver SpMV rate (iterations x nnz / wall) is the
    # headline: it is how the op executes in production, inside one
    # jitted while_loop.
    op = dia if (best.startswith("dia") and dia is not None) else a
    if stencil is not None:
        # the solver fast path keeps carries in the grid layout
        # (solvers/_stencil.py) — this is the production route for the
        # constant-coefficient class the bench system belongs to
        op = stencil
    b = rmult(op, x)

    def timed_solve(solver, op_override=None, **kw):
        mat = op if op_override is None else op_override
        res = jax.block_until_ready(
            solver(mat, b, max_iterations=6000, epsilon=1e-4, **kw)
        )
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = jax.block_until_ready(
                solver(mat, b, max_iterations=6000, epsilon=1e-4, **kw)
            )
            times.append(time.perf_counter() - t0)
        wall = sorted(times)[1]  # median of 3
        return res, wall, wall

    from sparse_matrix_math_tpu import bicgstab

    cg_res, cg_wall, cg_time = timed_solve(cg)
    # TRUE residual: f32 CG's recursively-updated ||r|| drifts from the
    # real b - A@x at this scale (measured ~56x at 2M rows); report both
    # so the tolerance claim is checkable.  The recursive check itself is
    # reference parity (h:2377-2379 uses the same update).
    cg_true_res = float(jnp.linalg.norm(b - rmult(op, cg_res.x)))

    # Mixed-precision CG (solvers/mixed.py): bf16 matrix stream, f32
    # vectors, iterative-refinement outer loop that converges on the
    # TRUE residual.  Compared at matched true accuracy: epsilon is set
    # to the plain run's actually-achieved true residual.
    mixed_entry = None
    if dia is not None:
        from sparse_matrix_math_tpu import mixed_cg

        def mixed_solver(_op, _b, max_iterations, epsilon, **kw):
            return mixed_cg(
                dia, _b, max_iterations=max_iterations,
                epsilon=cg_true_res * 1.05,
            )

        mx_res, mx_wall, mx_time = timed_solve(mixed_solver)
        mixed_entry = {
            "status": int(mx_res.status),
            "iterations": int(mx_res.iterations),
            "true_residual": _finite(mx_res.residual_norm),
            "epsilon_matched_to_cg_true": round(cg_true_res * 1.05, 6),
            **_solve_times(mx_res, mx_wall),
            "speedup_vs_plain_cg_at_true_accuracy": round(
                cg_time / mx_time, 2
            ),
        }

    # solve() front door at the reference's f32 tolerance: plain f32 CG
    # floors ABOVE 1e-4 at this scale (see the cg entry), so the front
    # door escalates to the double-word refinement automatically
    # (solvers/api.py auto_escalate) — this is the genuine
    # time-to-1e-4 a user gets from solve(a, b, epsilon=1e-4).
    from sparse_matrix_math_tpu import solve as smm_solve

    def auto_once():
        t0 = time.perf_counter()
        res = smm_solve(
            dia if dia is not None else a, b,
            method="cg", epsilon=1e-4, max_iterations=30000,
        )
        # DfSolveResult or SolveResult; force completion either way
        float(np.asarray(
            getattr(res, "residual_norm2", None)
            if getattr(res, "residual_norm2", None) is not None
            else res.residual_norm
        ))
        return res, time.perf_counter() - t0

    auto_once()  # warm
    walls = []
    for _ in range(3):
        at_res, at_wall = auto_once()
        walls.append(at_wall)
    at_wall = sorted(walls)[1]
    escalated = hasattr(at_res, "x_f64")
    if escalated:
        x64 = at_res.x_f64()
        data64a = np.asarray(a.data, np.float64)
        ax = np.add.reduceat(
            data64a * x64[np.asarray(a.indices)],
            np.asarray(a.indptr)[:-1],
        )
        at_true = float(np.linalg.norm(np.asarray(b, np.float64) - ax))
    else:
        at_true = float(
            jnp.linalg.norm(b - rmult(dia if dia is not None else a, at_res.x))
        )
    auto_entry = {
        "status": int(at_res.status),
        "escalated_to_df64": escalated,
        "epsilon": 1e-4,
        "true_residual": at_true,
        "wall_s": round(at_wall, 4),
    }
    if int(at_res.status) == 0:
        auto_entry["time_to_tol_s"] = auto_entry["wall_s"]

    # Geometric-multigrid-preconditioned CG (solvers/multigrid.py): the
    # operator-aware solver — O(10) iterations mesh-independently.  The
    # reference has nothing comparable (its best is IC(0) PCG).
    from sparse_matrix_math_tpu.solvers.multigrid import PoissonMultigrid

    mg = PoissonMultigrid.for_grid(nx)
    mg_res, mg_wall, mg_time = timed_solve(
        cg, op_override=dia if dia is not None else None,
        preconditioner=mg,
    )
    mg_entry = {
        "status": int(mg_res.status),
        "iterations": int(mg_res.iterations),
        "residual": _finite(mg_res.residual_norm),
        **_solve_times(mg_res, mg_wall),
        "speedup_vs_plain_cg": round(cg_time / mg_time, 2),
    }

    # Double-word f32 CG (solvers/df64.py): the reference's f64 contract
    # (test_common.h:30-38, eps=1e-8) — plain f32 CG cannot reach 1e-8 at
    # all at this scale.  Reported per-iteration next to plain f32 CG.
    from sparse_matrix_math_tpu import cg_df64
    from sparse_matrix_math_tpu.ops.df32 import df_operator_from_host_csr

    data64 = np.asarray(a.data, np.float64)
    ind64 = np.asarray(a.indices, np.int64)
    iptr64 = np.asarray(a.indptr, np.int64)
    dfa = df_operator_from_host_csr(data64, ind64, iptr64, a.shape)
    b64 = np.asarray(b, np.float64)
    df_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        df_res = cg_df64(dfa, b64, max_iterations=12000, epsilon=1e-8)
        float(df_res.residual_norm2)  # scalar readback (see above)
        df_times.append(time.perf_counter() - t0)
    df_wall = sorted(df_times)[1]
    df_time = df_wall
    x64 = df_res.x_f64()
    ax = np.add.reduceat(data64 * x64[ind64], iptr64[:-1])
    df_true = float(np.linalg.norm(b64 - ax))
    df_iters = max(int(df_res.iterations), 1)
    f32_per_iter = cg_time / max(int(cg_res.iterations), 1)
    df64_entry = {
        "status": int(df_res.status),
        "iterations": df_iters,
        "epsilon": 1e-8,
        "true_residual_f64": df_true,
        "operator": type(dfa).__name__,
        **_solve_times(df_res, df_wall),
        "per_iter_ms": round(df_time / df_iters * 1e3, 4),
        "per_iter_vs_f32_cg": round(
            (df_time / df_iters) / f32_per_iter, 2
        ),
    }

    # Iterative refinement to the same 1e-8 bar (solvers/ir_df64.py):
    # f32 inner CG corrected by the double-word true residual — the f64
    # contract at ~f32 iteration cost.
    from sparse_matrix_math_tpu import cg_ir_df64

    # fully matrix-free refinement when the system admits it: the
    # double-word TRUE residual runs over DfGridStencil (exact f64
    # coefficient pairs) and the f32 inner solve grid-resident —
    # zero matrix traffic on BOTH precision levels
    ir_op = dfa
    if stencil is not None:
        from sparse_matrix_math_tpu.ops.df32 import DfGridStencil

        ir_op = DfGridStencil.from_stencil(
            stencil,
            coeffs64=np.asarray(stencil.coeffs, np.float64),
        )

    def ir_timed(**kw):
        if stencil is not None:
            kw.setdefault("inner_matrix", stencil)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = cg_ir_df64(
                ir_op, b64, max_iterations=30000, epsilon=1e-8, **kw
            )
            float(res.residual_norm2)  # scalar readback
            times.append(time.perf_counter() - t0)
        wall = sorted(times)[1]
        x64 = res.x_f64()
        ax = np.add.reduceat(data64 * x64[ind64], iptr64[:-1])
        return res, wall, float(np.linalg.norm(b64 - ax))

    ir_res, ir_wall, ir_true = ir_timed()
    ir_entry = {
        "operator": type(ir_op).__name__,
        "status": int(ir_res.status),
        "inner_iterations": int(ir_res.iterations),
        "outer_rounds": int(ir_res.outer_rounds),
        "epsilon": 1e-8,
        "true_residual_f64": ir_true,
        **_solve_times(ir_res, ir_wall),
    }
    ir_entry["speedup_vs_cg_df64"] = round(
        df64_entry["wall_s"] / max(ir_wall, 1e-9), 2
    )
    mg_f32 = mg  # built by the pcg_multigrid section (f32)
    mgi_res, mgi_wall, mgi_true = ir_timed(preconditioner=mg_f32)
    ir_entry["mg_inner"] = {
        "status": int(mgi_res.status),
        "inner_iterations": int(mgi_res.iterations),
        "outer_rounds": int(mgi_res.outer_rounds),
        "true_residual_f64": mgi_true,
        **_solve_times(mgi_res, mgi_wall),
    }
    ir_entry["mg_inner"]["speedup_vs_cg_df64"] = round(
        df64_entry["wall_s"] / max(mgi_wall, 1e-9), 2
    )
    # the f32 flagship honestly reports its ~2e-4 true-residual floor
    # (cg entry, status=2); the refinement delivers a GENUINE 1e-4
    # SUCCESS at comparable wall — record it next to that floor
    def ir_1e4(**kw):
        if stencil is not None:
            kw.setdefault("inner_matrix", stencil)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = cg_ir_df64(
                ir_op, b64, max_iterations=30000, epsilon=1e-4, **kw
            )
            float(res.residual_norm2)
            times.append(time.perf_counter() - t0)
        return res, sorted(times)[1]

    r4, w4 = ir_1e4(preconditioner=mg_f32)
    x4 = r4.x_f64()
    ax4 = np.add.reduceat(data64 * x4[ind64], iptr64[:-1])
    ir_entry["at_f32_epsilon_1e4"] = {
        "status": int(r4.status),
        "inner_iterations": int(r4.iterations),
        "outer_rounds": int(r4.outer_rounds),
        "true_residual_f64": float(np.linalg.norm(b64 - ax4)),
        **_solve_times(r4, w4),
        "note": "genuine ||b-Ax|| <= 1e-4 where plain f32 cg floors "
                "at ~2.4e-4 (see cg.true_residual)",
    }

    # free the double-word operator before the large-allocation sections
    del dfa
    # BiCGStab preconditioned with truncated-sweep SGS on the DIA factors
    # (SGSPreconditioner.from_dia) — unpreconditioned f32 BiCGStab is unstable at
    # this scale (the reference notes the same instability,
    # test/cpp/bicgstab.cpp:68, and also cures it with SGS).  SGS needs
    # stored factors, so this entry stays on the DIA operator.
    bs_pre = None
    if dia is not None:
        from sparse_matrix_math_tpu.precond import SGSPreconditioner

        bs_pre = SGSPreconditioner.from_dia(dia, sweeps=4)
    bs_res, bs_wall, bs_time = timed_solve(
        bicgstab, op_override=dia if dia is not None else None,
        preconditioner=bs_pre,
    )

    cg_gnnz = int(cg_res.iterations) * nnz / cg_time / 1e9
    # BiCGStab does 2 SpMVs/iteration (SURVEY §3.3); with SGS(sweeps=k)
    # each of its 2 preconditioner applies adds (k-1) strict-L + (k-1)
    # strict-U sweeps = (k-1)*(nnz-n) processed entries
    bs_work = 2 * nnz
    if bs_pre is not None:
        bs_work += 2 * (bs_pre.fwd.sweeps - 1) * (nnz - a.shape[0])
    bs_gnnz = int(bs_res.iterations) * bs_work / bs_time / 1e9
    # solves that converged OR ran honestly to their measured precision
    # floor (floor_hit: the iterations were productive and the exit was
    # verified) count toward the headline; DIVERGED runs never do
    counted = [
        rate
        for rate, res in ((cg_gnnz, cg_res), (bs_gnnz, bs_res))
        if int(res.status) == 0
        or (getattr(res, "floor_hit", None) is not None and bool(res.floor_hit))
    ]
    headline = max(counted) if counted else standalone_gnnz

    # -- unstructured/general-pattern SpMV (the reference's own regime:
    # rMultOp is pattern-agnostic, h:1458-1515).  laplace_3d_jittered has
    # no diagonal structure (DIA extraction refuses), so it runs on CSR.
    from sparse_matrix_math_tpu.utils.generate import laplace_3d_jittered

    # symmetric shifted variant: same unstructured pattern class,
    # SPD with the spectrum bounded away from zero, so f32 CG
    # genuinely reaches the tolerance and time-to-tol below is a real
    # solve, not a fixed-iteration proxy.
    ua = laplace_3d_jittered(
        113, dtype=np.float32, symmetric=True, shift=0.25
    )
    usec = _time_spmv_loop(ua, jnp.ones((ua.shape[1],), jnp.float32), 20)
    ub = rmult(ua, jnp.ones((ua.shape[0],), jnp.float32))
    ub = ub / jnp.linalg.norm(ub)
    ures = jax.block_until_ready(
        cg(ua, ub, max_iterations=600, epsilon=1e-4)
    )
    t0 = time.perf_counter()
    ures = jax.block_until_ready(
        cg(ua, ub, max_iterations=600, epsilon=1e-4)
    )
    uwall = time.perf_counter() - t0
    unstructured = {
        "matrix": "laplace3d_jittered_113^3_sym_shift.25",
        "n": ua.shape[0],
        "nnz": ua.nnz,
        "operator": "CSRMatrix",
        "gnnz": round(ua.nnz / usec / 1e9, 3),
        "vs_baseline_f32": round(
            ua.nnz / usec / 1e9 / BASELINE_SPMV_GNNZ_F32, 2
        ),
        "cg_status": int(ures.status),
        "cg_iterations": int(ures.iterations),
        "cg_time_to_tol_s": round(uwall, 4),
        "in_solver_gnnz": round(
            int(ures.iterations) * ua.nnz / uwall / 1e9, 3
        ),
    }

    # -- zero-locality worst case: diag + 5 uniform-random entries per row
    # at 2M rows.  NO layout can serve this pattern well (tile density
    # ~nnz/n^2 is invariant under any reordering), and the reference CPU
    # collapses on it too — its rMult drops 3.8x to 0.142 GNNZ/s (x
    # misses cache per nnz; measured with the same harness as
    # BASELINE_SPMV_GNNZ_F32).  The CSR gather+segment-sum path is
    # reported against THAT number, not the banded baseline.
    from sparse_matrix_math_tpu.utils.generate import uniform_random_csr

    ra = uniform_random_csr(2_000_000, per_row=5, dtype=np.float32)
    rsec = _time_spmv_loop(
        ra, jnp.ones((ra.shape[1],), jnp.float32), 4
    )
    rg = ra.nnz / rsec / 1e9
    worst_case = {
        "matrix": "uniform_random_2M_6perrow",
        "nnz": ra.nnz,
        "csr_gnnz": round(rg, 4),
        "reference_cpu_f32_gnnz": BASELINE_RAND_GNNZ_F32,
    }
    worst_case["gnnz"] = round(rg, 4)
    worst_case["vs_reference_on_this_pattern"] = round(
        rg / BASELINE_RAND_GNNZ_F32, 2
    )
    del ra

    # -- nonsymmetric contract path at bench scale: the same
    # ~2M-row/10M-nnz geometry as the headline system but upwind
    # convection-diffusion (utils/generate.py — the standard
    # nonsymmetric model problem; the reference's nonsymmetric coverage
    # is sherman1 under BiCGStab, h:2191-2283).  bicgstab_ir_df64 takes
    # it to the reference's 1e-8/f64 bar.
    from sparse_matrix_math_tpu import gmres
    from sparse_matrix_math_tpu.formats.dia import try_dia_from_csr as _tdia
    from sparse_matrix_math_tpu.solvers.ir_df64 import bicgstab_ir_df64
    from sparse_matrix_math_tpu.utils.generate import convection_diffusion_2d

    na = convection_diffusion_2d(nx, dtype=np.float64)
    ndata = np.asarray(na.data, np.float64)
    nind = np.asarray(na.indices, np.int64)
    niptr = np.asarray(na.indptr, np.int64)
    nb64 = np.add.reduceat(ndata, niptr[:-1])  # rowsums -> x = ones
    ndfa = df_operator_from_host_csr(ndata, nind, niptr, na.shape)
    # SGS(4)-preconditioned inner BiCGStab: the UNPRECONDITIONED f32
    # inner cannot deliver its per-round reduction at this scale (its
    # recurrence explodes inside one uncapped round) — the same cure
    # as the headline bicgstab entry
    ndia32 = _tdia(convection_diffusion_2d(nx, dtype=np.float32))
    from sparse_matrix_math_tpu.precond import SGSPreconditioner

    npre = SGSPreconditioner.from_dia(ndia32, sweeps=4)

    def nonsym_timed(eps):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = bicgstab_ir_df64(
                ndfa, nb64, max_iterations=30000, epsilon=eps,
                preconditioner=npre,
            )
            float(res.residual_norm2)
            times.append(time.perf_counter() - t0)
        wall = sorted(times)[1]
        x64 = res.x_f64()
        ax = np.add.reduceat(ndata * x64[nind], niptr[:-1])
        return res, wall, float(np.linalg.norm(nb64 - ax))

    nres, nwall, ntrue = nonsym_timed(1e-8)
    nonsym_entry = {
        "matrix": "convection_diffusion_2d_1414_cx.5_cy.25",
        "n": na.shape[0],
        "nnz": na.nnz,
        "inner_preconditioner": "SGSPreconditioner.from_dia(sweeps=4)",
        "bicgstab_ir_df64": {
            "status": int(nres.status),
            "inner_iterations": int(nres.iterations),
            "outer_rounds": int(nres.outer_rounds),
            "epsilon": 1e-8,
            "true_residual_f64": ntrue,
            **_solve_times(nres, nwall),
        },
    }
    # GMRES(32) on the f32 operator — the other nonsymmetric
    # workhorse, measured at scale.  Epsilon sits above the f32 floor
    # of unpreconditioned GMRES on this system, so both rows run to a
    # reachable 6e-4 and report verified SUCCESS walls.
    nb32 = jnp.asarray(nb64, jnp.float32)
    geps = 6e-4
    gres = gmres(ndia32, nb32, max_iterations=6000, epsilon=geps)
    float(gres.residual_norm)
    gtimes = []
    for _ in range(2):
        t0 = time.perf_counter()
        gres = gmres(ndia32, nb32, max_iterations=6000, epsilon=geps)
        float(gres.residual_norm)
        gtimes.append(time.perf_counter() - t0)
    gwall = min(gtimes)
    gdev = gwall
    nonsym_entry["gmres32_f32"] = {
        "epsilon": geps,
        "status": int(gres.status),
        "iterations": int(gres.iterations),
        "residual": _finite(gres.residual_norm),
        **_solve_times(gres, gwall),
        "in_solver_gnnz": round(
            int(gres.iterations) * na.nnz / gdev / 1e9, 3
        ),
    }
    # s-step (communication-avoiding) Arnoldi: the basis panel
    # is read twice per 8-step BLOCK instead of four times per
    # step (solvers/gmres.py); residual_norm is the VERIFIED true
    # ||b - A x||
    cres = gmres(
        ndia32, nb32, max_iterations=6000, epsilon=geps,
        s_step=8,
    )
    float(cres.residual_norm)
    ctimes = []
    for _ in range(2):
        t0 = time.perf_counter()
        cres = gmres(
            ndia32, nb32, max_iterations=6000, epsilon=geps,
            s_step=8,
        )
        float(cres.residual_norm)
        ctimes.append(time.perf_counter() - t0)
    cwall = min(ctimes)
    cdev = cwall
    nonsym_entry["gmres32_sstep8_f32"] = {
        "epsilon": geps,
        "status": int(cres.status),
        "iterations": int(cres.iterations),
        "true_residual": _finite(cres.residual_norm),
        **_solve_times(cres, cwall),
        "in_solver_gnnz": round(
            int(cres.iterations) * na.nnz / cdev / 1e9, 3
        ),
        "speedup_vs_gmres32": round(gdev / max(cdev, 1e-9), 2),
    }

    del ndfa

    # -- 3-D at BASELINE config-5 scale: 243^3 = 14.35M rows / 100M nnz.
    # The matrix-free stencil (constructed directly — its correctness
    # class is covered entry-for-entry by tests/test_stencil.py, and
    # verified here against the generated CSR on a random vector)
    # measures the big-memory in-solver regime.
    from sparse_matrix_math_tpu import GridStencilMatrix
    from sparse_matrix_math_tpu import solve as _solve3
    from sparse_matrix_math_tpu.utils.generate import poisson_3d

    m3 = 243
    # host f64 CSR: the independent oracle for BOTH entries below
    # (stencil verification on a random vector, and the f64 true
    # residual of the 1e-8 contract solve)
    a3 = poisson_3d(m3, dtype=np.float64)
    d3 = np.asarray(a3.data, np.float64)
    i3 = np.asarray(a3.indices, np.int64)
    p3 = np.asarray(a3.indptr, np.int64)
    st3 = GridStencilMatrix(
        coeffs=jnp.asarray(
            [6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0], jnp.float32
        ),
        doffs=((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0),
               (0, 1, 0), (0, 0, -1), (0, 0, 1)),
        dims=(m3, m3, m3),
        shape=a3.shape,
        nnz=int(a3.nnz),
    )
    xr = np.random.default_rng(0).standard_normal(a3.shape[0])
    ax64 = np.add.reduceat(d3 * xr[i3], p3[:-1])
    sx = np.asarray(st3 @ jnp.asarray(xr, jnp.float32), np.float64)
    apply_err = float(np.max(np.abs(sx - ax64)))
    assert apply_err < 1e-3, apply_err
    b3 = st3 @ jnp.ones((a3.shape[0],), jnp.float32)

    def run3(maxi, eps):
        r3 = jax.block_until_ready(
            cg(st3, b3, max_iterations=maxi, epsilon=eps)
        )
        t3s = []
        for _ in range(2):
            t0 = time.perf_counter()
            r3 = jax.block_until_ready(
                cg(st3, b3, max_iterations=maxi, epsilon=eps)
            )
            t3s.append(time.perf_counter() - t0)
        return r3, min(t3s)

    r3, w3 = run3(800, 1e-4)
    k3 = max(int(r3.iterations), 1)
    per_iter = w3 / k3
    threed = {
        "matrix": "poisson3d_243^3_100Mnnz",
        "n": a3.shape[0],
        "nnz": int(a3.nnz),
        "operator": "GridStencilMatrix",
        "apply_vs_f64_csr_err": apply_err,
        "status": int(r3.status),
        "iterations": k3,
        **_solve_times(r3, w3),
        "in_solver_gnnz": round(k3 * a3.nnz / w3 / 1e9, 3),
        "per_iter_ms": round(per_iter * 1e3, 4),
    }

    # the reference's f64 1e-8 contract AT THIS SCALE through the
    # front door: solve() pre-routes the
    # below-f32-floor epsilon to the MG-preconditioned double-word
    # refinement; the residual is verified in f64 on the host
    # against the generated CSR
    b64 = np.add.reduceat(d3, p3[:-1])  # row sums -> x_true = ones

    def contract():
        t0 = time.perf_counter()
        res = jax.block_until_ready(_solve3(
            st3, b64, method="cg", epsilon=1e-8,
            preconditioner="multigrid", max_iterations=60000,
        ))
        return res, time.perf_counter() - t0

    contract()  # warm
    cwalls = []
    for _ in range(2):
        c_res, c_w = contract()
        cwalls.append(c_w)
    c_w = min(cwalls)
    x64 = c_res.x_f64()
    c_true = float(np.linalg.norm(
        b64 - np.add.reduceat(d3 * x64[i3], p3[:-1])
    ))
    threed["solve_1e8_multigrid"] = {
        "status": int(c_res.status),
        "epsilon": 1e-8,
        "inner_iterations": int(c_res.iterations),
        "outer_rounds": int(c_res.outer_rounds),
        "true_residual_f64": c_true,
        "wall_s": round(c_w, 4),
    }
    if int(c_res.status) == 0:
        threed["solve_1e8_multigrid"]["time_to_tol_s"] = round(c_w, 4)
    del a3, st3, b3, d3, i3, p3

    # -- multi-RHS panel solve (solvers/block.py): one SpMM per
    # iteration feeds every column; effective throughput is the SpMM
    # entries processed per second in-solver.
    from sparse_matrix_math_tpu.solvers.block import cg_multi

    # the production panel route is the batched stencil apply
    # (GridStencilMatrix.apply_batched, grid-layout carries); fall
    # back to DIA/CSR only when detection failed
    mop = stencil if stencil is not None else (
        dia if dia is not None else a
    )
    rng = np.random.default_rng(0)

    def panel_per_iter(m_rhs):
        """Seconds per iteration of a 600-iteration panel solve."""
        Xt = jnp.asarray(
            rng.standard_normal((a.shape[0], m_rhs)), jnp.float32
        )
        B = rmult(mop, Xt)

        jax.block_until_ready(
            cg_multi(mop, B, max_iterations=600, epsilon=1e-20)
        )
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            jax.block_until_ready(
                cg_multi(mop, B, max_iterations=600, epsilon=1e-20)
            )
            best = min(best, time.perf_counter() - t0)
        return best / 600

    per_iter = {m: panel_per_iter(m) for m in (1, 2, 8)}
    # a real converging panel solve for statuses (oracle panel,
    # relative tolerance: absolute eps under a random-normal b at
    # n=2M sits below the f32 floor)
    m_rhs = 8
    Xt = jnp.asarray(
        rng.standard_normal((a.shape[0], m_rhs)), jnp.float32
    )
    B = rmult(mop, Xt)
    eps_multi = 1e-3 * float(jnp.linalg.norm(B, axis=0).min())
    mres = cg_multi(mop, B, max_iterations=4000, epsilon=eps_multi)
    statuses = [int(v) for v in np.asarray(mres.status).reshape(-1)]
    single_per_iter = cg_time / max(int(cg_res.iterations), 1)
    multi_entry = {
        "operator": type(mop).__name__,
        "statuses_at_rel_1e3": statuses,
        "single_rhs_us_per_iter": round(single_per_iter * 1e6, 1),
        "per_iter_us": {
            str(m): round(t * 1e6, 1) for m, t in per_iter.items()
        },
        "per_column_gnnz": {
            str(m): round(nnz / (t / m) / 1e9, 1)
            for m, t in per_iter.items()
        },
        "per_column_vs_single_rhs": {
            str(m): round(single_per_iter / (t / m), 3)
            for m, t in per_iter.items()
        },
    }

    payload = {
        "metric": "spmv_in_solver_poisson2d_10Mnnz_f32",
        "value": round(headline, 3),
        "unit": "GNNZ/s",
        # dtype-matched ratio: f32 measurement over the f32 reference
        # baseline (0.536 GNNZ/s; the f64/f64 pair is 0.455 — see
        # BASELINE_SPMV_GNNZ_* above)
        "vs_baseline": round(headline / BASELINE_SPMV_GNNZ, 2),
        "dtype": "float32",
        "baseline_gnnz": {
            "f32": BASELINE_SPMV_GNNZ_F32,
            "f64": BASELINE_SPMV_GNNZ_F64,
        },
        "unstructured": unstructured,
        "worst_case_uniform_random": worst_case,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "spmv_kernel": best,
        "spmv_standalone_gnnz": round(standalone_gnnz, 3),
        "spmv_all_paths_ms": {
            k: (round(v * 1e3, 4) if np.isfinite(v) else None)
            for k, v in results.items()
        },
        "pcg_multigrid": mg_entry,
        "cg": {
            "status": int(cg_res.status),
            "iterations": int(cg_res.iterations),
            "residual": _finite(cg_res.residual_norm),
            "true_residual": round(cg_true_res, 6),
            **_solve_times(cg_res, cg_wall),
            "in_solver_gnnz": round(cg_gnnz, 3),
        },
        "solve_auto_epsilon_1e4": auto_entry,
        "cg_mixed_bf16": mixed_entry,
        "cg_df64_1e8_on_chip": df64_entry,
        "cg_ir_df64_1e8_on_chip": ir_entry,
        "bicgstab": {
            "status": int(bs_res.status),
            "iterations": int(bs_res.iterations),
            "residual": _finite(bs_res.residual_norm),
            **_solve_times(bs_res, bs_wall),
            "in_solver_gnnz": round(bs_gnnz, 3),
        },
        "nonsymmetric_at_scale": nonsym_entry,
        "poisson3d_100Mnnz": threed,
        "cg_multi": multi_entry,
        "n": a.shape[0],
        "nnz": nnz,
    }

    # full payload to the sidecar; the driver-facing line stays COMPACT
    # (r3's fat line outgrew the tail capture -> parsed: null)
    import os as _os

    detail_path = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                                "bench_detail.json")
    with open(detail_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({
        "metric": payload["metric"],
        "value": payload["value"],
        "unit": payload["unit"],
        "vs_baseline": payload["vs_baseline"],
        "device": payload["device"],
        "n": payload["n"],
        "nnz": payload["nnz"],
        "detail": "bench_detail.json",
    }))


if __name__ == "__main__":
    main()
