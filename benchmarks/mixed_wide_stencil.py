"""Where the bf16 matrix stream can win: wide-stencil measurement.

``solve(..., matrix_dtype="bfloat16")`` halves the diagonal-plane
stream.  The split can only pay on WIDE stencils, where the diagonal
planes — not the solver vectors — dominate the memory traffic.  This
script measures it on the 27-point 3-D Laplacian (utils/generate.py:
poisson_3d_27pt): at 128^3 the f32 matrix stream is 27 planes x 8 MB
= 226 MB/SpMV vs ~6 vector passes x 8 MB = 48 MB/iteration of vector
traffic, so halving the matrix stream bounds the win at ~1.7x/iter.
Values are small integers => the bf16-rounded operator is exact and the
refinement outer loop verifies without extra rounds.

    python benchmarks/mixed_wide_stencil.py [--nx 128] [--eps 1e-4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(nx: int, eps: float, family: str = "27pt") -> None:
    import numpy as np

    t0 = time.perf_counter()
    from sparse_matrix_math_tpu.formats.dia import dia_from_csr
    from sparse_matrix_math_tpu.utils.generate import poisson_2d, poisson_3d_27pt

    csr = (
        poisson_3d_27pt(nx, dtype=np.float32)
        if family == "27pt"
        else poisson_2d(nx, dtype=np.float32)
    )
    dia = dia_from_csr(csr)
    build_s = time.perf_counter() - t0

    import jax
    import jax.numpy as jnp

    from sparse_matrix_math_tpu.solvers.cg import conjugate_gradient
    from sparse_matrix_math_tpu.solvers.mixed import mixed_cg

    n = dia.shape[0]
    b = dia.rmult(jnp.ones((n,), jnp.float32))
    jax.block_until_ready(b)
    # RELATIVE tolerance: an absolute 1e-4 against this ||b|| (~1e2) sits
    # below the f32 floor and both solvers just burn iterations hunting
    # their floors — the comparison must be at a reachable matched target
    bnorm = float(jnp.linalg.norm(b))
    eps_abs = eps * bnorm

    # sync floor: one trivial dispatch+sync round trip (bench.py method)
    ident = jax.jit(lambda v: v + 0.0)
    jax.block_until_ready(ident(b))
    t = time.perf_counter()
    jax.block_until_ready(ident(b))
    floor = time.perf_counter() - t

    def timed(fn):
        res = fn()  # warm/compile
        jax.block_until_ready(res.x)
        t = time.perf_counter()
        res = fn()
        jax.block_until_ready(res.x)
        return res, time.perf_counter() - t - floor

    epsj = jnp.float32(eps_abs)
    plain, plain_s = timed(
        lambda: conjugate_gradient(dia, b, epsilon=epsj)
    )
    mixed, mixed_s = timed(
        lambda: mixed_cg(dia, b, epsilon=epsj, matrix_dtype="bfloat16")
    )

    def true_res(x):
        return float(jnp.linalg.norm(b - dia.rmult(x)))

    out = {
        "system": f"{family}_{nx}",
        "n": n,
        "nnz": dia.nnz,
        "ndiags": len(dia.offsets),
        "epsilon_rel": eps,
        "epsilon_abs": eps_abs,
        "b_norm": round(bnorm, 3),
        "host_build_s": round(build_s, 2),
        "sync_floor_s": round(floor, 4),
        "plain_f32": {
            "status": int(plain.status),
            "iterations": int(plain.iterations),
            "device_s": round(plain_s, 4),
            "us_per_iter": round(1e6 * plain_s / max(int(plain.iterations), 1), 1),
            "true_residual": true_res(plain.x),
        },
        "mixed_bf16": {
            "status": int(mixed.status),
            "iterations": int(mixed.iterations),
            "device_s": round(mixed_s, 4),
            "us_per_iter": round(1e6 * mixed_s / max(int(mixed.iterations), 1), 1),
            "true_residual": true_res(mixed.x),
        },
        "speedup_bf16_over_f32": round(plain_s / mixed_s, 3),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--eps", type=float, default=1e-4)
    ap.add_argument("--family", choices=("27pt", "5pt"), default="27pt")
    args = ap.parse_args()
    main(args.nx, args.eps, args.family)
