"""Example: distributed solve over a device mesh (works identically on a
simulated CPU mesh and on several GPUs).

    python examples/distributed_solve.py            # all local devices
    python examples/distributed_solve.py --cpu 8    # simulated 8-dev mesh
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="simulate N virtual CPU devices")
    args = ap.parse_args()

    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", f"--xla_force_host_platform_device_count={args.cpu}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import sparse_matrix_math_tpu as smm
    from sparse_matrix_math_tpu.parallel import (
        collect,
        dist_solve,
        distribute_csr,
        distribute_preconditioner,
        make_mesh,
    )
    from sparse_matrix_math_tpu.utils.generate import poisson_2d

    mesh = make_mesh()
    print("mesh:", mesh)

    a = poisson_2d(64)
    da = distribute_csr(a, mesh)           # halo mode auto-detected
    print("exchange mode:", da.mode)
    b = np.asarray(a.to_dense()).sum(axis=1)

    # explicit small sweep count: the standard approximate triangular
    # solve (sweeps="exact" would cost depth~127 SpMVs per apply here)
    pre = distribute_preconditioner(
        smm.get_preconditioner(a, "sgs", method="jacobi", sweeps=4),
        da, mesh,
    )
    # eps sits above the f32 true-residual floor (~1e-6 at this n):
    # SUCCESS is verified against ||b - A x||, not the recurrence
    res = dist_solve(
        da, b, solver="bicgstab", preconditioner=pre, epsilon=1e-5, mesh=mesh
    )
    x = collect(res.x, da)
    print(res, "| max|x-1| =", float(np.abs(x - 1).max()))


if __name__ == "__main__":
    main()
