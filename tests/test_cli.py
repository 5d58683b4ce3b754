"""CLI tests (python -m sparse_matrix_math_tpu)."""

import json

import numpy as np
import pytest

from sparse_matrix_math_tpu.__main__ import main

from conftest import MESH_MATRICES, SHERMAN1, asset_path


def run_cli(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


class TestCLI:
    def test_info(self, capsys):
        rc, out = run_cli(capsys, ["info", asset_path(SHERMAN1)])
        assert rc == 0
        assert out["shape"] == [1000, 1000]
        assert out["nnz"] == 3750
        assert out["distinct_diagonals"] == 7
        assert out["symmetric_pattern"] is True

    def test_solve_default_cg(self, capsys):
        rc, out = run_cli(capsys, ["solve", asset_path(MESH_MATRICES[0])])
        assert rc == 0
        assert out["status"] == "SUCCESS"
        assert out["iterations"] == 21  # BASELINE.md parity

    def test_solve_preconditioned(self, capsys):
        rc, out = run_cli(capsys, [
            "solve", asset_path(MESH_MATRICES[0]),
            "--method", "bicgstab", "--preconditioner", "sgs",
        ])
        assert rc == 0 and out["status"] == "SUCCESS"
        assert out["iterations"] == 5  # BASELINE.md parity

    def test_solve_output_file(self, capsys, tmp_path):
        out_path = str(tmp_path / "x.npy")
        rc, out = run_cli(capsys, [
            "solve", asset_path(MESH_MATRICES[0]), "--output", out_path,
        ])
        assert rc == 0
        x = np.load(out_path)
        np.testing.assert_allclose(x, 1.0, atol=1e-7)

    def test_solve_failure_exit_code(self, capsys):
        rc, out = run_cli(capsys, [
            "solve", asset_path(MESH_MATRICES[0]),
            "--max-iterations", "1", "--tol", "1e-14",
        ])
        assert rc == 1
        assert out["status"] == "MAX_ITERATIONS_REACHED"

    def test_bench_spmv(self, capsys):
        rc, out = run_cli(capsys, [
            "bench-spmv", asset_path(MESH_MATRICES[0]), "--iters", "2",
        ])
        assert rc == 0
        assert out["csr"]["gnnz_per_s"] > 0


def test_solve_api_dia_preconditioners():
    """solve() builds DIA-domain preconditioners (PaddedSGS / Chebyshev)
    without a CSR detour (round-2 API coherence)."""
    import jax.numpy as jnp
    import numpy as np

    from sparse_matrix_math_tpu import solve
    from sparse_matrix_math_tpu.formats.dia import dia_from_csr
    from sparse_matrix_math_tpu.utils.generate import poisson_2d

    csr = poisson_2d(16, dtype=np.float64)
    dia = dia_from_csr(csr)
    b = csr @ jnp.ones(csr.shape[0], jnp.float64)
    r1 = solve(dia, b, method="cg", preconditioner="sgs",
               preconditioner_options={"sweeps": 2}, epsilon=1e-8)
    assert int(r1.status) == 0
    r2 = solve(dia, b, method="cg", preconditioner="chebyshev",
               preconditioner_options={"degree": 4}, epsilon=1e-8)
    assert int(r2.status) == 0
    with pytest.raises(ValueError):
        solve(dia, b, method="cg", preconditioner="ic0")


def test_bench_spmv_reports_formats(capsys, tmp_path):
    from sparse_matrix_math_tpu.io import save_dense_text
    from sparse_matrix_math_tpu.utils.generate import poisson_2d

    a = poisson_2d(6, dtype=np.float64)
    path = str(tmp_path / "m.smmdt")
    save_dense_text(path, a)
    rc, report = run_cli(capsys, ["bench-spmv", path, "--iters", "2"])
    assert rc == 0
    assert set(report) == {"csr", "dia", "ell"}
    assert all(report[k]["gnnz_per_s"] > 0 for k in report)


import jax.numpy as jnp


class TestAutoFormat:
    """solve(auto_format=True): a CSR input is converted through
    best_format before solving — results must match the explicit-format
    runs, and the preconditioner must still build (factored from the
    CSR source when the selected layout can't factor it directly)."""

    def test_stencil_routes_to_dia(self):
        from sparse_matrix_math_tpu.solvers.api import solve
        from sparse_matrix_math_tpu.utils.generate import poisson_2d

        a = poisson_2d(24, dtype=np.float64)
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        plain = solve(a, b, method="cg", epsilon=1e-10)
        auto = solve(a, b, method="cg", epsilon=1e-10, auto_format=True)
        assert int(auto.status) == 0
        assert int(auto.iterations) == int(plain.iterations)
        np.testing.assert_allclose(np.asarray(auto.x), 1.0, atol=1e-8)

    def test_preconditioner_falls_back_to_csr_source(self):
        """A pattern that stays CSR must still build SGS from the CSR
        source."""
        from sparse_matrix_math_tpu.formats import best_format
        from sparse_matrix_math_tpu.formats.dia import DIAMatrix
        from sparse_matrix_math_tpu.solvers.api import solve
        from sparse_matrix_math_tpu.utils.generate import random_spd_csr

        a = random_spd_csr(600, density=0.02, seed=3)
        assert not isinstance(best_format(a), DIAMatrix)
        b = a @ jnp.ones(600, jnp.float64)
        res = solve(a, b, method="cg", preconditioner="sgs",
                    epsilon=1e-10, auto_format=True)
        assert int(res.status) == 0
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-7)

    def test_non_csr_input_passes_through(self):
        from sparse_matrix_math_tpu.formats.dia import dia_from_csr
        from sparse_matrix_math_tpu.solvers.api import solve
        from sparse_matrix_math_tpu.utils.generate import poisson_2d

        a = dia_from_csr(poisson_2d(12, dtype=np.float64))
        b = jnp.ones(a.shape[0], jnp.float64)
        res = solve(a, b, method="cg", epsilon=1e-8, auto_format=True)
        assert int(res.status) == 0

    def test_reordered_route_preconditioner_in_permuted_domain(self):
        """On an RCM-reordered operator the preconditioner must factor
        from the PERMUTED matrix (never the unpermuted source) and the
        solve must match the raw-CSR preconditioned run."""
        from sparse_matrix_math_tpu.formats.reorder import (
            permute_csr, reorder_rcm,
        )
        from sparse_matrix_math_tpu.solvers.api import solve
        from sparse_matrix_math_tpu.utils.generate import poisson_2d

        rng = np.random.default_rng(4)
        a0 = poisson_2d(48, dtype=np.float64)
        perm = rng.permutation(a0.shape[0])
        a = permute_csr(a0, perm)  # scrambled numbering, same system
        b = a @ jnp.ones(a.shape[0], jnp.float64)
        ref = solve(a, b, method="cg", preconditioner="sgs", epsilon=1e-10)
        got = solve(reorder_rcm(a), b, method="cg", preconditioner="sgs",
                    epsilon=1e-10)
        assert int(got.status) == 0
        np.testing.assert_allclose(np.asarray(got.x), 1.0, atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(got.x), np.asarray(ref.x), atol=1e-8
        )
