"""chip_smoke.py on the CPU: its phases at small sizes, its independent
float64 references, and its refusal to report anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def rep(capsys):
    r = cs.Report("test card, 0 W")
    yield r
    assert r.failed == [], capsys.readouterr().out


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_poisson_reference_matches_dense():
    m = 4
    a = sp.diags([6.0], [0], shape=(m ** 3, m ** 3)).toarray()
    for stride in (1, m, m * m):
        for i in range(m ** 3):
            for j in (i - stride, i + stride):
                if 0 <= j < m ** 3 and (
                    stride != 1 or j // m == i // m
                ) and (stride != m or j // (m * m) == i // (m * m)):
                    a[i, j] = -1.0
    x = np.random.default_rng(0).standard_normal(m ** 3)
    np.testing.assert_allclose(cs.poisson3d_apply(x, m), a @ x, atol=1e-12)


def test_conv_diff_reference_matches_generator():
    from sparse_matrix_math_tpu.utils.generate import convection_diffusion_2d

    offsets, planes = cs.conv_diff_diagonals(9)
    ref = cs.scipy_from_diagonals(offsets, planes).toarray()
    np.testing.assert_array_equal(
        ref, np.asarray(convection_diffusion_2d(9).to_dense())
    )


def test_phases_a_to_c(rep, capsys):
    st, b64 = cs.phase_a(rep, m=10)
    cs.phase_b(rep, st, b64)
    cs.phase_c(rep, st, x64=True)
    out = _lines(capsys)
    assert [r["phase"] for r in out] == ["A", "B", "C"]
    assert all(r["card"] == "test card, 0 W" for r in out)
    assert out[2]["result_type"] == "DfSolveResult"
    assert out[2]["jax_enable_x64"] is True
    assert out[2]["residual_abs"] <= 1e-8


def test_phase_c_with_pure_f32_transforms(rep, capsys):
    """JAX's default (x64 off) runs the error-free transforms as f32
    Dekker/Knuth sequences; the contract must hold there too."""
    cs.phase_c(rep, cs.stencil_7pt(10), x64=False)
    (line,) = _lines(capsys)
    assert line["jax_enable_x64"] is False
    assert line["residual_abs"] <= 1e-8


def test_phases_d_to_f(rep, capsys):
    dia, a_ref = cs.phase_d(rep, nx=24)
    csr, ell, csr_ref = cs.phase_e(rep, m=8)
    cs.phase_f(rep, dia, a_ref, csr, ell, csr_ref, restart=16)
    out = _lines(capsys)
    kernels = [r.get("kernel") for r in out if r["phase"] == "F"]
    assert "DIA SGS apply (SGSPreconditioner.from_dia)" in kernels
    # every kernel line is checked against a float64 reference
    assert all("check" in r for r in out if r["phase"] == "F")
    df = [r for r in out if r.get("kernel", "").startswith("double-word")]
    assert [r["jax_enable_x64"] for r in df] == [False, True]
    assert all(r["lo_words_nonzero"] > 0 for r in df)
    assert all("gb_per_s" in r for r in out if r.get("kernel", "").endswith(
        ("(gather)", "(gather + segment_sum)")))


def test_four_gpu_phase_on_virtual_devices(rep, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    cs.four_gpus(rep, m=12)
    (line,) = _lines(capsys)
    assert len(line["shards"]) == 4
    assert abs(line["iterations"] - line["one_card"]["iterations"]) <= 1


def test_main_fails_without_nvidia_smi(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_line", lambda: None)
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_main_fails_when_backend_is_not_gpu(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_line", lambda: "fake, 1 W")
    monkeypatch.setattr(cs, "run_card_tests", lambda: 0)
    assert jax.default_backend() != "gpu"
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
