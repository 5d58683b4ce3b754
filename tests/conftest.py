"""Test config: CPU platform with 8 virtual devices + float64.

Single-device logic tests run on the CPU; multi-device sharding tests
use a simulated 8-device mesh via ``xla_force_host_platform_device_count``
(so distributed code paths are exercised without several cards).

``SMM_GPU_TESTS=1`` leaves the platform to JAX, for the card suite:

    SMM_GPU_TESTS=1 python -m pytest -m gpu tests/gpu -q
"""

import os

if not os.environ.get("SMM_GPU_TESTS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The reference's test assets (public matrices from the NASA/Pothen and
# Harwell-Boeing collections). Used read-only when present; tests that
# need them skip otherwise so the suite is self-contained.
REFERENCE_ASSETS = "/root/reference/test/assets"

MESH_MATRICES = [
    "mesh1e1_structural_48_48_177.mtx",
    "mesh1em1_structural_48_48_177.mtx",
    "mesh1em6_structural_48_48_177.mtx",
]
SHERMAN1 = "sherman1_1000_1000_2375.mtx"


def asset_path(name: str) -> str:
    path = os.path.join(REFERENCE_ASSETS, name)
    if not os.path.exists(path):
        pytest.skip(f"reference asset {name} not available")
    return path


@pytest.fixture(params=[np.float32, np.float64], ids=["f32", "f64"])
def dtype(request):
    """Dtype parametrization mirroring the reference's
    TEST_CASE_TEMPLATE(float, double) (test/cpp/csr.cpp:5)."""
    return request.param


def l2_eps(dtype) -> float:
    """Residual tolerances from the reference test suite
    (test/include/test_common.h:30-38)."""
    return 1e-4 if np.dtype(dtype) == np.float32 else 1e-8


def inf_eps(dtype) -> float:
    """Per-element error tolerances (test_common.h:43-51)."""
    return 1e-4 if np.dtype(dtype) == np.float32 else 1e-8


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Serial full-suite runs accumulate hundreds of compiled XLA:CPU
    modules; past ~460 tests the next LLVM compile segfaults inside
    backend_compile_and_load (reproduced twice at the same spot, round
    4; the -n 4 xdist run is unaffected because workers fork).  Clearing
    the compilation caches at module boundaries keeps the process
    under the cliff at the cost of some recompilation."""
    yield
    jax.clear_caches()


@pytest.fixture
def require_gpu():
    """Skip unless JAX runs on an NVIDIA GPU (tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: SMM_GPU_TESTS=1 pytest -m gpu tests/gpu")
