"""ctypes bindings for the native host runtime (smm_native.cpp).

Compiled on first use with g++ (-O3) into ``build/libsmm_native.so``;
every caller has a pure-NumPy fallback, so a missing toolchain degrades
performance, never capability.  (pybind11 is not available in this
environment — the C ABI + ctypes is the binding layer.)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = [
    "available",
    "ic0_factorize_native",
    "ilu0_factorize_native",
    "mtx_read_native",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "smm_native.cpp")
_BUILD_DIR = os.path.join(_DIR, "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path() -> str:
    """Source-content-hashed artifact name.  The hash in the FILENAME is
    load-bearing: glibc caches dlopen by pathname, so a long-lived
    process that loaded an older build would silently keep its stale
    mapping if a rebuild reused the same name (os.replace cannot evict
    live mappings) — and a newer-API caller would then crash on a
    missing symbol.  A new source -> a new path -> a genuinely fresh
    dlopen, in every process."""
    import hashlib

    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libsmm_native.{h}.so")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _compile() -> Optional[str]:
    # EVERYTHING here must degrade to the NumPy fallback: read-only
    # installs (makedirs fails), missing toolchain, concurrent builds
    # (pid-unique temp name so two processes never clobber each other).
    try:
        so = _so_path()
        os.makedirs(_BUILD_DIR, exist_ok=True)
        if os.path.exists(so):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        base = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            _SRC, "-o", tmp,
        ]
        subprocess.run(base, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        # opportunistically drop superseded builds (best-effort; a build
        # still mapped by another live process keeps working — unlink
        # only removes the name)
        for f in os.listdir(_BUILD_DIR):
            if f.startswith("libsmm_native.") and f != os.path.basename(so):
                try:
                    os.unlink(os.path.join(_BUILD_DIR, f))
                except OSError:
                    pass
        return so
    except (subprocess.SubprocessError, OSError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _compile()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            _bind(lib)
        except (OSError, AttributeError):
            # AttributeError = a symbol is missing (e.g. a stale build
            # mapped by a long-lived process): disable the native layer
            # entirely rather than crash callers — every caller has a
            # NumPy fallback
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.smm_ic0_factorize.restype = ctypes.c_int
    lib.smm_ic0_factorize.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, _f64p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.smm_ilu0_factorize.restype = ctypes.c_int
    lib.smm_ilu0_factorize.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _f64p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.smm_mtx_header.restype = ctypes.c_int
    lib.smm_mtx_header.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.smm_mtx_read.restype = ctypes.c_int
    lib.smm_mtx_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
        _i64p, _i64p, _f64p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]


def available() -> bool:
    """Whether the native library compiled and loaded."""
    return _load() is not None


def ic0_factorize_native(l_indptr, l_indices, a_lower):
    """L values for IC(0) on the given lower pattern, or None if the
    native library is unavailable.  Raises ValueError on non-SPD input
    (parity with the Python path's FactorizationError contract — callers
    re-wrap)."""
    lib = _load()
    if lib is None:
        return None
    n = l_indptr.shape[0] - 1
    l_values = np.zeros_like(a_lower)
    err = ctypes.c_int64(-1)
    rc = lib.smm_ic0_factorize(
        n,
        np.ascontiguousarray(l_indptr, np.int64),
        np.ascontiguousarray(l_indices, np.int64),
        np.ascontiguousarray(a_lower, np.float64),
        l_values,
        ctypes.byref(err),
    )
    if rc == 2:
        raise ValueError(
            f"non-positive pivot at row {err.value}; matrix is not SPD "
            "(reference would silently produce NaN here, h:1879)"
        )
    if rc != 0:
        return None
    return l_values


def ilu0_factorize_native(indptr, indices, diag_pos, data, pivot_tol=0.0):
    """ILU(0) factor values aligned with A's pattern, or None if the
    native library is unavailable.  Raises ValueError on a zero pivot
    (|pivot| <= pivot_tol — near-zero pivots produce unusable factors
    just like exact zeros; callers escalate through diagonal shifts)."""
    lib = _load()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    factor = np.array(data, dtype=np.float64, copy=True)
    err = ctypes.c_int64(-1)
    rc = lib.smm_ilu0_factorize(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        np.ascontiguousarray(diag_pos, np.int64),
        factor,
        float(pivot_tol),
        ctypes.byref(err),
    )
    if rc == 3:
        raise ValueError(f"zero pivot at row {err.value} during ILU(0)")
    if rc != 0:
        return None
    return factor


def mtx_read_native(path: str, allow_general: bool):
    """Parse a Matrix Market file natively.

    Returns (rows, cols, r, c, v) with symmetric mirroring applied, or
    None if the native library is unavailable.  Raises a tuple-carrying
    ValueError with (status_code, message) on bad input so io/ can map it
    onto MatrixLoadStatus.
    """
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    nnz = ctypes.c_int64(0)
    sym = ctypes.c_int(0)
    rc = lib.smm_mtx_header(
        path.encode(), ctypes.byref(rows), ctypes.byref(cols),
        ctypes.byref(nnz), ctypes.byref(sym), int(allow_general),
    )
    if rc != 0:
        raise _MtxNativeError(rc, f"header parse failed for {path}")
    cap = max(2 * nnz.value, 1)
    r = np.empty(cap, np.int64)
    c = np.empty(cap, np.int64)
    v = np.empty(cap, np.float64)
    count = ctypes.c_int64(0)
    bad_line = ctypes.c_int64(0)
    rc = lib.smm_mtx_read(
        path.encode(), int(allow_general), cap, r, c, v,
        ctypes.byref(count), ctypes.byref(bad_line),
    )
    if rc != 0:
        raise _MtxNativeError(
            rc, f"parse failed at {path}:{bad_line.value}"
        )
    k = count.value
    return int(rows.value), int(cols.value), r[:k], c[:k], v[:k]


class _MtxNativeError(ValueError):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
