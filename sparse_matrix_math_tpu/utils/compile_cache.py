"""Persistent compilation cache set-up for this library's entry points.

Solver while_loops take seconds to compile, and every fresh process
(the CLI, the benchmark, the smoke check) would otherwise pay that
again.  JAX keys its persistent cache by directory, so the directory
must not move between runs: a path with a temporary name, a process id
or a time never hits.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CACHE_ENV", "default_cache_dir", "enable_compilation_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: fixed, inside the checkout that holds
    this package, and listed in ``.gitignore``."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this sets nothing; otherwise the cache goes to
    :func:`default_cache_dir`.  Call before the first compilation.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
