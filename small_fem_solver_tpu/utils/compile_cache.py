"""One place that decides where JAX keeps its persistent compilation cache.

The entry points (``chip_smoke.py``, ``bench.py``, ``cli.main`` and
``__graft_entry__.py``) call :func:`enable_compile_cache` before their first
compile.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here.  Otherwise the cache lives in ``.jax_cache/`` at the
repository root: a fixed path, because the path is part of what a later
process must find again (a temp or per-process directory never hits).
"""
from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
