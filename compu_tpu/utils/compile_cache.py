"""Persistent XLA compile cache shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at one fixed directory
inside the checkout (``.jax_cache/``, listed in ``.gitignore``): the cache
key includes the path, so a directory that moved would never hit.
"""

from __future__ import annotations

import os
import pathlib

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=os.environ) -> tuple[str, bool]:
    """(directory, from_environment) for the persistent compile cache."""
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env, True
    return str(REPO_CACHE), False


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`;
    returns the directory in use. Call before the first compilation."""
    path, from_env = compile_cache_dir()
    if not from_env:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
