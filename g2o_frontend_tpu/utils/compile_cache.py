"""Where JAX keeps its persistent compilation cache.

Every entry point (``chip_smoke.py``, ``bench.py``, ``apps/*``) calls
`enable_compile_cache` before its first compilation, so repeated runs of the
same program skip XLA compiles. The cache key includes the directory, so the
directory must not move between runs: it is either the one the environment
names or one fixed path inside the checkout (git-ignored).
"""
from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set. Otherwise the cache goes to `CHECKOUT_CACHE_DIR`.
    Call it before the process compiles anything: JAX decides once, at its
    first compilation, whether the cache is in use.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
