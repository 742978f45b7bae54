"""Runtime setup shared by the entry points: JAX's persistent compile cache.

Every CLI invocation is a fresh process, so the harnesses (run_tests,
run_benchmark) would recompile the same solve each time without a
persistent cache.  The cache key includes the directory, so it lives at
one fixed place: where ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that
variable itself, and nothing is set in code then), otherwise
``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

__all__ = ["CACHE_DIR", "configure_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory and
    return the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
