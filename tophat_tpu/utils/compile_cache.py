"""Persistent XLA compilation cache, shared by every entry point.

JAX keys a cached executable on, among other things, the directory it
lives in, so the directory must not move between runs: a path built from
a temporary name, a pid or the time never hits.
"""

from __future__ import annotations

import os

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; call before the first compilation.

    With $JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and no other
    directory is set here; otherwise DEFAULT_DIR. Returns the directory
    in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
