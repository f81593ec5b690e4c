"""One place that decides where JAX's persistent compilation cache lives.

The cache key includes the directory, so a path that moves between runs
never hits: it is either the directory `JAX_COMPILATION_CACHE_DIR` names
(JAX reads that variable itself, and nothing here overrides it) or the
fixed `<checkout>/.jax_cache`, which git ignores.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
