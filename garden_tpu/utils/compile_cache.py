"""Persistent compiled-program cache (the VulkanAPI pipeline-cache analog,
api.hpp:286 storePipelineCache).

One place decides where compiled programs are kept: the directory named by
JAX_COMPILATION_CACHE_DIR when it is set, otherwise `<checkout>/.jax_cache`
(listed in .gitignore). The path is fixed so that later runs find what
earlier ones compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE)


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at compile_cache_dir(); programs that
    compile faster than `min_compile_secs` are not stored. Returns the
    directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
