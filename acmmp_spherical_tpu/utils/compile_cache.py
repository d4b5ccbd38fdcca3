"""Persistent XLA compilation cache for every entry point.

The cache goes where ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that
variable itself, so nothing is set in code then); otherwise to ``.jax_cache``
at the root of the checkout, which ``.gitignore`` lists.  The path is part of
what a cache hit needs, so it is fixed rather than temporary.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parent.parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
