"""Persistent XLA compilation cache location.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; where it is set, that is the
cache and nothing here overrides it. Where it is not set, the cache lives at
a fixed ``.jax_cache/`` in the checkout (listed in ``.gitignore``): the
path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent cache uses: the env var's value when
    set, else the checkout's fixed ``.jax_cache/``."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and return that path. Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
