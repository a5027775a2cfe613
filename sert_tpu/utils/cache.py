"""Persistent XLA compilation cache wiring.

Every CLI invocation of this framework jit-compiles the same handful of
programs (train step, scoring engine, eval helpers), and jit caches die
with the process. JAX's persistent compilation cache survives processes.

Where it lives: ``JAX_COMPILATION_CACHE_DIR``, when set, always wins — JAX
reads it itself and nothing here overrides it. Otherwise the cache goes to
one fixed directory inside the checkout, :data:`DEFAULT_DIR` (listed in
``.gitignore``); the path is part of the cache key, so a directory that
moved would never hit.

The CLI enables the cache by default (``main`` calls
:func:`enable_compilation_cache`); library users call it explicitly. Opt
out with ``SERT_NO_COMPILE_CACHE=1``.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> Optional[str]:
    """The directory in effect: the environment variable, else
    :data:`DEFAULT_DIR`; None when opted out."""
    if os.environ.get("SERT_NO_COMPILE_CACHE"):
        return None
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.
    Returns the directory in effect, or None when disabled or unwritable.
    Safe to call repeatedly and before or after backend initialization.
    JAX's own entry thresholds (min compile time) stay at their defaults,
    so trivial programs are not cached."""
    path = cache_dir()
    if path is None or os.environ.get(ENV_VAR):
        return path      # JAX already took the variable's value
    import jax
    try:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    except OSError:      # read-only checkout
        return None
    return path
