"""Where JAX's persistent compilation cache lives.

Renders of the same scene shape reuse compiled steps across processes
through JAX's own persistent cache.  When JAX_COMPILATION_CACHE_DIR is set,
JAX reads it itself and nothing is set here; otherwise the cache goes to a
fixed directory inside the checkout (listed in .gitignore), since the path
is part of what makes a later process find the entries again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns that path."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
