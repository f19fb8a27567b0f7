"""Where JAX keeps compiled programs between processes.

JAX reads JAX_COMPILATION_CACHE_DIR itself; where it is set, that
directory is the cache and nothing else is configured. Otherwise the cache
goes to a fixed path inside the checkout (listed in .gitignore): the path
is part of what a later process must find again, so it never depends on a
temporary directory, a pid or the time.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_COMPILE_CACHE = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "").strip()
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE
