"""Where the persistent XLA compilation cache lives.

A cold run compiles every program of the coupled step; the persistent
cache lets the next process on the same machine load them instead. The
directory is part of each entry's key, so it must not move between runs:
JAX_COMPILATION_CACHE_DIR when the environment sets it, else the
checkout's own ``.jax_cache`` (listed in .gitignore).
"""

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure():
    """Point JAX's persistent cache at its directory; call before the
    first compile. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
