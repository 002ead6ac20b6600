"""JAX's persistent compilation cache, kept in one fixed directory.

The cache key includes the directory, so a path that moves between runs
never hits.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is
used and no other; otherwise the cache lives at ``<repo>/build/jax_cache``.
Every entry point (the CLIs, ``bench.py``, ``chip_smoke.py``, the tests)
calls :func:`enable` once, after importing JAX and before compiling.
"""

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "jax_cache")


def cache_dir():
    """The directory the cache uses: the environment's, else the default."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable():
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Applied through ``jax.config`` so that it holds whichever module
    imported JAX first.  Returns the directory."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
