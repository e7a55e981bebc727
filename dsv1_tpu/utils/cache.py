"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, bench.py, chip_smoke.py): when
JAX_COMPILATION_CACHE_DIR is set, that directory is the cache and no
other is set in code; otherwise the cache is `build/jax_cache` in the
checkout (listed in .gitignore). The path is part of the cache key, so
it is fixed rather than temporary.
"""

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir() -> str | None:
    """The cache directory by the rule above; None when neither the
    variable is set nor the package sits in a checkout directory (e.g.
    inside a zipapp)."""
    env = os.environ.get(ENV)
    if env:
        return env
    if not CHECKOUT.is_dir():
        return None
    return str(CHECKOUT / "build" / "jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX at cache_dir() and persist every compile. Returns the
    directory in use (None: no persistent cache)."""
    path = cache_dir()
    if path is None:
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
