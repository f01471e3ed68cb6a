"""JAX's persistent compilation cache, kept in one place.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it and nothing here sets
another directory. Otherwise the cache goes to `<checkout>/.jax_cache`
(listed in .gitignore), a fixed path, so that every process of the checkout
shares one cache.
"""

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache():
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
