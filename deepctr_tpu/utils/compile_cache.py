"""Where JAX's persistent compilation cache lives.

The full-vocabulary scan programs take tens of seconds to compile, so every
entry point (CLI, ``bench.py``, ``tools/bench_suite.py``, ``chip_smoke.py``)
shares one on-disk cache.  The directory is part of the cache's key, so it
must not move between runs:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
  is set here;
- otherwise the cache is ``<checkout>/.jax_cache`` (listed in .gitignore).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed place.

    Returns the directory in use.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
