"""Persistent-compilation-cache location.

One rule for every entry point (``api``, ``bench.py``, ``chip_smoke.py``):

- where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it, and this
  module sets no other directory;
- otherwise the cache lives in one fixed directory inside the checkout,
  ``<repo>/.jax_cache`` (listed in ``.gitignore``).  The path is part of the
  cache's key, so it carries no fingerprint, pid, time or temporary name;
- on the CPU the cache is disabled (see :func:`configure_cache`).
"""

from __future__ import annotations

import os

#: fixed in-checkout default, used only when JAX_COMPILATION_CACHE_DIR is unset.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_cache(jax, backend: str | None = None) -> str:
    """Point jax's persistent compilation cache at its directory and return
    it — except on the CPU, where the cache is DISABLED and "" is returned.

    jaxlib 0.9.0's XLA:CPU executable (de)serialization segfaults
    probabilistically on some of this package's programs in BOTH
    directions: ``executable.serialize()`` on write
    (compilation_cache.put_executable_and_time) AND deserialize on read of
    entries that were themselves written cleanly
    (compilation_cache.get_executable_and_time).  There is no safe mode, so
    CPU runs simply recompile.

    ``backend=None`` resolves the default backend, which initializes the
    platform — pass the backend name explicitly to avoid that.
    """
    if backend is None:
        backend = jax.default_backend()
    if backend == "cpu":
        jax.config.update("jax_compilation_cache_dir", None)
        return ""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
