"""Persistent XLA compilation cache.

A process restart should not pay for the same compile twice.  JAX's
persistent cache stores serialized executables keyed on the traced
computation + compile options + backend, so a second process with the same
scene shape skips straight to execution.

Placement: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets no directory; otherwise the cache lives at a fixed
``.jax_cache/`` in the checkout (listed in .gitignore), so its path — part
of the cache key's reach — never moves between runs.

The reference has no analogue (Rust ahead-of-time compiles its shaders at
build time via vulkano_shaders, shaders/src/lib.rs:8-46) — this is the
JIT-world equivalent of that build cache.
"""

from __future__ import annotations

import os

from .paths import REPO_ROOT

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """Where the compile cache lives: $JAX_COMPILATION_CACHE_DIR if set,
    else .jax_cache/ in the checkout."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Idempotently turn on JAX's persistent compilation cache and return
    its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR) and jax.config.jax_compilation_cache_dir != path:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything that took real compile effort; entry size is
    # irrelevant on local disk.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
