"""Persistent XLA compilation cache.

Compiling the fused kernel and the large plans takes seconds to minutes;
host processes (CLI, bench, ``chip_smoke.py``) would otherwise pay that on
every launch.  :func:`enable_compile_cache` points JAX at one on-disk
cache shared across processes — the moral equivalent of the reference
shipping pre-synthesized bitstreams instead of re-running Quartus per boot.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
this module sets no other path.  Otherwise the cache lives at a fixed
path inside the checkout, ``.jax_cache/`` (listed in ``.gitignore``): the
path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX at the persistent compilation cache and return its
    directory.  Idempotent: every call leaves the same configuration."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    CHECKOUT_CACHE.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
