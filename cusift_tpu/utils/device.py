"""Device checks and the persistent compilation cache for entry points.

Measurement entry points (bench.py, chip_smoke.py) call `require_gpu`, so
a run without a card fails instead of reporting CPU numbers.  Every entry
point calls `enable_compile_cache` before its first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# a fixed path inside the checkout (never /tmp, a pid or a time), so each
# run of this checkout finds what the previous one compiled
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here.  Otherwise the cache lives at
    DEFAULT_CACHE_DIR.  Entries are kept from 0.5 s of compile time up,
    whatever their size.
    """
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(DEFAULT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


def device_info() -> dict:
    """Platform, device kind and device count as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(prog: str) -> dict:
    """`device_info()`, or exit non-zero when JAX's first device is no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"{prog}: needs a GPU, but JAX's first device is "
                         f"{info['platform']} ({info['kind']})")
    return info
