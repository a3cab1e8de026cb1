"""Backend decisions: the one place that reads the JAX platform.

Every choice that depends on the machine (which engine a simulator runs,
whether the DAS kernel is compiled) asks here, so the rest of the package
never tests a platform string. Interpret mode is never derived from the
platform: tests pass it explicitly.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def platform() -> str:
    """The default device's JAX platform ('cpu' or 'gpu')."""
    import jax

    return jax.devices()[0].platform


def on_gpu() -> bool:
    """True when the default device is a GPU: the compiled Triton DAS
    kernel and the frequency-domain simulation engines are chosen there;
    the CPU takes the plain XLA paths."""
    return platform() == "gpu"


def device_record() -> dict:
    """The default device as JAX reports it: platform, kind and count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def device_memory_bytes() -> int:
    """The default device's memory limit in bytes (``memory_stats()``),
    or 16 GiB where the backend reports none (the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 16 * 2**30))


def compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. Where ``JAX_COMPILATION_CACHE_DIR`` is set JAX already uses
    it and nothing is changed; otherwise the cache is the fixed
    ``.jax_cache/`` directory of the checkout."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
