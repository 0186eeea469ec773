"""Process set-up shared by the benchmark drivers: the persistent compile
cache and the GPU requirement.

The compile cache lives where JAX_COMPILATION_CACHE_DIR says (JAX reads
that variable itself); otherwise at <checkout>/.jax_cache, a fixed path
resolved from this file, because the path is part of the cache key and a
directory that moves never hits.
"""

from __future__ import annotations

import os

ENV_CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV_CACHE_DIR) or os.path.join(CHECKOUT,
                                                        ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir()."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


class NoGPUError(RuntimeError):
    """The measurement paths run on a GPU only; there is no CPU mode."""


def require_gpu():
    """Return jax.devices() if the default backend is a GPU, else raise
    NoGPUError.  Benchmarks never report numbers from another platform."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGPUError(f"a GPU is required; JAX found {devs[0].platform} "
                         f"({devs[0].device_kind})")
    return devs
