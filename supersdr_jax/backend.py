"""Where this process runs, decided once, and where it caches compiles.

The receiver has two kinds of code for its hot stages: kernels compiled
for an NVIDIA GPU (Pallas through Triton) and the plain XLA path. `route`
reads `jax.default_backend()` once and names the one this process uses:

  "gpu"  compiled GPU kernels where a stage has one
  "cpu"  the XLA path everywhere (tests, the CPU oracles)

Any other platform is an error. Nothing in the package runs a kernel in
interpret mode or falls back to the CPU when it finds no GPU: interpret
mode is for tests, which ask for it explicitly.
"""

from __future__ import annotations

import functools
import os

import jax

GPU = "gpu"
CPU = "cpu"

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def route() -> str:
    """The platform this process computes on: GPU or CPU."""
    platform = jax.default_backend()
    if platform not in (GPU, CPU):
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: supersdr_jax runs on "
            f"an NVIDIA GPU, or on the CPU for tests")
    return platform


def gpu_kernels() -> bool:
    """True when the compiled GPU kernels serve their stages."""
    return route() == GPU


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    `$JAX_COMPILATION_CACHE_DIR` when it is set, else at the fixed
    `<checkout>/.jax_cache` (the path is part of the cache key, so it
    must not move between runs). Returns the directory used."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path
