"""Test configuration: the JAX CPU backend with 8 virtual devices, so
multi-device sharding tests (shard_map over a Mesh) run anywhere. Must
run before any test module imports jax.

Tests marked `gpu` need the card. They run only when the suite is started
with SUPERSDR_GPU_TESTS=1 on a machine with an NVIDIA GPU (README,
Running): the CPU is then left unforced, and the `gpu` fixture skips them
anywhere JAX finds no GPU.
"""

import os

if os.environ.get("SUPERSDR_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips unless JAX computes on an NVIDIA GPU in this process."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with SUPERSDR_GPU_TESTS=1 "
                    "on the card)")
    return jax.devices()[0]


@pytest.fixture
def kernel_tail(monkeypatch):
    """Route eligible chain tails through the GPU tail kernel, run by the
    Pallas interpreter on the CPU (compiling it needs the card)."""
    from supersdr_jax import backend
    from supersdr_jax.ops.pallas import chain_tail

    compiled = chain_tail.chain_tail

    def interpreted(*args, **kwargs):
        return compiled(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(backend, "gpu_kernels", lambda: True)
    monkeypatch.setattr(chain_tail, "chain_tail", interpreted)
    jax.clear_caches()
    yield
    jax.clear_caches()
