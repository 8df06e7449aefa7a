"""supersdr_jax.backend: the one place that decides where this process
computes, and where the persistent compile cache lives."""

import os

import jax
import pytest

from supersdr_jax import backend


@pytest.fixture
def fresh_route():
    backend.route.cache_clear()
    yield
    backend.route.cache_clear()


@pytest.mark.parametrize("platform,route,kernels", [
    ("gpu", "gpu", True),
    ("cpu", "cpu", False),
])
def test_route_picks_kernels_on_gpu_xla_on_cpu(monkeypatch, fresh_route,
                                               platform, route, kernels):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert backend.route() == route
    assert backend.gpu_kernels() is kernels


@pytest.mark.parametrize("platform", ["METAL", "sycl", "remote"])
def test_route_refuses_other_platforms(monkeypatch, fresh_route, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.route()


def test_route_reads_the_platform_once(monkeypatch, fresh_route):
    calls = []

    def fake():
        calls.append(1)
        return "cpu"

    monkeypatch.setattr(jax, "default_backend", fake)
    for _ in range(3):
        backend.route()
    assert len(calls) == 1


def test_this_test_process_routes_to_cpu():
    assert backend.route() == "cpu"
    assert not backend.gpu_kernels()


def test_package_never_asks_for_interpret_mode():
    """interpret=True is for tests only: no module of the package passes
    it, so a GPU process can never fall into the Pallas interpreter."""
    root = os.path.join(backend.CHECKOUT, "supersdr_jax")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "interpret=True" not in src, name
                assert "interpret=not" not in src, name


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env_var(monkeypatch, tmp_path,
                                       restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(backend.CHECKOUT, ".jax_cache")
    assert backend.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isfile(os.path.join(backend.CHECKOUT, "pyproject.toml"))
