"""Kernel choice (zklaim_tpu/kernels.py) and compile-cache placement
(utils/jaxconfig.py)."""

import inspect
import os

import jax
import pytest

from zklaim_tpu import kernels
from zklaim_tpu.utils import jaxconfig


def test_platform_default_on_cpu():
    assert kernels.curve_impl() == "xla"


def test_platform_default_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert kernels.curve_impl() == "kernel"


@pytest.mark.parametrize("word", ["os.environ", "getenv"])
def test_no_environment_switch(word):
    """The choice depends on the platform and the caller, never on an
    environment variable."""
    assert word not in inspect.getsource(kernels)


@pytest.mark.parametrize("impl", kernels.IMPLS)
def test_explicit_request_wins(monkeypatch, impl):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert kernels.curve_impl(impl) == impl


def test_interpret_only_when_asked(monkeypatch):
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        assert kernels.curve_impl() != "host"


def test_unknown_impl_rejected():
    with pytest.raises(ValueError):
        kernels.curve_impl("interpret")


@pytest.fixture
def gpu_backend_config(monkeypatch):
    """setup_cache() as it runs on a GPU, with the cache settings
    restored afterwards."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_enable_compilation_cache",
        "jax_persistent_cache_min_compile_time_secs")}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_in_checkout_when_unset(monkeypatch, gpu_backend_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxconfig.setup_cache()
    want = os.path.join(os.path.dirname(os.path.dirname(__file__)), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == want == jaxconfig.CACHE_DIR


def test_cache_env_var_wins(monkeypatch, tmp_path, gpu_backend_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jaxconfig.setup_cache()
    # setup_cache sets nothing: JAX's own reading of the variable stands
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_disabled_on_cpu(monkeypatch):
    saved = jax.config.jax_enable_compilation_cache
    try:
        jaxconfig.setup_cache()
        assert jax.config.jax_enable_compilation_cache is False
    finally:
        jax.config.update("jax_enable_compilation_cache", saved)
