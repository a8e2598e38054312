"""irfinder_tpu/backend.py: the one module that knows the backend."""

import os

import jax
import pytest

from irfinder_tpu import backend


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert backend.compile_cache_dir() == str(tmp_path / "cc")
    # JAX reads the variable itself; the code must set no other directory
    assert backend.init_compile_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before


def test_default_cache_dir_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(backend.REPO_ROOT, ".jax_cache")
    assert backend.compile_cache_dir() == want
    assert backend.compile_cache_dir() == want  # no pid/time component
    assert os.path.isfile(os.path.join(backend.REPO_ROOT, "irfinder_tpu", "backend.py"))
    with open(os.path.join(backend.REPO_ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
    before = jax.config.jax_compilation_cache_dir
    try:
        assert backend.init_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_describe_fields():
    d = backend.describe()
    dev = jax.devices()[0]
    assert d == {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    # the suite runs on the CPU backend; describe() must say so, not guess
    assert d["platform"] == jax.default_backend() == "cpu"
    assert backend.on_gpu() is False


def test_gpu_name_power_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi on PATH
    assert backend.gpu_name_power() is None


@pytest.mark.parametrize("env,want", [(None, False), ("1", True), ("0", False)])
def test_device_stats_enabled_on_cpu(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("IRTPU_DEVICE_STATS", raising=False)
    else:
        monkeypatch.setenv("IRTPU_DEVICE_STATS", env)
    assert backend.device_stats_enabled() is want
