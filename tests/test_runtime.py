"""Start-up plumbing: compile cache location, per-device index budget,
native library keys and chip_smoke.py's device check."""

import os
import sys

import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """With $JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands
    and no other directory is configured."""
    from tophat_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_dir(monkeypatch):
    """Unset: one fixed directory inside the checkout, listed in
    .gitignore, the same on every call."""
    from tophat_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == os.path.join(
            ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            ROOT, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


class _Device:
    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


def test_index_budget_from_device_memory(monkeypatch):
    from tophat_tpu.parallel.auto import INDEX_MEMORY_SHARE, index_budget

    monkeypatch.delenv("TOPHAT_TPU_HBM_BYTES", raising=False)
    limit = 60 << 30
    assert index_budget(_Device({"bytes_limit": limit})) == int(
        limit * INDEX_MEMORY_SHARE)
    assert index_budget(_Device(None)) is None          # the CPU
    assert index_budget(_Device({"bytes_in_use": 1})) is None
    monkeypatch.setenv("TOPHAT_TPU_HBM_BYTES", str(1 << 20))
    assert index_budget(_Device({"bytes_limit": limit})) == 1 << 20
    assert index_budget(_Device(None)) == 1 << 20
    assert index_budget(jax.devices()[0]) == 1 << 20


def test_native_library_keyed_on_source_and_flags():
    from tophat_tpu import native

    a = native.lib_path("bgzf", ["-lz", "-pthread"])
    assert a == native.lib_path("bgzf", ["-lz", "-pthread"])
    assert a != native.lib_path("bgzf", ["-lz"])
    assert a != native.lib_path("bamenc", ["-lz", "-pthread"])
    if native.bgzf.available:
        assert os.path.exists(a)


def test_chip_smoke_refuses_a_cpu_process():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs 1 GPU"):
        chip_smoke.require_gpu()
