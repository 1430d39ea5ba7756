"""Persistent compile cache location (utils/compile_cache.py) and the
native library's artifact name (native/__init__.py)."""

from pathlib import Path

import jax
import pytest

from jutul.jl_tpu import native
from jutul.jl_tpu.utils import compile_cache as cc


def test_cache_dir_is_env_value_when_set():
    env = {cc.ENV: "/somewhere/cache"}
    assert cc.compile_cache_dir(env) == "/somewhere/cache"


def test_cache_dir_is_fixed_path_in_checkout():
    a = cc.compile_cache_dir({})
    b = cc.compile_cache_dir({})
    assert a == b == str(cc.CHECKOUT / ".jax_cache")
    assert (Path(cc.CHECKOUT) / "chip_smoke.py").exists()


def test_enable_with_env_sets_no_other_dir(monkeypatch):
    monkeypatch.setenv(cc.ENV, "/from/env")
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == "/from/env"
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_without_env_sets_fixed_dir(monkeypatch):
    monkeypatch.delenv(cc.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cc.enable_compile_cache()
        assert path == str(cc.CHECKOUT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("change", ["source", "flags", "host"])
def test_native_artifact_name_carries_source_flags_and_host(change):
    base = dict(src=b"int f();", flags=("-O3", "-shared", "-fPIC"),
                host="x86_64-hostA")
    other = dict(base)
    other[{"source": "src"}.get(change, change)] = {
        "source": b"int g();", "flags": ("-O3", "-march=native"),
        "host": "x86_64-hostB"}[change]
    assert native.artifact_name(**base) == native.artifact_name(**base)
    assert native.artifact_name(**base) != native.artifact_name(**other)


def test_native_build_is_generic_code():
    assert not any("march" in f for f in native._FLAGS)
