"""Placement of JAX's persistent compilation cache (utils/compile_cache.py)."""

import os

import jax

from deepctr_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_respected_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_a_fixed_path_in_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.configure_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_gitignore_lists_the_cache():
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = {line.strip() for line in f}
    assert ".jax_cache/" in lines
