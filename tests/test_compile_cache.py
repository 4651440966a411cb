"""`setup_compile_cache`: JAX_COMPILATION_CACHE_DIR wins untouched; without
it the cache is the fixed `.jax_cache/` at the repository root."""

from __future__ import annotations

from pathlib import Path

import jax
import pytest

from camouflaged_vlm_tpu.utils.compile_cache import setup_compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_set_changes_nothing(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_env_var_unset_uses_fixed_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(ROOT / ".jax_cache")
    assert setup_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # a fixed path: a second call (a second run) lands in the same place
    assert setup_compile_cache() == want
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


@pytest.fixture
def restore_source_regex():
    before = jax.config.jax_hlo_source_file_canonicalization_regex
    yield
    jax.config.update("jax_hlo_source_file_canonicalization_regex", before)


def test_kernel_program_carries_no_checkout_path(restore_source_regex):
    """The Triton IR inside a program with the Pallas kernel (lowered for
    CUDA, which needs no GPU) names its source files without directories
    once the helper ran, so the cache key is the same in any checkout."""
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.ops.global_attention_triton import global_attention_triton

    H = W = 16
    heads, d = 2, 80
    f = jax.jit(lambda a, b: global_attention_triton(a, b, 0.1, heads, d, H, W))
    args = (jax.ShapeDtypeStruct((1, H * W, 3 * heads * d), jnp.bfloat16),
            jax.ShapeDtypeStruct((H * W, 1, heads, H + W), jnp.bfloat16))

    def text():
        return f.trace(*args).lower(lowering_platforms=("cuda",)).as_text()

    jax.config.update("jax_hlo_source_file_canonicalization_regex", None)
    assert str(ROOT) in text()  # the fault the helper removes
    setup_compile_cache()
    t = text()
    assert str(ROOT) not in t
    assert "global_attention_triton.py" in t
