"""JAX's persistent compilation cache, kept at one fixed place.

Entry points call `setup_compile_cache()` before their first compile. When
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it and no cache directory is
set here. Otherwise the cache lives in `.jax_cache/` at the repository
root: a fixed path, so a second run of the same checkout finds what the
first one compiled.

Either way, source paths are cut to their base names in the locations JAX
writes into programs. A Pallas-Triton kernel carries its Triton IR,
locations included, inside the program, and the cache key hashes it: with
full paths, the same program built from two checkouts in two directories
would get two keys and never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
# re.sub pattern JAX removes from every source path: all directories
SOURCE_DIRS = r".*/"


def setup_compile_cache() -> str:
    """Returns the cache directory in use."""
    import jax

    if jax.config.jax_hlo_source_file_canonicalization_regex is None:
        jax.config.update("jax_hlo_source_file_canonicalization_regex", SOURCE_DIRS)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
