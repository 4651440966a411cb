"""Model/pipeline factory helpers shared by the CLI, bench and chip_smoke."""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .models import CascadeConfig, OVCOSCascade
from .models.clip import build_class_prompt_bank
from .utils.registry import MODELS


@MODELS.register("sam_maskdecoder_edge")
def build_full_cascade(dtype=jnp.bfloat16, **_ignored) -> Tuple[OVCOSCascade, CascadeConfig]:
    cfg = CascadeConfig.full(dtype=dtype)
    return OVCOSCascade(cfg), cfg


@MODELS.register("tiny_cascade")
def build_tiny_cascade(dtype=jnp.float32, **_ignored) -> Tuple[OVCOSCascade, CascadeConfig]:
    cfg = CascadeConfig.tiny(dtype=dtype)
    return OVCOSCascade(cfg), cfg


def make_bank_inputs(
    cfg: CascadeConfig,
    classnames: Sequence[str],
    token_embedding: Optional[np.ndarray] = None,
    bank_features: Optional[np.ndarray] = None,
    seed: int = 0,
) -> Dict[str, jnp.ndarray]:
    """Class-split constants for the cascade (prompt bank + text-feature bank).

    Without a checkpoint, the token embedding table and frozen text-feature
    bank are seeded randomly (shape-faithful) — used by tests and synthetic
    benchmarks.
    """
    rng = np.random.default_rng(seed)
    width = cfg.clip.transformer_width
    if token_embedding is None:
        token_embedding = (
            rng.standard_normal((cfg.clip.vocab_size, width)).astype(np.float32) * 0.02
        )
    bank = build_class_prompt_bank(
        classnames, token_embedding, n_ctx=cfg.clip.n_ctx,
        context_length=cfg.clip.context_length,
    )
    if bank_features is None:
        bank_features = rng.standard_normal(
            (len(classnames), cfg.clip.embed_dim)
        ).astype(np.float32)
        bank_features /= np.linalg.norm(bank_features, axis=-1, keepdims=True)
    return {
        "prefix": jnp.asarray(bank.prefix),
        "suffix": jnp.asarray(bank.suffix),
        "eot_indices": jnp.asarray(bank.eot_indices),
        "bank_features": jnp.asarray(bank_features),
    }


def make_example_inputs(cfg: CascadeConfig, batch: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (
        jnp.asarray(
            rng.standard_normal((batch, cfg.inp_size, cfg.inp_size, 3)), jnp.float32
        ),
        jnp.asarray(
            rng.standard_normal((batch, cfg.clip_size, cfg.clip_size, 3)), jnp.float32
        ),
        jnp.full((batch, cfg.clip_size, cfg.clip_size, 1), (1.0 - 0.5) / 0.26, jnp.float32),
    )


def init_cascade_params(model: OVCOSCascade, seed: int = 0) -> dict:
    """Random cascade variables {"params": ...} from `seed`, initialised on
    the default device op by op. Each op compiles once per distinct shape;
    one jitted program of the whole init would instead compile every
    leaf's RNG on its own, which takes minutes at ViT-H width on the GPU."""
    return model.init(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=8)
def _rel_table_builder(enc_cfg):
    """One jitted table builder per encoder config (frozen dataclass key).
    A fresh `jax.jit(lambda ...)` per call would retrace and recompile on
    every attach — e.g. at every in-training validation epoch."""
    from .models.sam_encoder import precompute_rel_tables

    return jax.jit(lambda p: precompute_rel_tables(enc_cfg, p))


def attach_rel_cache(params: dict, cfg: CascadeConfig) -> dict:
    """Add the precomputed 'relcache' entry (param-derived rel-pos tables,
    see `models.sam_encoder.precompute_rel_tables`) to a cascade variables
    dict for INFERENCE, so the forward does not rebuild them per batch.
    Training must NOT use this (the tables would go stale as rel_pos params
    update)."""
    enc = params["params"]["image_encoder"]
    cache = _rel_table_builder(cfg.encoder)(enc)
    return {**params, "relcache": {"image_encoder": cache}}
