"""CustomCLIP: prompt learner + text tower + Alpha-CLIP vision tower.

Re-design of `CustomCLIP` (`/root/reference/cocotrainers/mapleAlphaCLIP.py:229-294`).
Classification head: normalised image features against
(normalised learned text features + frozen precomputed prompt-bank features),
scaled by exp(logit_scale). The returned per-prediction text feature is taken
*after* the bank addition without renormalisation, matching the reference
(`mapleAlphaCLIP.py:277-280,291-294`).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from . import model as clip_model
from . import prompt_learner
from .model import AlphaClipConfig
from .prompt_learner import PromptLearnerConfig


def _learner_cfg(cfg: AlphaClipConfig) -> PromptLearnerConfig:
    return PromptLearnerConfig(
        n_ctx=cfg.n_ctx,
        prompt_depth=cfg.prompt_depth,
        text_width=cfg.transformer_width,
        vision_width=cfg.vision_width,
        dtype=cfg.dtype,
    )


def init(cfg: AlphaClipConfig, key) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "prompt_learner": prompt_learner.init(_learner_cfg(cfg), k1),
        "text_encoder": clip_model.init_text(cfg, k2),
        "image_encoder": clip_model.init_vision(cfg, k3),
        "logit_scale": jnp.asarray(jnp.log(1.0 / 0.07), jnp.float32),
    }


def encode_class_text_features(
    cfg: AlphaClipConfig,
    params: dict,
    prefix: jnp.ndarray,          # (N, 1, W) class-split prompt prefix
    suffix: jnp.ndarray,          # (N, L-1-n_ctx, W)
    eot_indices: jnp.ndarray,     # (N,)
    bank_features: jnp.ndarray,   # (N, embed_dim) frozen text-feature bank
) -> jnp.ndarray:
    """Per-class text features: normalised learned features + frozen bank.

    Image-independent — at inference this runs ONCE per class split, not
    once per batch (the reference recomputes the whole text tower every
    image, `mapleAlphaCLIP.py:286`).
    """
    prompts, _, deep_text, _ = prompt_learner.apply(
        _learner_cfg(cfg), params["prompt_learner"], prefix, suffix
    )
    tf = clip_model.text(cfg, params["text_encoder"], prompts, eot_indices, deep_text)
    tf = tf / jnp.linalg.norm(tf, axis=-1, keepdims=True)
    return tf + bank_features.astype(jnp.float32)


def visual_prompts(cfg: AlphaClipConfig, params: dict):
    """Visual-side MaPLe prompts (class-split independent):
    (shared_ctx, deep_visual)."""
    dummy = jnp.zeros((1, 1, cfg.transformer_width), jnp.float32)
    _, shared_ctx, _, deep_visual = prompt_learner.apply(
        _learner_cfg(cfg), params["prompt_learner"], dummy, dummy
    )
    return shared_ctx, deep_visual


def classify(
    cfg: AlphaClipConfig,
    params: dict,
    image: jnp.ndarray,           # (B, H, W, 3)
    alpha: jnp.ndarray,           # (B, H, W, 1)
    text_features: jnp.ndarray,   # (N, embed_dim) from encode_class_text_features
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(image features (B,1,D), picked text features (B,1,D), pred (B,),
    logits (B,N))."""
    shared_ctx, deep_visual = visual_prompts(cfg, params)
    image_features = clip_model.vision(
        cfg, params["image_encoder"], image, alpha, shared_ctx, deep_visual
    )
    image_features = image_features / jnp.linalg.norm(
        image_features, axis=-1, keepdims=True
    )
    logits = jnp.exp(params["logit_scale"]) * image_features @ text_features.T
    pred = jnp.argmax(logits, axis=-1)
    picked_text = text_features[pred][:, None, :]  # (B, 1, D)
    return image_features[:, None, :], picked_text, pred, logits


def apply(
    cfg: AlphaClipConfig,
    params: dict,
    image: jnp.ndarray,           # (B, H, W, 3)
    alpha: jnp.ndarray,           # (B, H, W, 1)
    prefix: jnp.ndarray,          # (N, 1, W) class-split prompt prefix
    suffix: jnp.ndarray,          # (N, L-1-n_ctx, W)
    eot_indices: jnp.ndarray,     # (N,)
    bank_features: jnp.ndarray,   # (N, embed_dim) frozen text-feature bank
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    text_features = encode_class_text_features(
        cfg, params, prefix, suffix, eot_indices, bank_features
    )
    return classify(cfg, params, image, alpha, text_features)
