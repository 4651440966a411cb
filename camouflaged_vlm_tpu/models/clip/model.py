"""Alpha-CLIP vision/text transformers with MaPLe deep prompting.

Re-design of the upstream `alpha_clip_rw/model.py` as plain functions over
parameter dicts:

  * `VisionTransformer_MaPLe` (:507-563): RGB patch conv + 1-channel alpha
    patch conv summed, class token, learned positional embedding, 4 shallow
    VPT tokens appended at the END of the sequence, deep prompt replacement
    of those trailing tokens in layers 1..8 (prompt depth 9), fp32 layer
    norms, QuickGELU MLPs, final cls-token projection to the shared space.
  * text `Transformer` (:364-434): causal mask, deep prompt replacement of
    tokens [1 : 1+n_ctx] in layers 1..8, EOT-token pooling via argmax of the
    token ids, projection to the shared space.

Choices: batch-first (B, L, D) layouts (the reference permutes to LND for
torch's MHA; XLA prefers leading batch), one fused qkv projection, fp32
softmax, static prompt splicing (pure slice+concat — no dynamic shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from .. import layers as L
from ...ops.attention import qkv_packed_plain
from ...ops.linear import ln_linear_act_bt, ln_mlp_residual_bt, proj_rows


@dataclasses.dataclass(frozen=True)
class AlphaClipConfig:
    # vision tower (ViT-L/14@336)
    image_resolution: int = 336
    vision_patch_size: int = 14
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    embed_dim: int = 768  # shared image/text space
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 768
    transformer_heads: int = 12
    transformer_layers: int = 12
    # MaPLe
    n_ctx: int = 4          # learned prompt tokens
    prompt_depth: int = 9   # layers 0..8 carry prompts (8 deep replacements)
    # numerics
    dtype: jnp.dtype = jnp.float32
    # fused block order (LN1 + qkv, packed attention, projection + residual,
    # LN2 + MLP + residual). False = the unfused per-layer formulation.
    fused: bool = True

    @property
    def grid(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @classmethod
    def vit_l_14_336(cls, **overrides) -> "AlphaClipConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "AlphaClipConfig":
        # Real vocab/context so the production tokenizer + prompt bank
        # machinery runs unchanged; the towers themselves stay tiny.
        defaults = dict(
            image_resolution=28, vision_patch_size=14, vision_width=32,
            vision_layers=3, vision_heads=4, embed_dim=16,
            context_length=77, vocab_size=49408, transformer_width=24,
            transformer_heads=4, transformer_layers=3,
            n_ctx=2, prompt_depth=2,
        )
        defaults.update(overrides)
        return cls(**defaults)


def build_causal_mask(length: int) -> jnp.ndarray:
    """Additive causal mask (length, length): 0 on/below diag, -inf above."""
    mask = jnp.full((length, length), -jnp.inf, dtype=jnp.float32)
    return jnp.triu(mask, k=1)


def init_resblock(key, dim: int) -> dict:
    k = L.Keys(key)
    return {
        "ln_1": L.ln_init(dim),
        "attn": {"in_proj": L.dense_init(k(), dim, 3 * dim),
                 "out_proj": L.dense_init(k(), dim, dim)},
        "ln_2": L.ln_init(dim),
        "mlp": {"c_fc": L.dense_init(k(), dim, 4 * dim),
                "c_proj": L.dense_init(k(), 4 * dim, dim)},
    }


def _attention(p, x, num_heads, dtype, attn_mask):
    """Fused-qkv multi-head attention (reference `Attention`, model.py:176-256)."""
    B, L_, dim = x.shape
    head_dim = dim // num_heads
    scale = head_dim ** -0.5
    qkv = L.dense(p["in_proj"], x, dtype)
    qkv = qkv.reshape(B, L_, 3, num_heads, head_dim).transpose(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = jnp.einsum(
        "bhqc,bhkc->bhqk", q * scale, k, preferred_element_type=jnp.float32,
    )
    if attn_mask is not None:
        logits = logits + attn_mask
    probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhqk,bhkc->bhqc", probs, v, preferred_element_type=jnp.float32)
    out = out.astype(x.dtype).transpose(0, 2, 1, 3).reshape(B, L_, dim)
    return L.dense(p["out_proj"], out, dtype)


def resblock(p, x, num_heads: int, dtype, fused: bool,
             attn_mask: Optional[jnp.ndarray] = None):
    """Pre-norm residual attention block shared by both towers.

    Fused order (`fused`, no mask): ln_1 rides ahead of the qkv projection,
    the packed attention feeds the projection with the residual added in
    its epilogue, and LN2 + MLP + residual run as one step."""
    B, L_, dim = x.shape
    if fused and attn_mask is None and num_heads % 8 == 0:
        head_dim = dim // num_heads
        a = p["attn"]
        qkv3d = ln_linear_act_bt(
            x, p["ln_1"]["scale"][None], p["ln_1"]["bias"][None],
            a["in_proj"]["kernel"].astype(dtype),
            a["in_proj"]["bias"].astype(dtype)[None],
            eps=1e-5, activation=None,
        )
        out = qkv_packed_plain(qkv3d, head_dim ** -0.5, num_heads, head_dim)
        x = proj_rows(
            out.reshape(B, 1, dim, L_),
            a["out_proj"]["kernel"].astype(dtype),
            a["out_proj"]["bias"].astype(dtype)[None],
            x.reshape(B, 1, L_, dim),
        ).reshape(B, L_, dim)
    else:
        x = x + _attention(p["attn"], L.ln(p["ln_1"], x, 1e-5), num_heads,
                           dtype, attn_mask)
    m = p["mlp"]
    if fused:
        return ln_mlp_residual_bt(
            x, p["ln_2"]["scale"][None], p["ln_2"]["bias"][None],
            m["c_fc"]["kernel"].astype(dtype), m["c_fc"]["bias"].astype(dtype)[None],
            m["c_proj"]["kernel"].astype(dtype), m["c_proj"]["bias"].astype(dtype)[None],
            eps=1e-5, activation="quick_gelu",
        )
    h = L.dense(m["c_fc"], L.ln(p["ln_2"], x, 1e-5), dtype)
    h = h * jax.nn.sigmoid(1.702 * h)  # QuickGELU (model.py:171-173)
    return x + L.dense(m["c_proj"], h, dtype)


def _splice_visual_prompt(x: jnp.ndarray, prompt: jnp.ndarray, n_ctx: int) -> jnp.ndarray:
    """Replace the trailing n_ctx tokens with this layer's prompt (model.py:319-338)."""
    B = x.shape[0]
    ctx = jnp.broadcast_to(prompt[None].astype(x.dtype), (B, n_ctx, x.shape[-1]))
    return jnp.concatenate([x[:, : x.shape[1] - n_ctx, :], ctx], axis=1)


def _splice_text_prompt(x: jnp.ndarray, prompt: jnp.ndarray, n_ctx: int) -> jnp.ndarray:
    """Replace tokens [1 : 1+n_ctx] (after SOT) with this layer's prompt (model.py:341-355)."""
    B = x.shape[0]
    ctx = jnp.broadcast_to(prompt[None].astype(x.dtype), (B, n_ctx, x.shape[-1]))
    return jnp.concatenate([x[:, :1, :], ctx, x[:, 1 + n_ctx :, :]], axis=1)


def init_vision(cfg: AlphaClipConfig, key) -> dict:
    k = L.Keys(key)
    width, p = cfg.vision_width, cfg.vision_patch_size
    std = width ** -0.5
    params = {
        "conv1": L.conv_init(k(), p, p, 3, width, bias=False),
        "conv1_alpha": L.conv_init(k(), p, p, 1, width, bias=False),
        "class_embedding": L.normal(k(), (width,), std),
        "positional_embedding": L.normal(k(), (cfg.grid ** 2 + 1, width), std),
        "ln_pre": L.ln_init(width),
        "ln_post": L.ln_init(width),
        "proj": L.normal(k(), (width, cfg.embed_dim), std),
    }
    for i in range(cfg.vision_layers):
        params[f"resblock_{i}"] = init_resblock(k(), width)
    return params


def vision(
    cfg: AlphaClipConfig,
    params: dict,
    image: jnp.ndarray,            # (B, H, W, 3) normalised
    alpha: jnp.ndarray,            # (B, H, W, 1)
    shared_ctx: jnp.ndarray,       # (n_ctx, vision_width) projected prompt
    deep_prompts: Sequence[jnp.ndarray],  # prompt_depth-1 of (n_ctx, vision_width)
) -> jnp.ndarray:
    """MaPLe Alpha-CLIP vision transformer -> (B, embed_dim) image features."""
    width, p, dt = cfg.vision_width, cfg.vision_patch_size, cfg.dtype
    x = L.conv(params["conv1"], image, p, "VALID", dt)
    x = x + L.conv(params["conv1_alpha"], alpha, p, "VALID", dt)
    B = x.shape[0]
    x = x.reshape(B, -1, width)  # (B, grid^2, width)
    cls = jnp.broadcast_to(
        params["class_embedding"][None, None].astype(x.dtype), (B, 1, width)
    )
    x = jnp.concatenate([cls, x], axis=1)
    x = x + params["positional_embedding"][None].astype(x.dtype)

    # Shallow VPT: append the n_ctx learned tokens at the end.
    vctx = jnp.broadcast_to(
        shared_ctx[None].astype(x.dtype), (B, cfg.n_ctx, width)
    )
    x = jnp.concatenate([x, vctx], axis=1)
    x = L.ln(params["ln_pre"], x, 1e-5)

    for i in range(cfg.vision_layers):
        if i > 0 and (i - 1) < len(deep_prompts):
            x = _splice_visual_prompt(x, deep_prompts[i - 1], cfg.n_ctx)
        x = resblock(params[f"resblock_{i}"], x, cfg.vision_heads, dt, cfg.fused)

    x = L.ln(params["ln_post"], x[:, 0, :], 1e-5)
    return (x.astype(jnp.float32) @ params["proj"]).astype(jnp.float32)


def init_text(cfg: AlphaClipConfig, key) -> dict:
    k = L.Keys(key)
    width = cfg.transformer_width
    params = {
        "positional_embedding": L.normal(k(), (cfg.context_length, width), 0.01),
        "ln_final": L.ln_init(width),
        "text_projection": L.normal(k(), (width, cfg.embed_dim), width ** -0.5),
    }
    for i in range(cfg.transformer_layers):
        params[f"resblock_{i}"] = init_resblock(k(), width)
    return params


def text(
    cfg: AlphaClipConfig,
    params: dict,
    prompt_embeddings: jnp.ndarray,   # (N, L, width) token embeddings
    eot_indices: jnp.ndarray,         # (N,) int — argmax of token ids
    deep_prompts: Sequence[jnp.ndarray],  # prompt_depth-1 of (n_ctx, width)
) -> jnp.ndarray:
    """MaPLe CLIP text transformer -> (N, embed_dim) text features.

    Takes pre-embedded prompts (the prompt learner splices learned ctx into
    the embedding stream before this function —
    `cocotrainers/mapleAlphaCLIP.py:64-78`)."""
    dt = cfg.dtype
    x = prompt_embeddings.astype(dt) + params["positional_embedding"][None].astype(dt)
    mask = build_causal_mask(cfg.context_length)
    for i in range(cfg.transformer_layers):
        if i > 0 and (i - 1) < len(deep_prompts):
            x = _splice_text_prompt(x, deep_prompts[i - 1], cfg.n_ctx)
        x = resblock(params[f"resblock_{i}"], x, cfg.transformer_heads, dt,
                     cfg.fused, mask)
    x = L.ln(params["ln_final"], x, 1e-5)
    x = jnp.take_along_axis(x, eot_indices[:, None, None], axis=1)[:, 0, :]
    return (x.astype(jnp.float32) @ params["text_projection"]).astype(jnp.float32)
