"""Two-way transformer with CLIP-conditioned cross-attention.

Re-design of `/root/reference/models/mmseg/models/sam/transformer_maskdecoder_edge.py`
(TwoWayTransformer :16-109, TwoWayAttentionBlock :112-214, Attention :217-272).

Each block runs six steps per layer:
  1. token self-attention
  2. token -> image cross-attention
  3. token -> cond (CLIP sparse embeddings) cross-attention
  4. token MLP
  5. image -> cond cross-attention   (queries are image keys!)
  6. image -> token cross-attention

Sequence lengths are tiny (6 tokens, 4096 image, 2 cond), so plain XLA
attention is optimal; the point of care is layout: image tokens stay (B, N, C)
throughout so the surrounding convs/matmuls fuse.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from . import layers as L


@dataclasses.dataclass(frozen=True)
class TwoWayTransformerConfig:
    depth: int = 2
    embedding_dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    dtype: jnp.dtype = jnp.float32


def _init_attention(key, dim: int, downsample_rate: int) -> dict:
    k = L.Keys(key)
    internal = dim // downsample_rate
    return {
        "q_proj": L.dense_init(k(), dim, internal),
        "k_proj": L.dense_init(k(), dim, internal),
        "v_proj": L.dense_init(k(), dim, internal),
        "out_proj": L.dense_init(k(), internal, dim),
    }


def projected_attention(p, q, k, v, num_heads: int, dtype):
    """Attention with separate q/k/v projections and optional down-projection.

    Mirrors the reference's decoder `Attention` (`transformer_maskdecoder_edge.py:217-272`):
    internal dim = embedding_dim // downsample_rate; softmax in fp32.
    """
    internal = p["q_proj"]["kernel"].shape[1]
    head_dim = internal // num_heads

    def split(x):
        b, n, _ = x.shape
        return x.reshape(b, n, num_heads, head_dim).transpose(0, 2, 1, 3)

    qh = split(L.dense(p["q_proj"], q, dtype))
    kh = split(L.dense(p["k_proj"], k, dtype))
    vh = split(L.dense(p["v_proj"], v, dtype))
    logits = jnp.einsum(
        "bhqc,bhkc->bhqk", qh, kh, preferred_element_type=jnp.float32
    ) / (head_dim ** 0.5)
    probs = jax.nn.softmax(logits, axis=-1).astype(vh.dtype)
    out = jnp.einsum("bhqk,bhkc->bhqc", probs, vh, preferred_element_type=jnp.float32)
    out = out.astype(q.dtype).transpose(0, 2, 1, 3).reshape(q.shape[0], q.shape[1], internal)
    return L.dense(p["out_proj"], out, dtype)


_BLOCK_ATTN = (
    ("self_attn", False),
    ("cross_attn_token_to_image", True),
    ("cross_attn_token_to_cond", True),
    ("cross_attn_image_to_cond", True),
    ("cross_attn_image_to_token", True),
)


def init(cfg: TwoWayTransformerConfig, key) -> dict:
    k = L.Keys(key)
    C = cfg.embedding_dim
    params = {}
    for i in range(cfg.depth):
        layer = {
            name: _init_attention(k(), C, cfg.attention_downsample_rate if ds else 1)
            for name, ds in _BLOCK_ATTN
        }
        for norm in ("norm1", "norm2", "norm2_cond", "norm3", "norm4_cond", "norm4"):
            layer[norm] = L.ln_init(C)
        layer["mlp"] = {"lin1": L.dense_init(k(), C, cfg.mlp_dim),
                        "lin2": L.dense_init(k(), cfg.mlp_dim, C)}
        params[f"layer_{i}"] = layer
    params["final_attn_token_to_image"] = _init_attention(
        k(), C, cfg.attention_downsample_rate
    )
    params["norm_final_attn"] = L.ln_init(C)
    return params


def _block(cfg, p, queries, keys, query_pe, key_pe, cond_embedding, cond_pe,
           skip_first_layer_pe: bool):
    dt = cfg.dtype
    attn = lambda name, q, k, v: projected_attention(p[name], q, k, v, cfg.num_heads, dt)
    norm = lambda name, x: L.ln(p[name], x, 1e-5)

    # 1. token self-attention
    if skip_first_layer_pe:
        queries = attn("self_attn", queries, queries, queries)
    else:
        q = queries + query_pe
        queries = queries + attn("self_attn", q, q, queries)
    queries = norm("norm1", queries)

    # 2. token -> image
    q = queries + query_pe
    k = keys + key_pe
    queries = queries + attn("cross_attn_token_to_image", q, k, keys)
    queries = norm("norm2", queries)

    # 3. token -> cond
    q = queries + query_pe
    k = cond_embedding + cond_pe
    queries = queries + attn("cross_attn_token_to_cond", q, k, cond_embedding)
    queries = norm("norm2_cond", queries)

    # 4. token MLP
    h = jax.nn.relu(L.dense(p["mlp"]["lin1"], queries, dt))
    queries = queries + L.dense(p["mlp"]["lin2"], h, dt)
    queries = norm("norm3", queries)

    # 5. image -> cond (queries are the image tokens)
    q = cond_embedding + cond_pe
    k = keys + key_pe
    keys = keys + attn("cross_attn_image_to_cond", k, q, cond_embedding)
    keys = norm("norm4_cond", keys)

    # 6. image -> token
    q = queries + query_pe
    k = keys + key_pe
    keys = keys + attn("cross_attn_image_to_token", k, q, queries)
    keys = norm("norm4", keys)

    return queries, keys


def apply(
    cfg: TwoWayTransformerConfig,
    params: dict,
    image_embedding: jnp.ndarray,  # (B, N, C) — already flattened NHWC
    image_pe: jnp.ndarray,         # (B, N, C)
    point_embedding: jnp.ndarray,  # (B, T, C)
    cond_embedding: jnp.ndarray,   # (B, S, C)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    queries, keys = point_embedding, image_embedding
    for i in range(cfg.depth):
        queries, keys = _block(
            cfg, params[f"layer_{i}"], queries, keys,
            query_pe=point_embedding, key_pe=image_pe,
            cond_embedding=cond_embedding, cond_pe=cond_embedding,
            skip_first_layer_pe=(i == 0),
        )
    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + projected_attention(
        params["final_attn_token_to_image"], q, k, keys, cfg.num_heads, cfg.dtype
    )
    queries = L.ln(params["norm_final_attn"], queries, 1e-5)
    return queries, keys
